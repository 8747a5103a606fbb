"""Fused dual-averaging update: CUDA kernel, plain version, wrapper."""
