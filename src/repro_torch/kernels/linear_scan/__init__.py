"""Chunked linear scan (Mamba2's SSD): CUDA kernel, plain version,
wrappers and the autograd Function."""
