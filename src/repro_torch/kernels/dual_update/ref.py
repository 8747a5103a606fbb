"""Plain PyTorch version of the fused dual-averaging update: the twin
of ``repro/kernels/dual_update/ref.py`` and the oracle the CUDA kernel
is held against. Each step is its own elementwise op, so nothing can
contract into an FMA, on the CPU or on the card."""
from __future__ import annotations


def dual_update_fused_ref(z, g_sum, denom, alpha):
    """g = g_sum / denom; z_new = z + g; w = -alpha * z_new (all f32).
    ``denom`` and ``alpha`` are 0-dim f32 tensors on z's device.
    Returns (z_new, w) as new tensors."""
    z_new = z + g_sum / denom
    return z_new, -alpha * z_new
