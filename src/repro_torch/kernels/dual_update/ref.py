"""Plain PyTorch versions of the dual-averaging updates: the twins of
``repro/kernels/dual_update/ref.py`` and the oracles the CUDA kernels
are held against. Each step is its own elementwise op, so nothing can
contract into an FMA, on the CPU or on the card."""
from __future__ import annotations

import torch


def dual_update_fused_ref(z, g_sum, denom, alpha):
    """g = g_sum / denom; z_new = z + g; w = -alpha * z_new (all f32).
    ``denom`` and ``alpha`` are 0-dim f32 tensors on z's device.
    Returns (z_new, w) as new tensors."""
    z_new = z + g_sum / denom
    return z_new, -alpha * z_new


def dual_update_ref(z, g, alpha):
    """z_new = z + g; w = -alpha * z_new (f32), in z's dtype. ``alpha``
    is a 0-dim f32 tensor on z's device. Returns (z_new, w) as new
    tensors."""
    z_new = z.to(torch.float32) + g.to(torch.float32)
    return z_new.to(z.dtype), (-alpha * z_new).to(z.dtype)
