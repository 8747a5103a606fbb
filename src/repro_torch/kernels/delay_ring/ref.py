"""Plain PyTorch version of the int8 delay-ring slot rotate: the twin
of ``repro/kernels/delay_ring/ref.py::ring_slot_rotate_int8_ref`` and the
oracle the CUDA kernel is held against.

Arithmetic is formula-identical to the JAX reference: quantize
``clip(round(fed / s), -127, 127)`` (torch.round rounds half to even,
as jnp.round does), dequantize ``q.f32 * s``, residual ``fed - q * s``.
Each step is its own elementwise op, so the residual never contracts
into an FMA (the JAX package needs an optimization_barrier for that).
"""
from __future__ import annotations

import torch


def ring_slot_rotate_int8_ref(slot_pop, scales_pop, fed, scale_new):
    """slot_pop: (P, rows, 128) int8; fed: (P, rows, 128) f32;
    scales_pop, scale_new: (P, rows) f32.
    Returns (popped f32, slot_new int8, scales_new, residual f32), all
    new tensors except ``scales_new``, which is ``scale_new``."""
    popped = slot_pop.to(torch.float32) * scales_pop[..., None]
    s = scale_new[..., None]
    q = torch.clamp(torch.round(fed / s), -127, 127)
    residual = fed - q * s
    return popped, q.to(torch.int8), scale_new, residual
