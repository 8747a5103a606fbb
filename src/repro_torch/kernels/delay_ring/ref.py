"""Plain PyTorch versions of the delay-ring kernels: the twins of
``repro/kernels/delay_ring/ref.py`` and the oracles the CUDA kernels
are held against.

Arithmetic is formula-identical to the JAX reference: quantize
``clip(round(fed / s), -127, 127)`` (torch.round rounds half to even,
as jnp.round does), dequantize ``q.f32 * s``, residual ``fed - q * s``.
Each step is its own elementwise op, so nothing contracts into an FMA
(the JAX package needs an optimization_barrier for that).

The ring's head is a 0-dim device tensor; the v1 functions index the
ring with it on the device (``index_select`` / ``index_copy_``), so
nothing is read back to the host.
"""
from __future__ import annotations

import torch


def ring_slot_rotate_int8_ref(slot_pop, scales_pop, fed, scale_new):
    """Ring layout v2 int8 rotate. slot_pop: (P, rows, 128) int8; fed:
    (P, rows, 128) f32; scales_pop, scale_new: (P, rows) f32.
    Returns (popped f32, slot_new int8, scales_new, residual f32), all
    new tensors except ``scales_new``, which is ``scale_new``."""
    popped = slot_pop.to(torch.float32) * scales_pop[..., None]
    s = scale_new[..., None]
    q = torch.clamp(torch.round(fed / s), -127, 127)
    residual = fed - q * s
    return popped, q.to(torch.int8), scale_new, residual


def _head_index(head):
    return head.reshape(1).to(torch.int64)


def ring_rotate_int8(ring, scales, fed, scale_new, head):
    """Ring layout v1 int8 rotate with the error-fed gradient ``fed``
    already formed: pop ring[head] (dequantized), write the quantized
    fed and its scales into slot ``head`` in place. ring: (tau, P, rows,
    128) int8; scales: (tau, P, rows) f32; fed: (P, rows, 128) f32;
    scale_new: (P, rows) f32; head: () int32.
    Returns (popped f32, ring, scales, residual), the residual a new
    tensor."""
    idx = _head_index(head)
    q_old = torch.index_select(ring, 0, idx)[0]
    s_old = torch.index_select(scales, 0, idx)[0]
    popped = q_old.to(torch.float32) * s_old[..., None]
    s = scale_new[..., None]
    q = torch.clamp(torch.round(fed / s), -127, 127)
    ring.index_copy_(0, idx, q.to(torch.int8)[None])
    scales.index_copy_(0, idx, scale_new[None])
    residual = fed - q * s
    return popped, ring, scales, residual


def ring_push_pop_ref(ring, g, head, scales=None, scale_new=None):
    """Ring layout v1 rotate: pop ring[head] (dequantized), overwrite it
    with g (quantized under int8) in place. ring: (tau, P, rows, 128)
    f32|int8; g: (P, rows, 128) f32, under int8 (``scales`` given) the
    already error-fed gradient; head: () int32; scales: (tau, P, rows)
    f32; scale_new: (P, rows) f32.
    Returns (popped f32, ring, scales, residual)."""
    if scales is None:
        idx = _head_index(head)
        popped = torch.index_select(ring, 0, idx)[0]
        ring.index_copy_(0, idx, g[None])
        return popped, ring, None, None
    return ring_rotate_int8(ring, scales, g, scale_new, head)


def ring_variable_pop_ref(ring, mask, scales=None):
    """Masked pop of the stacked delay-tolerant ring (layout v3): fold
    the due slots over ascending j from a zero accumulator, the order of
    the JAX oracle ``ring_variable_pop_ref`` and of the CUDA kernel. A
    slot that is not due contributes an exact zero
    (``torch.where(mask[j], slot_j, 0)``), so a non-finite value in a
    dead slot does not reach the result; on finite data this is bitwise
    the JAX oracle's ``acc + m * slot_j``.

    ring: (S, P, rows, 128) f32|int8; mask: (S,) bool; scales: (S, P,
    rows) f32 under int8. Returns the per-pod partial sums (P, rows,
    128) f32 (the pod fold is the caller's)."""
    mask = mask.to(torch.bool)
    acc = torch.zeros(ring.shape[1:], dtype=torch.float32,
                      device=ring.device)
    zero = torch.zeros((), dtype=torch.float32, device=ring.device)
    for j in range(ring.shape[0]):
        x = ring[j].to(torch.float32)
        if scales is not None:
            x = x * scales[j][..., None]
        acc = acc + torch.where(mask[j], x, zero)
    return acc


def ring_variable_meta_ref(mask, counts_stale):
    """The variable pop's scalar epilogue: fold the masked count and
    staleness sum over ascending j from zero. mask: (S,) bool;
    counts_stale: (2, S) f32, row 0 the pod-summed per-slot counts,
    row 1 the per-slot staleness tags. Both rows hold small integers,
    so every fold order sums them exactly. Returns (count, stale_sum)
    as a (2,) f32; tau_obs is the caller's stale_sum / max(count, 1)."""
    m = mask.to(torch.float32)
    cs = counts_stale.to(torch.float32)
    count = torch.zeros((), dtype=torch.float32, device=cs.device)
    stale_sum = torch.zeros((), dtype=torch.float32, device=cs.device)
    for j in range(cs.shape[1]):
        mc = m[j] * cs[0, j]
        count = count + mc
        stale_sum = stale_sum + mc * cs[1, j]
    return torch.stack([count, stale_sum])
