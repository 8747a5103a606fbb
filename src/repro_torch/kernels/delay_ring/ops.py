"""Public wrappers of the delay-ring kernels (``repro.kernels.delay_ring.
ops``). Dispatch follows the tensors (``repro_torch.kernels.
resolve_impl``): the CUDA kernel on CUDA tensors, the plain version on
CPU tensors, the plain version anywhere with ``impl="ref"``.

Three ring layouts (``core.arena.GradArena``):

  v1  one stacked (tau, P, rows, 128) buffer; ``ring_push_pop`` pops
      and pushes slot ``head`` (a device scalar) in one pass.
  v2  per-slot buffers picked by a host-side phase; only int8 needs a
      kernel, ``ring_slot_rotate_int8`` (the f32 v2 rotate is a read
      and a scatter in ``core.arena``).
  v3  the delay-tolerant ring, stacked (S, P, rows, 128);
      ``ring_variable_pop`` folds the slots due this step in one pass.
      Its push is a copy into a slot chosen on the host and needs no
      kernel.

Where the JAX kernels donate buffers through ``input_output_aliases``
the wrappers write in place: the push slot and its scales, and fed's
buffer, which receives the new residual.
"""
from __future__ import annotations

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.delay_ring.ref import (ring_push_pop_ref,
                                                ring_slot_rotate_int8_ref,
                                                ring_variable_meta_ref,
                                                ring_variable_pop_ref)


def ring_slot_rotate_int8(slot_pop, scales_pop, slot_push, scales_push,
                          fed, scale_new, *, impl: str = "auto"):
    """Dequantize ``slot_pop``; quantize ``fed`` with error feedback into
    ``slot_push`` / ``scales_push``; write the residual over ``fed``.
    Returns (popped f32, slot_push, scales_push, fed), the last three
    being the caller's tensors, updated in place."""
    args = (slot_pop, scales_pop, slot_push, scales_push, fed, scale_new)
    if resolve_impl(impl, *args) == "ref":
        popped, q, s, residual = ring_slot_rotate_int8_ref(
            slot_pop, scales_pop, fed, scale_new)
        slot_push.copy_(q)
        scales_push.copy_(s)
        fed.copy_(residual)
        return popped, slot_push, scales_push, fed
    from repro_torch.kernels.delay_ring.kernel import delay_ring_slot_fwd
    return delay_ring_slot_fwd(*args)


def ring_push_pop(ring, g, head, scales=None, scale_new=None, *,
                  impl: str = "auto"):
    """v1: pop ring[head] (dequantized f32) and push ``g`` into the same
    slot, in place. Under int8 (``scales`` given) ``g`` is the error-fed
    gradient fed = g + residual, ``scales[head]`` takes ``scale_new``,
    and the new residual is written over ``g``. head: () int32 on the
    ring's device, never read on the host. Returns (popped, ring,
    scales, residual): the caller's tensors, residual being ``g`` under
    int8 and None under f32."""
    tensors = [t for t in (ring, g, head, scales, scale_new)
               if t is not None]
    if resolve_impl(impl, *tensors) == "ref":
        popped, ring, scales, residual = ring_push_pop_ref(
            ring, g, head, scales=scales, scale_new=scale_new)
        if residual is not None:
            g.copy_(residual)
            residual = g
        return popped, ring, scales, residual
    from repro_torch.kernels.delay_ring.kernel import delay_ring_fwd
    return delay_ring_fwd(ring, g, head, scales=scales, scale_new=scale_new)


def ring_variable_pop(ring, mask, scales=None, counts_stale=None, *,
                      impl: str = "auto"):
    """v3: fold the due slots of the stacked delay-tolerant ring
    (``mask``, (S,) bool: ``due == t``) in ascending order from zero,
    int8 dequantized in the same pass. A pure read. Returns the per-pod
    partial sums (P, rows, 128) f32 (the pod fold is the caller's), and
    with ``counts_stale`` ((2, S) f32: pod-summed counts over staleness
    tags) also meta = (count, stale_sum), (2,) f32.

    The CPU path of ``core.arena.push_pop_variable`` does not come here:
    it gathers the due slots (``arena._variable_pop_ref``), the JAX
    package's CPU path. ``impl="ref"`` is the plain version the kernel
    is held against."""
    tensors = [t for t in (ring, mask, scales, counts_stale)
               if t is not None]
    if resolve_impl(impl, *tensors) == "ref":
        popped = ring_variable_pop_ref(ring, mask, scales=scales)
        if counts_stale is None:
            return popped
        return popped, ring_variable_meta_ref(mask, counts_stale)
    from repro_torch.kernels.delay_ring.kernel import variable_pop_fwd
    return variable_pop_fwd(ring, mask, scales=scales,
                            counts_stale=counts_stale)


__all__ = ["ring_push_pop", "ring_push_pop_ref", "ring_slot_rotate_int8",
           "ring_slot_rotate_int8_ref", "ring_variable_meta_ref",
           "ring_variable_pop", "ring_variable_pop_ref"]
