"""Public wrapper of the int8 delay-ring slot rotate (ring layout v2).

``ring_slot_rotate_int8`` is the port of ``repro.kernels.delay_ring.ops.
ring_slot_rotate_int8``. Dispatch follows the tensors
(``repro_torch.kernels.resolve_impl``): the CUDA kernel on CUDA tensors,
the plain version on CPU tensors, the plain version anywhere with
``impl="ref"``.

Both implementations write in place where the JAX kernel donates its
buffers through ``input_output_aliases``: the push slot, the push
scales, and fed's buffer, which receives the new residual. The f32 v2
rotate needs no kernel: its pop is a read and its push a scatter
(``core.arena``).
"""
from __future__ import annotations

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.delay_ring.ref import ring_slot_rotate_int8_ref


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


__all__ = ["ring_slot_rotate_int8", "ring_slot_rotate_int8_ref"]
