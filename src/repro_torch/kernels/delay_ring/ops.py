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

On a multi-rank mesh (``launch.mesh``: pods over ranks, rows over the
``data`` ranks of a pod) the ``*_sharded`` wrappers, the ports of JAX's
shard_map wrappers, take the rank's shards and cross the ``pod`` group
(``dist.collectives``): ``ring_variable_pop_sharded`` folds the local
pods and due slots with the kernel, then all-reduces the folded f32 rows
once; ``ring_slot_rotate_int8_sharded`` all-gathers the compressed int8
payload and its row scales, dequantizes and folds them locally in pod
order, and pushes with the kernel. Both return the rows already summed
over pods.
"""
from __future__ import annotations

import torch

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


def ring_variable_pop_sharded(ring, mask, scales=None, counts_stale=None,
                              *, impl: str = "auto"):
    """The variable pop on this rank's shard of the stacked ring, under
    the ambient mesh: ``ring_variable_pop`` folds the due slots of the
    local pods (the int8 payload dequantized in place, never gathered),
    the local pods fold left in order, and ONE ``all_reduce`` of the
    folded f32 rows crosses the ``pod`` group. ``mask`` and
    ``counts_stale`` are replicated, so the fused (count, stale_sum)
    meta is already global: no second collective.

    ring: (S, local_pods, rows_local, 128) f32|int8 (``arena_ring_specs``
    cuts it); scales: (S, local_pods, rows_local) f32 under int8.
    Returns grad_sum (rows_local, 128) f32, summed over every pod, or
    (grad_sum, meta) with ``counts_stale``."""
    from repro_torch.dist.collectives import all_reduce, require_mesh
    ranks = require_mesh("ring_variable_pop_sharded")
    out = ring_variable_pop(ring, mask, scales=scales,
                            counts_stale=counts_stale, impl=impl)
    part, meta = out if counts_stale is not None else (out, None)
    acc = part[0]                       # local pods: a fixed left fold
    for p in range(1, part.shape[0]):
        acc = acc + part[p]
    acc = all_reduce(acc.contiguous(), ranks.group("pod"), axis="pod",
                     tag="pod_pop")
    return acc if meta is None else (acc, meta)


def ring_slot_rotate_int8_sharded(slot_pop, scales_pop, slot_push,
                                  scales_push, fed, scale_new, *,
                                  impl: str = "auto"):
    """The v2 int8 slot rotate on this rank's shard, under the ambient
    mesh. The only traffic across ranks is the pop: an ``all_gather``
    over the ``pod`` group of the COMPRESSED int8 slot and its per-row
    scales (the wire bytes), dequantized (``q.f32 * s``) and folded left
    in pod order on every rank, so the fold's order does not depend on
    the number of ranks. The kernel (``ring_slot_rotate_int8``) then does
    this rank's push in place; its own popped output is not used.

    slot_*: (local_pods, rows_local, 128) int8; scales_*, scale_new:
    (local_pods, rows_local) f32; fed: (local_pods, rows_local, 128) f32.
    Returns (grad_sum (rows_local, 128) f32 summed over every pod,
    slot_push, scales_push, fed), the last three updated in place."""
    from repro_torch.dist.collectives import all_gather, require_mesh
    ranks = require_mesh("ring_slot_rotate_int8_sharded")
    group, n = ranks.group("pod"), ranks.sizes["pod"]
    q_all = all_gather(slot_pop, group, n, axis="pod",
                       tag="pod_pop").flatten(0, 1)
    s_all = all_gather(scales_pop, group, n, axis="pod",
                       tag="pod_pop").flatten(0, 1)
    acc = None
    for p in range(q_all.shape[0]):
        x = q_all[p].to(torch.float32) * s_all[p][:, None]
        acc = x if acc is None else acc + x
    ring_slot_rotate_int8(slot_pop, scales_pop, slot_push, scales_push,
                          fed, scale_new, impl=impl)
    return acc, slot_push, scales_push, fed


__all__ = ["ring_push_pop", "ring_push_pop_ref", "ring_slot_rotate_int8",
           "ring_slot_rotate_int8_ref", "ring_variable_meta_ref",
           "ring_slot_rotate_int8_sharded", "ring_variable_pop",
           "ring_variable_pop_ref", "ring_variable_pop_sharded"]
