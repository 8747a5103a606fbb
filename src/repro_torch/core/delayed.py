"""Delayed cross-pod gradient exchange on a parameter tree: the pytree
master's delay buffer and the pod reduction (``repro/core/delayed.py``).

In the JAX package the pod dimension's sum is the cross-pod (DCN)
all-reduce that AMB-DG overlaps with compute. The port so far runs the
pods of one process on one device (the pod axis a written-out leading
dimension), where the reduction is the deterministic left fold that both
JAX master pipelines share off-mesh (``repro/core/delayed.py:64``). This
pytree master has no multi-rank form; the arena master's pod reduce
across ranks is ``core.arena``'s sharded route.

``DelayBuffer`` is the per-leaf reference of the arena's delay ring: a
``tau``-deep circular buffer of pod-stacked gradients. ``push_pop``
inserts this step's entry and returns the one from tau steps ago summed
over pods. Optional int8 compression (per-tensor, per-pod scales) keeps
an error-feedback residual. The slot index ``head`` stays on the device:
the buffer is read and written with ``index_select``/``index_copy_``, so
a step never waits on the host. ``push_pop`` writes the pushed slot in
place: a buffer passed to it must not be used again (use the one it
returns).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch


class DelayBuffer(NamedTuple):
    grads: Any              # tree; leaves (tau, n_pods, *shape) f32 or int8
    scales: Any             # tree; leaves (tau, n_pods) f32 (int8), or None
    residual: Any           # tree; leaves (n_pods, *shape) f32 (int8), or None
    counts: torch.Tensor    # (tau, n_pods) f32
    head: torch.Tensor      # () int32: next slot to overwrite (the oldest)


def init_buffer(params, tau: int, n_pods: int,
                compression: str = "none") -> Optional[DelayBuffer]:
    """Zeroed buffer beside ``params`` (each leaf on its own device);
    None for tau = 0."""
    from repro_torch.core.arena import tree_flatten, tree_map
    if tau == 0:
        return None
    if compression not in ("none", "int8"):
        raise ValueError(f"unknown pod_compression {compression!r}")

    def zeros(shape, dtype, like):
        return torch.zeros(shape, dtype=dtype, device=like.device)

    f32 = torch.float32
    scales = residual = None
    if compression == "int8":
        grads = tree_map(lambda p: zeros((tau, n_pods) + tuple(p.shape),
                                         torch.int8, p), params)
        scales = tree_map(lambda p: zeros((tau, n_pods), f32, p), params)
        residual = tree_map(lambda p: zeros((n_pods,) + tuple(p.shape), f32,
                                            p), params)
    else:
        grads = tree_map(lambda p: zeros((tau, n_pods) + tuple(p.shape), f32,
                                         p), params)
    like = tree_flatten(params)[0][0]
    return DelayBuffer(grads=grads, scales=scales, residual=residual,
                       counts=zeros((tau, n_pods), f32, like),
                       head=zeros((), torch.int32, like))


def buffer_logical_axes(params_axes, tau: int, compression: str = "none"):
    """Logical axes of the buffer's fields (leading (tau, pod) dims), as
    the JAX package's ``buffer_logical_axes``; None for tau = 0."""
    from repro_torch.core.arena import tree_map
    if tau == 0:
        return None
    g_axes = tree_map(lambda ax: (None, "pod") + tuple(ax), params_axes)
    s_axes = r_axes = None
    if compression == "int8":
        s_axes = tree_map(lambda ax: (None, "pod"), params_axes)
        r_axes = tree_map(lambda ax: ("pod",) + tuple(ax), params_axes)
    return DelayBuffer(grads=g_axes, scales=s_axes, residual=r_axes,
                       counts=(None, "pod"), head=())


def pod_sum(x):
    """Left fold over the leading pod dimension: x[0] + x[1] + ... in
    that order (bitwise the JAX off-mesh ``pod_sum``). With one pod it
    returns the view ``x[0]``."""
    acc = x[0]
    for p in range(1, x.shape[0]):
        acc = acc + x[p]
    return acc


def _pod_view(s, ndim):
    """Per-pod scales (n_pods,) shaped to broadcast over (n_pods, ...)."""
    return s.reshape((-1,) + (1,) * (ndim - 1))


def _quantize(g):
    """Symmetric int8 quantization of each pod of ``g`` (n_pods, *shape)
    with its own scale (JAX's ``jax.vmap(_quantize)``). Returns (q int8,
    scale (n_pods,) f32). ``torch.round`` rounds half to even."""
    amax = torch.amax(torch.abs(g).reshape(g.shape[0], -1), dim=1)
    c127 = torch.full((), 127.0, dtype=torch.float32, device=g.device)
    scale = torch.div(torch.clamp(amax, min=1e-12), c127)
    q = torch.clamp(torch.round(g / _pod_view(scale, g.dim())), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q, scale):
    """q * scale per pod, its own op: the residual ``fed - deq`` that
    follows is never contracted into an FMA (eager PyTorch does not
    fuse; JAX pins it with an optimization barrier)."""
    return q.to(torch.float32) * _pod_view(scale, q.dim())


def push_pop(buffer: DelayBuffer, pod_grads, pod_counts,
             compression: str = "none"
             ) -> Tuple[Any, torch.Tensor, DelayBuffer]:
    """Insert this step's pod-stacked (grads, counts); return the entry
    from tau steps ago summed over pods, its count, and the buffer.

    pod_grads: tree, leaves (n_pods, *shape) f32; pod_counts: (n_pods,)
    f32. Returns (grad_sum tree, count () f32, new_buffer). The returned
    sums are tensors of their own (never views of the buffer)."""
    from repro_torch.core.arena import tree_flatten, tree_map, tree_unflatten
    idx = buffer.head.to(torch.int64).reshape(1)

    def slot(b):
        return torch.index_select(b, 0, idx)[0]

    if compression == "int8":
        old = tree_map(lambda q, s: _dequantize(slot(q), slot(s)),
                       buffer.grads, buffer.scales)
    else:
        old = tree_map(slot, buffer.grads)
    grad_sum = tree_map(pod_sum, old)
    count = torch.sum(slot(buffer.counts))

    if compression == "int8":
        fed = tree_map(lambda g, r: g + r, pod_grads, buffer.residual)
        leaves, treedef = tree_flatten(fed)
        pairs = [_quantize(g) for g in leaves]
        q_tree = tree_unflatten(treedef, [q for q, _ in pairs])
        s_tree = tree_unflatten(treedef, [s for _, s in pairs])
        tree_map(lambda b, q: b.index_copy_(0, idx, q[None]), buffer.grads,
                 q_tree)
        tree_map(lambda b, s: b.index_copy_(0, idx, s[None]), buffer.scales,
                 s_tree)
        residual = tree_map(lambda f, q, s: f - _dequantize(q, s), fed,
                            q_tree, s_tree)
    elif compression == "none":
        tree_map(lambda b, g: b.index_copy_(0, idx, g[None].to(b.dtype)),
                 buffer.grads, pod_grads)
        residual = buffer.residual
    else:
        raise ValueError(f"unknown pod_compression {compression!r}")
    buffer.counts.index_copy_(0, idx, pod_counts[None].to(torch.float32))
    head = (buffer.head + 1) % buffer.counts.shape[0]
    return grad_sum, count, buffer._replace(residual=residual, head=head)
