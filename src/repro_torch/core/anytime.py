"""Anytime (variable-size) minibatch gradient accumulation.

The paper's workers compute gradients for a fixed time T_p and ship
(sum_of_gradients, count). As in the JAX package, a shard accumulates
over ``n_microbatches`` microbatches whose per-sample 0/1 ``weights``
carry the anytime mask, so a shard that finished b_i of its samples
contributes exactly the paper's (g_i(t), b_i(t)); aggregation then
normalizes by the global count (eq. (5)).

``accumulate_scan`` is the JAX ``lax.scan`` as a Python loop over every
microbatch (masked samples still cost their flops). ``accumulate_while``
(``anytime_impl="while_dynamic"``) is JAX's ``lax.while_loop`` with a
dynamic trip count: it runs the first ``n_active`` microbatches only, a
count read on the host when the caller gives one (the default, every
microbatch, reads nothing back). The normalization by the global
count is ``normalize`` on the pytree master; the arena master fuses it
into its dual update (``kernels/dual_update``), as on the JAX arena path.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.arena import tree_flatten, tree_unflatten

LossFn = Callable[[Dict, Dict], Tuple[torch.Tensor, Dict]]


def _split_batch(batch: Dict, n_mb: int):
    """Yield ``n_mb`` microbatches, each leaf (B, ...) -> (B//n_mb, ...)."""
    for k, x in batch.items():
        if x.shape[0] % n_mb:
            raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows does not "
                             f"split into {n_mb} microbatches")
    split = {k: x.reshape((n_mb, x.shape[0] // n_mb) + tuple(x.shape[1:]))
             for k, x in batch.items()}
    for i in range(n_mb):
        yield {k: x[i] for k, x in split.items()}


def accumulate_scan(loss_fn: LossFn, params: Dict, batch: Dict, n_mb: int):
    """Masked accumulation over every microbatch.

    Returns (grad_sum, count, metrics): grad_sum the *sum* of per-sample
    gradients (weighted), a tree like ``params`` (nested dicts, flattened
    in the arena's sorted-key order) with f32 leaves; count the weighted
    sample count — the worker message m_i(t) = (g_i(t), b_i(t))."""
    if n_mb == 1:
        flat, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        g, count, loss_sum = _grads_of(loss_fn, leaves, treedef, batch)
        return tree_unflatten(treedef, g), count, {"loss_sum": loss_sum}
    return _accumulate(loss_fn, params, batch, n_mb, n_mb)


def accumulate_while(loss_fn: LossFn, params: Dict, batch: Dict, n_mb: int,
                     n_active=None):
    """Dynamic-trip-count accumulation: the first ``n_active`` (<= n_mb)
    of the ``n_mb`` microbatches, from zero sums (JAX's ``while_loop``).
    ``n_active`` None runs all ``n_mb`` and reads nothing back; a given
    count (an int or a 0-dim tensor) is read on the host. Returns what
    ``accumulate_scan`` returns; with ``n_active == n_mb`` the same
    values."""
    n_run = n_mb if n_active is None else int(n_active)
    if not 0 <= n_run <= n_mb:
        raise ValueError(f"n_active={n_run}: expected 0..{n_mb} "
                         "microbatches")
    return _accumulate(loss_fn, params, batch, n_mb, n_run)


def _grads_of(loss_fn, leaves, treedef, mb):
    loss_sum, aux = loss_fn(tree_unflatten(treedef, leaves), mb)
    g = torch.autograd.grad(loss_sum, leaves, allow_unused=True)
    # a leaf the loss does not reach has gradient 0, as in JAX
    g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, leaves)]
    return ([x.to(torch.float32) for x in g], aux["count"].detach(),
            aux["loss_sum"].detach())


def _accumulate(loss_fn, params, batch, n_mb: int, n_run: int):
    """The sums over the first ``n_run`` of ``n_mb`` microbatches."""
    flat, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    dev = leaves[0].device
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
            for p in leaves]
    csum = torch.zeros((), dtype=torch.float32, device=dev)
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    for i, mb in enumerate(_split_batch(batch, n_mb)):
        if i == n_run:
            break
        g, count, loss_sum = _grads_of(loss_fn, leaves, treedef, mb)
        for a, b in zip(gsum, g):
            a.add_(b)          # in place: one f32 sum per leaf for good
        del g
        csum = csum + count
        lsum = lsum + loss_sum
    return tree_unflatten(treedef, gsum), csum, {"loss_sum": lsum}


def pop_n_active(batch: Dict, n_chunks: int):
    """(the batch without ``n_active``, each chunk's count or None). The
    count is a scalar for every chunk or one per chunk (pod or worker),
    as the caller filled it; without one every chunk runs all its
    microbatches."""
    if "n_active" not in batch:
        return batch, [None] * n_chunks
    n_active = batch["n_active"].reshape(-1)
    if n_active.numel() not in (1, n_chunks):
        raise ValueError(f"batch['n_active'] holds {n_active.numel()} "
                         f"counts for {n_chunks} chunks")
    rest = {k: v for k, v in batch.items() if k != "n_active"}
    return rest, [n_active[i % n_active.numel()] for i in range(n_chunks)]


def normalize(grad_sum, count):
    """g(t) = grad_sum / max(count, 1e-12) leaf by leaf: a step with no
    samples applies a zero gradient, not NaNs. ``count`` is a 0-dim f32
    tensor on the leaves' device, so the quotient is the correctly
    rounded f32 division (a Python scalar divisor on CUDA would be a
    multiplication by its reciprocal)."""
    denom = torch.clamp(count, min=1e-12)
    leaves, treedef = tree_flatten(grad_sum)
    return tree_unflatten(treedef, [g / denom for g in leaves])
