"""Anytime (variable-size) minibatch gradient accumulation.

The paper's workers compute gradients for a fixed time T_p and ship
(sum_of_gradients, count). As in the JAX package, a shard accumulates
over ``n_microbatches`` microbatches whose per-sample 0/1 ``weights``
carry the anytime mask, so a shard that finished b_i of its samples
contributes exactly the paper's (g_i(t), b_i(t)); aggregation then
normalizes by the global count (eq. (5)).

``accumulate_scan`` is the JAX ``lax.scan`` as a Python loop over every
microbatch (masked samples still cost their flops). The dynamic-trip
``accumulate_while`` is not ported yet. The normalization by the global
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
    flat, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    at = tree_unflatten(treedef, leaves)

    def grads_of(mb):
        loss_sum, aux = loss_fn(at, mb)
        g = torch.autograd.grad(loss_sum, leaves, allow_unused=True)
        # a leaf the loss does not reach has gradient 0, as in JAX
        g = [torch.zeros_like(p) if x is None else x
             for x, p in zip(g, leaves)]
        return ([x.to(torch.float32) for x in g], aux["count"].detach(),
                aux["loss_sum"].detach())

    if n_mb == 1:
        g, count, loss_sum = grads_of(batch)
        return tree_unflatten(treedef, g), count, {"loss_sum": loss_sum}

    dev = leaves[0].device
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
            for p in leaves]
    csum = torch.zeros((), dtype=torch.float32, device=dev)
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    for mb in _split_batch(batch, n_mb):
        g, count, loss_sum = grads_of(mb)
        for a, b in zip(gsum, g):
            a.add_(b)          # in place: one f32 sum per leaf for good
        del g
        csum = csum + count
        lsum = lsum + loss_sum
    return tree_unflatten(treedef, gsum), csum, {"loss_sum": lsum}


def normalize(grad_sum, count):
    """g(t) = grad_sum / max(count, 1e-12) leaf by leaf: a step with no
    samples applies a zero gradient, not NaNs. ``count`` is a 0-dim f32
    tensor on the leaves' device, so the quotient is the correctly
    rounded f32 division (a Python scalar divisor on CUDA would be a
    multiplication by its reciprocal)."""
    denom = torch.clamp(count, min=1e-12)
    leaves, treedef = tree_flatten(grad_sum)
    return tree_unflatten(treedef, [g / denom for g in leaves])
