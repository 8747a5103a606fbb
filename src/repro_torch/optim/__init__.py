"""Optimizers of the port (``repro/optim/__init__.py``).

An ``Optimizer`` (the pytree master) updates a parameter tree from an
averaged gradient tree. An ``ArenaOptimizer`` keeps its state as
(rows, 128) buffers and consumes the popped, un-normalized gradient sum
and its count directly. ``dual_averaging`` is the paper's; sgd (with
momentum) and adam compose the same delayed anytime gradients with
standard optimizers, in both forms, as the JAX package does (paper Sec.
III: "AMB-DG can be implemented using other gradient-based algorithms
as well"). The arithmetic is JAX's, op for op: f32 moments, adam's step
count an int32 cast to f32 for the bias corrections ``1 - b ** t``
(taken in f32, not in Python's f64). sgd and adam ignore ``tau_obs``
and ``b_sched``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import dual_averaging as da
from repro_torch.core.arena import tree_flatten, tree_map, unflatten_tree

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    # update(opt_state, params, grad) -> (new_params, new_opt_state)


def dual_averaging_optimizer(rc: RunConfig) -> Optimizer:
    cfg = rc.ambdg

    def update(opt_state: da.DualAveragingState, params, g):
        return da.update(opt_state, g, cfg)

    return Optimizer(init=da.init, update=update)


def sgd_optimizer(rc: RunConfig, lr: float = 1e-2,
                  momentum: float = 0.9) -> Optimizer:
    def init(params):
        return (tree_map(lambda p: torch.zeros_like(p, dtype=_F32), params),)

    def update(opt_state, params, g):
        (m,) = opt_state
        m = tree_map(lambda mi, gi: momentum * mi + gi, m, g)
        params = tree_map(lambda p, mi: (p.to(_F32) - lr * mi).to(p.dtype),
                          params, m)
        return params, (m,)

    return Optimizer(init=init, update=update)


def _bias_corrections(t, b1: float, b2: float):
    """(1 - b1 ** t, 1 - b2 ** t) in f32, t the int32 step count."""
    tf = t.to(_F32)
    return tuple(1 - torch.pow(torch.tensor(b, dtype=_F32, device=t.device),
                               tf) for b in (b1, b2))


def _adam_step(lr, b1, b2, eps, weight_decay):
    """The parameter update of one leaf from its f32 step."""
    def upd(p, s):
        out = p.to(_F32) - s
        if weight_decay:
            out = out - lr * weight_decay * p.to(_F32)
        return out.to(p.dtype)
    return upd


def adam_optimizer(rc: RunConfig, lr: float = 1e-3, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=_F32), params)
        dev = tree_flatten(params)[0][0].device
        return (z, tree_map(torch.clone, z),
                torch.zeros((), dtype=torch.int32, device=dev))

    upd = _adam_step(lr, b1, b2, eps, weight_decay)

    def update(opt_state, params, g):
        m, v, t = opt_state
        t = t + 1
        m = tree_map(lambda a, b: b1 * a + (1 - b1) * b, m, g)
        v = tree_map(lambda a, b: b2 * a + (1 - b2) * torch.square(b), v, g)
        bc1, bc2 = _bias_corrections(t, b1, b2)
        params = tree_map(
            lambda p, mi, vi: upd(p, lr * (mi / bc1)
                                  / (torch.sqrt(vi / bc2) + eps)),
            params, m, v)
        return params, (m, v, t)

    return Optimizer(init=init, update=update)


def make_optimizer(rc: RunConfig) -> Optimizer:
    name = rc.optimizer
    if name == "dual_averaging":
        return dual_averaging_optimizer(rc)
    if name == "sgd":
        return sgd_optimizer(rc)
    if name == "adam":
        return adam_optimizer(rc)
    raise ValueError(f"unknown optimizer {name!r}")


class ArenaOptimizer(NamedTuple):
    init: Callable[[], Any]
    update: Callable[..., Tuple[Any, Any]]
    # update(opt_state, params, grad_sum_flat, count, tau_obs=None,
    #        b_sched=None) -> (params, state); tau_obs, the observed
    #   staleness of the applied gradients (variable-delay path),
    #   switches dual averaging to the delay-adaptive alpha; b_sched, a
    #   batch schedule's target b(t), replaces b_bar in alpha


def arena_dual_averaging_optimizer(rc: RunConfig, layout,
                                   device) -> ArenaOptimizer:
    cfg = rc.ambdg

    def update(opt_state: da.ArenaDualAveragingState, params, g_sum, count,
               tau_obs=None, b_sched=None):
        # params leaves come back f32, as in the JAX package
        return da.update_arena(layout, opt_state, g_sum, count, cfg,
                               tau_obs=tau_obs, b_sched=b_sched)

    return ArenaOptimizer(init=lambda: da.init_arena(layout, device),
                          update=update)


def _norm_flat(g_sum, count):
    return g_sum / torch.clamp(count, min=1e-12)


def arena_sgd_optimizer(rc: RunConfig, layout, device, lr: float = 1e-2,
                        momentum: float = 0.9) -> ArenaOptimizer:
    def update(opt_state, params, g_sum, count, tau_obs=None, b_sched=None):
        (m,) = opt_state
        m = momentum * m + _norm_flat(g_sum, count)
        # lr rides the unflatten gather (as the dual-averaging prox): the
        # same multiply as the pytree form's lr * m, bit for bit
        step = unflatten_tree(layout, m, cast=False, scale=lr)
        params = tree_map(lambda p, s: (p.to(_F32) - s).to(p.dtype),
                          params, step)
        return params, (m,)

    return ArenaOptimizer(
        init=lambda: (torch.zeros((layout.rows, 128), dtype=_F32,
                                  device=device),),
        update=update)


def arena_adam_optimizer(rc: RunConfig, layout, device, lr: float = 1e-3,
                         b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8, weight_decay: float = 0.0
                         ) -> ArenaOptimizer:
    def init():
        z = torch.zeros((layout.rows, 128), dtype=_F32, device=device)
        return (z, z.clone(), torch.zeros((), dtype=torch.int32,
                                          device=device))

    upd = _adam_step(lr, b1, b2, eps, weight_decay)

    def update(opt_state, params, g_sum, count, tau_obs=None, b_sched=None):
        m, v, t = opt_state
        g = _norm_flat(g_sum, count)
        t = t + 1
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        bc1, bc2 = _bias_corrections(t, b1, b2)
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step_tree = unflatten_tree(layout, step, cast=False)
        return tree_map(upd, params, step_tree), (m, v, t)

    return ArenaOptimizer(init=init, update=update)


def make_arena_optimizer(rc: RunConfig, layout, device) -> ArenaOptimizer:
    name = rc.optimizer
    if name == "dual_averaging":
        return arena_dual_averaging_optimizer(rc, layout, device)
    if name == "sgd":
        return arena_sgd_optimizer(rc, layout, device)
    if name == "adam":
        return arena_adam_optimizer(rc, layout, device)
    raise ValueError(f"unknown optimizer {name!r}")
