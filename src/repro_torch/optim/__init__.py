"""Optimizers of the port (``repro/optim/__init__.py``).

An ``Optimizer`` (the pytree master) updates a parameter tree from an
averaged gradient tree. An ``ArenaOptimizer`` keeps its state as
(rows, 128) buffers and consumes the popped, un-normalized gradient sum
and its count directly. The port carries the paper's dual averaging in
both forms; the beyond-paper sgd and adam come later (ROADMAP A.14).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

from repro_torch.configs.base import RunConfig
from repro_torch.core import dual_averaging as da


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    # update(opt_state, params, grad) -> (new_params, new_opt_state)


def dual_averaging_optimizer(rc: RunConfig) -> Optimizer:
    cfg = rc.ambdg

    def update(opt_state: da.DualAveragingState, params, g):
        return da.update(opt_state, g, cfg)

    return Optimizer(init=da.init, update=update)


def _unported(name: str):
    if name in ("sgd", "adam"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A.14: the sgd "
            "and adam optimizers); the port runs 'dual_averaging'")
    raise ValueError(f"unknown optimizer {name!r}")


def make_optimizer(rc: RunConfig) -> Optimizer:
    if rc.optimizer == "dual_averaging":
        return dual_averaging_optimizer(rc)
    _unported(rc.optimizer)


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


def make_arena_optimizer(rc: RunConfig, layout, device) -> ArenaOptimizer:
    if rc.optimizer == "dual_averaging":
        return arena_dual_averaging_optimizer(rc, layout, device)
    _unported(rc.optimizer)
