"""Dual averaging (Nesterov'09 / Xiao'09), the paper's workhorse, over a
parameter tree and on the flat arena (ported from
``repro/core/dual_averaging.py``):

    z(t+1) = z(t) + g(t)
    w(t+1) = argmin_w <z(t+1), w> + psi(w) / alpha(t+1)

With psi(w) = 0.5 ||w||^2 the argmin is w = -alpha z; with an L2 ball
of radius C it is that point projected onto the ball.

Step sizes (Theorem IV.1): alpha(t)^{-1} = L + sqrt((t + tau) / b_bar).

The pytree form (``init``, ``prox_step``, ``update``) is the reference
master the arena form is held against bit for bit, and the simulator's
master. Every scalar stays a 0-dim tensor on the state's device, so a
step never waits on the host. Divisions take their constants as device
tensors: PyTorch turns a division by a Python scalar on CUDA into a
multiplication by its reciprocal, which is not the division the JAX
package computes.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.configs.base import AmbdgConfig
from repro_torch.core.arena import tree_flatten, tree_map


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def alpha(t, cfg: AmbdgConfig, tau=None, b=None):
    """Step size alpha(t) = 1 / (L + sqrt((t + tau) / b)); t a 0-dim f32
    tensor. ``tau``/``b`` default to the config's static values. The
    variable-delay path passes the observed staleness of the applied
    gradients as ``tau`` (a 0-dim device tensor, never read on the
    host): the delay-adaptive step size of Agarwal and Duchi. With a
    constant tau equal to the config's it is the same arithmetic. An
    adaptive batch schedule passes its target b(t) as ``b``: a 0-dim f32
    device tensor on the training step (``batch["b_sched"]``), a Python
    number in the simulator."""
    tau = cfg.tau if tau is None else tau
    b = cfg.b_bar if b is None else b
    if not isinstance(b, torch.Tensor):
        b = _const(b, t)
    return torch.div(_const(1.0, t), cfg.smoothness_L +
                     torch.sqrt(torch.div(t + tau, b)))


class DualAveragingState(NamedTuple):
    z: Any             # dual variable: a tree like params, f32 leaves
    t: torch.Tensor    # () int32: updates applied


def init(params) -> DualAveragingState:
    """z = 0 beside each leaf of ``params`` (on its device), t = 0."""
    z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    device = tree_flatten(params)[0][0].device
    return DualAveragingState(z=z, t=torch.zeros((), dtype=torch.int32,
                                                 device=device))


def prox_step(z, a, cfg: AmbdgConfig):
    """w = argmin <z, w> + psi(w) / a for the configured proximal psi;
    ``a`` a 0-dim f32 tensor. The ball norm sums each leaf, then the
    leaves in order, as the JAX package does."""
    w = tree_map(lambda zi: -a * zi, z)
    if cfg.proximal == "l2_ball":
        sq = sum(torch.sum(torch.square(x)) for x in tree_flatten(w)[0])
        norm = torch.sqrt(sq)
        scale = torch.clamp(torch.div(_const(cfg.radius_C, norm),
                                      torch.clamp(norm, min=1e-12)), max=1.0)
        w = tree_map(lambda wi: wi * scale, w)
    elif cfg.proximal != "l2":
        raise ValueError(f"unknown proximal {cfg.proximal!r}")
    return w


def update(state: DualAveragingState, g, cfg: AmbdgConfig, tau=None,
           b=None) -> Tuple[Any, DualAveragingState]:
    """One update with the (already averaged) gradient tree ``g``:
    z += g, w = prox(z, alpha(t + 2)). Returns (w, new state); the
    state's z is not written in place. ``tau``/``b`` reach ``alpha``
    (observed staleness, scheduled batch)."""
    t_next = state.t + 1
    z_next = tree_map(lambda zi, gi: zi + gi.to(torch.float32), state.z, g)
    w = prox_step(z_next, alpha(t_next.to(torch.float32) + 1.0, cfg,
                                tau=tau, b=b), cfg)
    return w, DualAveragingState(z=z_next, t=t_next)


class ArenaDualAveragingState(NamedTuple):
    z: torch.Tensor    # (rows, 128) f32: the flat dual variable
    t: torch.Tensor    # () int32: updates applied


def init_arena(layout, device, rows=None) -> ArenaDualAveragingState:
    """z = 0 over the arena's rows (``rows``: a rank's row shard)."""
    rows = layout.rows if rows is None else rows
    return ArenaDualAveragingState(
        z=torch.zeros((rows, 128), dtype=torch.float32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device))


def update_arena(layout, state: ArenaDualAveragingState, g_sum, count,
                 cfg: AmbdgConfig, tau_obs=None, b_sched=None
                 ) -> Tuple[Any, ArenaDualAveragingState]:
    """Arena dual-averaging update with the count normalization fused in:
    takes the *un-normalized* popped gradient sum and its count, runs
    the fused update (the CUDA kernel on the card; z updated in place)
    and returns (params tree with f32 leaves, new state). ``tau_obs``
    (the variable-delay path) replaces the static tau in ``alpha``,
    ``b_sched`` (an adaptive batch schedule's target) the static
    ``b_bar``. Under a multi-rank mesh (``arena.sharded_route``) z and
    g_sum are the rank's row shard: ``dual_update_arena_sharded``
    updates them, and w is all-gathered over the group the rows shard
    over (``data x model``) before the projection, so the whole
    parameter tree comes back on every rank (``core.ambdg`` cuts the
    rank's ``model`` blocks from it).

    ``proximal="l2"`` matches the JAX package bit for bit. Under
    ``"l2_ball"`` the ball norm is one flat reduction whose summation
    order differs between frameworks, so an active projection agrees to
    about one ulp (the JAX package states the same of its own two
    master paths)."""
    from repro_torch.core import arena as arena_mod
    from repro_torch.kernels.dual_update.ops import (
        dual_update_arena, dual_update_arena_sharded)
    if cfg.proximal not in ("l2", "l2_ball"):
        raise ValueError(f"unknown proximal {cfg.proximal!r}")
    t_next = state.t + 1
    a = alpha(t_next.to(torch.float32) + 1.0, cfg, tau=tau_obs, b=b_sched)
    ranks = arena_mod.sharded_route("update_arena")
    if ranks is None:
        z_next, w = dual_update_arena(state.z, g_sum, count, a)
    else:
        # the rank's rows; w all-gathered over the row group rebuilds
        # the whole parameters (and the ball norm sees every row)
        z_next, w = dual_update_arena_sharded(state.z, g_sum, count, a)
        if w.shape[0] != layout.rows:
            from repro_torch.dist.collectives import all_gather_rows
            w = all_gather_rows(w, ranks.group(("data", "model")),
                                layout.rows // w.shape[0],
                                axis=arena_mod.rows_axis(ranks),
                                tag="w_rows")
    if cfg.proximal == "l2_ball":
        norm = torch.sqrt(torch.sum(torch.square(w)))   # arena pads are zero
        proj = torch.clamp(torch.div(_const(cfg.radius_C, norm),
                                     torch.clamp(norm, min=1e-12)), max=1.0)
        w = w * proj
    params = arena_mod.unflatten_tree(layout, w, cast=False)
    return params, ArenaDualAveragingState(z=z_next, t=t_next)
