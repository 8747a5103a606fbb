"""Dual averaging (Nesterov'09 / Xiao'09), the paper's workhorse, on the
flat arena (ported from ``repro/core/dual_averaging.py``):

    z(t+1) = z(t) + g(t)
    w(t+1) = argmin_w <z(t+1), w> + psi(w) / alpha(t+1)

With psi(w) = 0.5 ||w||^2 the argmin is w = -alpha z; with an L2 ball
of radius C it is that point projected onto the ball.

Step sizes (Theorem IV.1): alpha(t)^{-1} = L + sqrt((t + tau) / b_bar).

Every scalar stays a 0-dim tensor on the arena's device, so a step
never waits on the host. Divisions take their constants as device
tensors: PyTorch turns a division by a Python scalar on CUDA into a
multiplication by its reciprocal, which is not the division the JAX
package computes.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.configs.base import AmbdgConfig


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def alpha(t, cfg: AmbdgConfig, tau=None, b=None):
    """Step size alpha(t) = 1 / (L + sqrt((t + tau) / b)); t a 0-dim f32
    tensor. ``tau``/``b`` default to the config's static values. The
    variable-delay path passes the observed staleness of the applied
    gradients as ``tau`` (a 0-dim device tensor, never read on the
    host): the delay-adaptive step size of Agarwal and Duchi. With a
    constant tau equal to the config's it is the same arithmetic."""
    tau = cfg.tau if tau is None else tau
    b = cfg.b_bar if b is None else b
    return torch.div(_const(1.0, t), cfg.smoothness_L +
                     torch.sqrt(torch.div(t + tau, _const(b, t))))


class ArenaDualAveragingState(NamedTuple):
    z: torch.Tensor    # (rows, 128) f32: the flat dual variable
    t: torch.Tensor    # () int32: updates applied


def init_arena(layout, device) -> ArenaDualAveragingState:
    return ArenaDualAveragingState(
        z=torch.zeros((layout.rows, 128), dtype=torch.float32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device))


def update_arena(layout, state: ArenaDualAveragingState, g_sum, count,
                 cfg: AmbdgConfig, tau_obs=None
                 ) -> Tuple[Any, ArenaDualAveragingState]:
    """Arena dual-averaging update with the count normalization fused in:
    takes the *un-normalized* popped gradient sum and its count, runs
    the fused update (the CUDA kernel on the card; z updated in place)
    and returns (params tree with f32 leaves, new state). ``tau_obs``
    (the variable-delay path) replaces the static tau in ``alpha``.

    ``proximal="l2"`` matches the JAX package bit for bit. Under
    ``"l2_ball"`` the ball norm is one flat reduction whose summation
    order differs between frameworks, so an active projection agrees to
    about one ulp (the JAX package states the same of its own two
    master paths)."""
    from repro_torch.core import arena as arena_mod
    from repro_torch.kernels.dual_update.ops import dual_update_arena
    if cfg.proximal not in ("l2", "l2_ball"):
        raise ValueError(f"unknown proximal {cfg.proximal!r}")
    t_next = state.t + 1
    a = alpha(t_next.to(torch.float32) + 1.0, cfg, tau=tau_obs)
    z_next, w = dual_update_arena(state.z, g_sum, count, a)
    if cfg.proximal == "l2_ball":
        norm = torch.sqrt(torch.sum(torch.square(w)))   # arena pads are zero
        proj = torch.clamp(torch.div(_const(cfg.radius_C, norm),
                                     torch.clamp(norm, min=1e-12)), max=1.0)
        w = w * proj
    params = arena_mod.unflatten_tree(layout, w, cast=False)
    return params, ArenaDualAveragingState(z=z_next, t=t_next)
