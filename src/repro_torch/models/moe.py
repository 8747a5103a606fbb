"""Mixture-of-experts FFN of the port (``repro/models/moe.py``):
Mixtral-style top-k routing, dispatched in groups.

Tokens are routed in independent groups of ``dispatch_group`` tokens:
the capacity, the dispatch tensors and the gathers are all per group.
Two dispatch routes, chosen by ``ModelConfig.moe_impl``:

* ``einsum``: the dense capacity dispatch, a (G, g, E, C) one-hot
  dispatch tensor and two routing einsums;
* ``gather``: the expert rank of each assignment from a per-group
  cumsum, the token ids scattered into E * C slots, the activations
  gathered, and the weighted outputs added back per token.

Both drop the assignments beyond the capacity C = ceil8(k g / E * cf)
(at least 8) in the same order: the flattened (token, k) order of the
group. The router orders experts of equal probability lowest index
first, as ``jax.lax.top_k`` does (ROADMAP C.12, C.14). JAX computes all
of this with einsums, gathers and scatters outside any Pallas kernel,
and so does the port (cuBLAS and PyTorch's index kernels on the card).
JAX runs the einsum route for any ``moe_impl`` it does not know; the
port raises.

Under tensor parallelism (``tp``, ``dist.tensor_parallel``) each rank
runs every expert on its "mlp" columns: the router reads the residual
input whole (before ``tp.enter``, whose backward sums the experts'
partial input gradients; under ``seq_parallel`` the whole sequence
through ``tp.router_input``), so every rank routes, drops and weighs
alike; the gates' gradient is summed over ranks (``tp.gates``), and one
``tp.exit`` adds the ranks' partial outputs after the combine.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import MOE_IMPLS, ModelConfig
from repro_torch.models.common import ParamFactory
from repro_torch.models.layers import _act


def moe_init(f: ParamFactory, cfg: ModelConfig, name: str = "moe"):
    m = f.child(name)
    e, d, dff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    m.param("w_router", (d, e), ("embed", None))
    m.param("w_gate", (e, d, dff), ("expert", "embed", "mlp"))
    m.param("w_up", (e, d, dff), ("expert", "embed", "mlp"))
    m.param("w_down", (e, dff, d), ("expert", "mlp", "embed"))


def _capacity(cfg: ModelConfig, group: int) -> int:
    mc = cfg.moe
    c = int(mc.top_k * group / mc.n_experts * mc.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _group(cfg: ModelConfig, x):
    """(B, S, d) -> ((G, g, d), g): groups of g tokens in (batch, seq)
    order, g the largest of dispatch_group, halved, that divides B * S."""
    B, S, d = x.shape
    T = B * S
    g = min(cfg.moe.dispatch_group, T)
    while T % g:
        g //= 2
    return x.reshape(T // g, g, d), g


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last dim, largest
    first and, among equal values, the lowest index first (JAX's
    ``lax.top_k``; ``torch.topk`` leaves that order open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, cfg: ModelConfig, xg):
    """xg (G, g, d) -> gates (G, g, k) f32, expert ids (G, g, k), the aux
    load-balancing loss (a 0-dim f32). The logits come from a product in
    xg's dtype, then f32."""
    mc = cfg.moe
    logits = (xg @ p["w_router"].to(xg.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                    # (G, g, E)
    gates, idx = _top_k(probs, mc.top_k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    experts = torch.arange(mc.n_experts, device=xg.device)
    first = (idx[..., 0, None] == experts).to(torch.float32)
    density = torch.mean(first, dim=(0, 1))
    density_proxy = torch.mean(probs, dim=(0, 1))
    aux = (mc.n_experts * torch.sum(density * density_proxy)
           * mc.aux_loss_weight)
    return gates, idx, aux


def _expert_ffn(p, cfg: ModelConfig, xe):
    """xe (G, E, C, d) -> (G, E, C, d): each expert's gated MLP on its
    C rows."""
    act = _act(cfg.act)
    h = act(torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(xe.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(xe.dtype))
    return torch.einsum("gecf,efd->gecd", h, p["w_down"].to(xe.dtype))


def _route(p, cfg: ModelConfig, x, tp):
    """(the dispatch's groups (G, g, d) of x, g, gates, expert ids, aux,
    the (B, S) the groups were cut from); under ``tp`` the groups of
    ``tp.enter(x)`` and the router on ``tp.router_input(x)``."""
    xr = x
    if tp is not None:
        xr, x = tp.router_input(x), tp.enter(x)
    xg, g = _group(cfg, x)
    gates, idx, aux = _router(p, cfg, _group(cfg, xr)[0])
    if tp is not None:
        gates = tp.gates(gates)
    return xg, g, gates, idx, aux, x.shape[:2]


def _out(y, shape, tp):
    """The combined (G, g, d) output as (B, S, d) (under ``tp`` the
    ranks' partial sums added by ``tp.exit``)."""
    y = y.reshape(*shape, -1)
    return y if tp is None else tp.exit(y)


def moe_apply_einsum(p, cfg: ModelConfig, x, tp=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense grouped capacity dispatch. x (B, S, d) -> (y, aux)."""
    mc = cfg.moe
    xg, g, gates, idx, aux, shape = _route(p, cfg, x, tp)
    G, d = xg.shape[0], xg.shape[2]
    C = _capacity(cfg, g)
    E, k = mc.n_experts, mc.top_k
    experts = torch.arange(E, device=x.device)
    onehot = (idx[..., None] == experts).to(torch.float32)   # (G, g, k, E)
    # each assignment's rank within its expert, in (token, k) order
    pos = torch.cumsum(onehot.reshape(G, g * k, E), dim=1) - 1.0
    pos = torch.sum(pos.reshape(G, g, k, E) * onehot, dim=-1)  # (G, g, k)
    keep = (pos < C).to(torch.float32)
    # a rank >= C has no column: its one-hot row is zero, as JAX's
    pos_oh = (pos.to(torch.int64)[..., None]
              == torch.arange(C, device=x.device)).to(torch.float32)
    # JAX's three-operand einsums, contracted pairwise so that no
    # (G, g, k, E, C) intermediate forms; every product has at most one
    # nonzero term (the k experts of a token are distinct), so each
    # element is JAX's exactly
    dispatch = torch.einsum("Gtke,Gtkc->Gtec", onehot * keep[..., None],
                            pos_oh)
    combine = dispatch * torch.einsum("Gtk,Gtke->Gte", gates,
                                      onehot)[..., None]
    xe = torch.einsum("Gtec,Gtd->Gecd", dispatch.to(x.dtype), xg)
    ye = _expert_ffn(p, cfg, xe)
    y = torch.einsum("Gtec,Gecd->Gtd", combine.to(x.dtype), ye)
    return _out(y, shape, tp), aux


def moe_apply_gather(p, cfg: ModelConfig, x, tp=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter/gather routing, no dispatch products. x (B, S, d) ->
    (y, aux).

    JAX scatters each kept assignment's token id into its slot with
    ``.at[...].set(..., mode="drop")``, the dropped ones at the index
    E * C, out of range; here they land in an extra last slot that is
    cut off. Empty slots gather token 0 and are combined into nothing,
    so their gradient is 0. The combine adds each token's k weighted
    expert outputs to a zero row (``index_add_``, atomics on CUDA): with
    k = 2 two addends from zero, whose sum does not depend on their
    order."""
    mc = cfg.moe
    xg, g, gates, idx, aux, shape = _route(p, cfg, x, tp)
    G, d = xg.shape[0], xg.shape[2]
    C = _capacity(cfg, g)
    E, k = mc.n_experts, mc.top_k
    dev = x.device
    flat_e = idx.reshape(G, g * k)                  # expert per assignment
    flat_g = gates.reshape(G, g * k)
    flat_t = torch.arange(g, device=dev).repeat_interleave(k)   # (g * k,)
    onehot = (flat_e[..., None] == torch.arange(E, device=dev)).to(
        torch.int32)
    rank = torch.cumsum(onehot, dim=1) - 1
    rank = torch.gather(rank, 2, flat_e[..., None])[..., 0]
    keep = rank < C
    slot = flat_e * C + torch.clamp(rank, max=C - 1)         # (G, g * k)
    target = torch.where(keep, slot, E * C)
    slot_token = torch.zeros((G, E * C + 1), dtype=torch.int64, device=dev)
    slot_token.scatter_(1, target, flat_t.expand(G, g * k).contiguous())
    slot_token = slot_token[:, :E * C]
    xe = torch.gather(xg, 1, slot_token[..., None].expand(G, E * C, d))
    ye = _expert_ffn(p, cfg, xe.reshape(G, E, C, d)).reshape(G, E * C, d)
    contrib = torch.gather(ye, 1, slot[..., None].expand(G, g * k, d))
    contrib = contrib * (flat_g * keep)[..., None].to(ye.dtype)
    rows = (torch.arange(G, device=dev)[:, None] * g + flat_t).reshape(-1)
    y = torch.zeros((G * g, d), dtype=ye.dtype, device=dev).index_add_(
        0, rows, contrib.reshape(G * g * k, d))
    return _out(y, shape, tp), aux


def check_moe_impl(cfg: ModelConfig) -> None:
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}; expected one "
                         f"of {MOE_IMPLS}")


def moe_apply(p, cfg: ModelConfig, x, tp=None):
    """x (B, S, d) -> (y, aux) by ``cfg.moe_impl``'s route; under ``tp``
    x and y are the rank's sequence block under ``seq_parallel``."""
    check_moe_impl(cfg)
    if cfg.moe_impl == "gather":
        return moe_apply_gather(p, cfg, x, tp)
    return moe_apply_einsum(p, cfg, x, tp)
