"""xLSTM blocks of the port (``repro/models/xlstm.py``): the mLSTM
(matrix memory, chunk-parallel) and the sLSTM (scalar memory, strictly
recurrent), per arXiv:2405.04517.

The mLSTM is a gated linear-attention recurrence
    C_t = f_t C_{t-1} + i_t k_t v_t^T,   n_t = f_t n_{t-1} + i_t k_t,
    h_t = (C_t^T q_t) / max(|n_t^T q_t|, exp(-m_t))
with exponential input gates stabilised by a running max ``m``. Training
runs the chunkwise-parallel form: quadratic within a chunk, the
stabilised (C, n, m) carry across chunks in a Python loop (JAX's
``lax.scan``). Decoding runs the O(1) recurrence. The sLSTM has no
parallel form: a loop over time with block-diagonal recurrent weights.

JAX computes both outside Pallas, so the port computes them in PyTorch
ops (cuBLAS and elementwise kernels on the card). The rounding points
are JAX's: under bf16 compute the intra-chunk weights are cast to v's
dtype before their product with v, the carried C and n and the inter-
chunk weights to q's; the gates and the carry stay f32. JAX's
three-operand einsums are contracted pairwise in one fixed order (the
gate weights first), which moves an f32 result by its summation order
only.

Two head dims: the mLSTM's is ``d_in // n_heads`` (``mlstm_dims``), the
sLSTM's ``d_model // n_heads`` (``slstm_dims``); neither is the
config's ``head_dim``.

Under tensor parallelism (``tp``, ``dist.tensor_parallel``) a rank of M
runs nh/M of the mLSTM's heads and nh/M of the sLSTM's. ``xlstm_spec``
is the one description of the cut, which the init hook, both of
``core.ambdg``'s bridges, the checkpoints and ``launch.wire_model``
read; it departs from JAX's train-profile specs, whose contiguous
``model`` blocks straddle what a head needs:

  * mLSTM ``w_up`` (d, 2 d_in) is [a | gate] on "mlp": JAX's block gives
    rank 0 of 2 all of ``a`` and rank 1 all of ``gate``; here a rank
    holds its block of each (a ``Segments``). Every head's q, k, v and
    gates read all of ``a``, so the rank's block of ``a`` is gathered
    along the features (``tp.gather_features``: forward an all-gather,
    backward a reduce-scatter), rather than every rank computing ``a``
    whole and summing ``w_up``'s gradient;
  * mLSTM ``w_q``, ``w_k``, ``w_v`` (d_in, d_in; "mlp", "heads") and
    ``w_i``, ``w_f`` (d_in, nh; "mlp", None): JAX's resolver gives
    ``model`` to the input dim; here the output dim (the rank's head
    columns) is cut;
  * sLSTM ``w_x`` (d, 4d) and ``b`` (4d) are laid out gate-major, (4,
    nh, hd): a rank holds its heads' block of each gate (four split
    parts of a ``Segments``) where JAX's block would hold whole gates;
  * sLSTM ``w_ff_gate``, ``w_ff_up``, ``w_ff_down`` stay whole: the FFN
    width int(4/3 d) is odd in both configs (1023, 85), where JAX's
    resolver keeps them whole too (for an even width JAX would cut
    "mlp"; the port still keeps them whole);
  * JAX's whole ``b_i``, ``b_f`` and ``w_h`` are sliced to the rank's
    heads (their gradient summed over the ranks, ``tp.whole_param``);
    ``norm_scale`` and ``w_down`` keep JAX's contiguous block (y is
    head-major), the norm's sum of squares over the whole d_in summed
    over the ranks (``tp.sum``).

The sLSTM's recurrence leaves its output in head blocks; its FFN reads
the whole width, so the output is gathered whole
(``tp.whole_features``; every rank then computes the FFN alike and its
output needs no reduce, and the gather's backward keeps the rank's own
block). ``seq_parallel`` is refused at ``model > 1`` by the training
forward (``tensor_parallel.check_model_axis``); such a config still
decodes and serves, one token a step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamFactory
from repro_torch.models.layers import rmsnorm
from repro_torch.models.ssm import _silu

NEG_INF = -1e30
SLSTM_M0 = -30.0      # the sLSTM stabiliser's initial value (JAX's)


def n_blocks(cfg: ModelConfig):
    """(mLSTM blocks, sLSTM blocks): layer i is sLSTM iff (i + 1) %
    slstm_every == 0."""
    n_sl = cfg.n_layers // cfg.xlstm.slstm_every
    return cfg.n_layers - n_sl, n_sl


def is_slstm(cfg: ModelConfig, i: int) -> bool:
    return (i + 1) % cfg.xlstm.slstm_every == 0


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    nh = cfg.n_heads
    return d_in, nh, d_in // nh


def xlstm_spec(cfg: ModelConfig, name: str, ndim: int):
    """The tensor-parallel cut of the xLSTM leaf ``name`` (``ndim`` dims)
    where it departs from JAX's train-profile spec (the module's
    docstring): a ``tensor_parallel.Segments`` of the last dim, a
    ``Spec`` (the last dim cut, or whole), or None for JAX's own."""
    from repro_torch.dist.sharding import Spec
    from repro_torch.dist.tensor_parallel import Segments
    d, d_in = cfg.d_model, mlstm_dims(cfg)[0]
    if name == "w_up":
        return Segments(ndim - 1, ((0, d_in, True), (d_in, d_in, True)))
    if name in ("w_q", "w_k", "w_v", "w_i", "w_f"):
        return Spec(*(None,) * (ndim - 1), "model")
    if name in ("w_x", "b"):
        return Segments(ndim - 1, tuple((g * d, d, True) for g in range(4)))
    if name in ("b_i", "b_f", "w_h", "w_ff_gate", "w_ff_up", "w_ff_down"):
        return Spec()
    return None


def mlstm_init(f: ParamFactory, cfg: ModelConfig, name: str = "mlstm"):
    d = cfg.d_model
    d_in, nh, _ = mlstm_dims(cfg)
    m = f.child(name)
    m.param("w_up", (d, 2 * d_in), ("embed", "mlp"))
    m.param("w_q", (d_in, d_in), ("mlp", "heads"))
    m.param("w_k", (d_in, d_in), ("mlp", "heads"))
    m.param("w_v", (d_in, d_in), ("mlp", "heads"))
    m.param("w_i", (d_in, nh), ("mlp", None))   # input gate pre-activations
    m.param("w_f", (d_in, nh), ("mlp", None))   # forget gate pre-activations
    m.param("b_i", (nh,), (None,), init="zeros")
    m.param("b_f", (nh,), (None,), init="ones")
    m.param("norm_scale", (d_in,), ("mlp",), init="ones")
    m.param("w_down", (d_in, d), ("mlp", "embed"))


def _mlstm_chunk(q, k, v, logf, logi, carry):
    """One chunk, stabilised. q, k, v (B, nh, L, hd); logf, logi (B, nh,
    L) f32; carry = (C (B, nh, hd, hd), n (B, nh, hd), m (B, nh)), f32.
    Returns (y (B, nh, L, hd) f32, the carry after the chunk)."""
    C_st, n_st, m_st = carry
    L, hd = q.shape[2], q.shape[3]
    lf = torch.cumsum(logf, dim=-1)                      # inclusive
    Fsum = lf[..., -1]                                   # (B, nh)

    # intra-chunk log weights: D~_ij = lf_i - lf_j + logi_j, i >= j
    Dt = lf[..., :, None] - lf[..., None, :] + logi[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    Dt = torch.where(mask, Dt, torch.full((), NEG_INF, device=q.device))
    inter_log = lf + m_st[..., None]                     # (B, nh, L)
    m_row = torch.maximum(torch.amax(Dt, dim=-1), inter_log)

    S = torch.exp(Dt - m_row[..., None])                 # (B, nh, L, L)
    qk = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) / (hd ** 0.5)
    num_intra = torch.matmul((S * qk).to(v.dtype), v)
    # normaliser: n_i = sum_j decay_ij i_j k_j; the denominator is q_i . n_i
    den_intra = torch.sum(S * qk, dim=-1)                # (B, nh, L)

    w_inter = torch.exp(inter_log - m_row)               # (B, nh, L)
    num_inter = torch.matmul(q, C_st.to(q.dtype))
    num_inter = num_inter * w_inter[..., None].to(q.dtype) / (hd ** 0.5)
    den_inter = torch.matmul(q, n_st.to(q.dtype)[..., None])[..., 0] \
        / (hd ** 0.5)
    den_inter = den_inter * w_inter

    num = num_intra.to(torch.float32) + num_inter.to(torch.float32)
    den = den_intra + den_inter
    denom = torch.maximum(torch.abs(den), torch.exp(-m_row))
    y = num / denom[..., None]

    # carry: token j's weight surviving to the chunk's end is
    # F - lf_j + logi_j
    w_end_log = Fsum[..., None] - lf + logi              # (B, nh, L)
    m_new = torch.maximum(m_st + Fsum, torch.amax(w_end_log, dim=-1))
    w_end = torch.exp(w_end_log - m_new[..., None])
    decay = torch.exp(m_st + Fsum - m_new)
    k32, v32 = k.to(torch.float32), v.to(torch.float32)
    kw = k32 * w_end[..., None]                          # (B, nh, L, hd)
    C_new = (C_st * decay[..., None, None]
             + torch.matmul(kw.transpose(-1, -2), v32))
    n_new = n_st * decay[..., None] + torch.sum(kw, dim=-2)
    return y, (C_new, n_new, m_new)


def mlstm_sequence(q, k, v, logf, logi, chunk: int):
    """q, k, v (B, S, nh, hd); gates (B, S, nh) f32. Returns y (B, S, nh,
    hd) f32. S must be a multiple of min(chunk, S)."""
    B, S, nh, hd = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    carry = (torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                         device=q.device),
             torch.zeros((B, nh, hd), dtype=torch.float32, device=q.device),
             torch.full((B, nh), NEG_INF, dtype=torch.float32,
                        device=q.device))
    heads_first = lambda x: x.transpose(1, 2)            # (B, nh, S, ...)
    qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
    fh, ih = heads_first(logf), heads_first(logi)
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        y, carry = _mlstm_chunk(qh[:, :, sl], kh[:, :, sl], vh[:, :, sl],
                                fh[:, :, sl], ih[:, :, sl], carry)
        ys.append(y)
    return torch.cat(ys, dim=2).transpose(1, 2)


def _mlstm_proj(p, cfg: ModelConfig, x, tp=None):
    """x (B, S, d) -> q, k, v (B, S, nh, hd) in x's dtype, logi and logf
    (B, S, nh) f32 (logf the log-sigmoid of the forget pre-activation),
    and the output gate's pre-activation (B, S, d_in); under ``tp`` the
    rank's heads and its block of the gate."""
    d_in, nh, hd = mlstm_dims(cfg)
    B, S, _ = x.shape
    if tp is not None:
        p = dict(p, b_i=tp.rank_heads(p["b_i"]), b_f=tp.rank_heads(p["b_f"]))
        d_in, nh = d_in // tp.ax.n, nh // tp.ax.n
    up = x @ p["w_up"].to(x.dtype)
    a, gate = up[..., :d_in], up[..., d_in:]
    if tp is not None:
        a = tp.gather_features(a)
    q = (a @ p["w_q"].to(x.dtype)).reshape(B, S, nh, hd)
    k = (a @ p["w_k"].to(x.dtype)).reshape(B, S, nh, hd)
    v = (a @ p["w_v"].to(x.dtype)).reshape(B, S, nh, hd)
    logi = (a @ p["w_i"].to(x.dtype)).to(torch.float32) + p["b_i"]
    logf = F.logsigmoid((a @ p["w_f"].to(x.dtype)).to(torch.float32)
                        + p["b_f"])
    return q, k, v, logi, logf, gate


def _mlstm_out(p, cfg: ModelConfig, y, gate, x, tp=None):
    """The normed, gated read-out y (B, S, d_in) -> (B, S, d); under
    ``tp`` y is the rank's block, the norm spans every rank's and the
    rank's partial product is summed (``tp.exit``)."""
    y = y.to(x.dtype)
    if tp is None:
        y = rmsnorm(y, p["norm_scale"], cfg.norm_eps)
    else:
        # rmsnorm over the whole d_in: the ranks' sums of squares added
        var = tp.sum(torch.sum(torch.square(y).to(torch.float32), dim=-1,
                               keepdim=True)) / mlstm_dims(cfg)[0]
        y = y * torch.rsqrt(var + cfg.norm_eps).to(y.dtype) \
            * p["norm_scale"].to(y.dtype)
    y = y * _silu(gate)
    out = y @ p["w_down"].to(x.dtype)
    return out if tp is None else tp.exit(out)


def mlstm_block_apply(p, cfg: ModelConfig, x, tp=None):
    """x (B, S, d) -> (B, S, d): the up-projection, the mLSTM path and
    the gate path; under ``tp`` on the rank's heads."""
    B, S, _ = x.shape
    if tp is not None:
        x = tp.enter(x)
    q, k, v, logi, logf, gate = _mlstm_proj(p, cfg, x, tp)
    y = mlstm_sequence(q, k, v, logf, logi, cfg.xlstm.conv_width * 64)
    return _mlstm_out(p, cfg, y.reshape(B, S, -1), gate, x, tp)


def mlstm_state_init(cfg: ModelConfig, n_layers: int, batch: int,
                     device="cpu", tp=None):
    """The stacked decode state, f32: C (n_layers, B, nh, hd, hd) and n
    (n_layers, B, nh, hd) zeros, m (n_layers, B, nh) at NEG_INF; under
    ``tp`` the rank's nh / M heads."""
    _, nh, hd = mlstm_dims(cfg)
    lead = (n_layers, batch, nh if tp is None else nh // tp.ax.n)
    return {
        "C": torch.zeros(lead + (hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros(lead + (hd,), dtype=torch.float32, device=device),
        "m": torch.full(lead, NEG_INF, dtype=torch.float32, device=device),
    }


def mlstm_block_decode(p, cfg: ModelConfig, x, state, tp=None):
    """One token. x (B, 1, d); state {"C", "n", "m"}, one layer's views
    into the stacked state, overwritten with the new state (JAX returns
    it). Under ``tp`` the rank's heads (its block of the state), the
    up-projection's ``a`` gathered along the features, the norm spanning
    every rank's heads and the down-projection's parts summed. Returns
    (y (B, 1, d), state)."""
    d_in, nh, hd = mlstm_dims(cfg)
    B = x.shape[0]
    if x.shape[1] != 1:
        raise ValueError(f"mlstm_block_decode takes one token, got "
                         f"{x.shape[1]}")
    if tp is not None:
        d_in, nh = d_in // tp.ax.n, nh // tp.ax.n
        x = tp.enter(x)
    q, k, v, logi, logf, gate = _mlstm_proj(p, cfg, x, tp)
    q, k, v = (t.reshape(B, nh, hd) for t in (q, k, v))
    logi, logf = logi.reshape(B, nh), logf.reshape(B, nh)
    C_st, n_st, m_st = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf + m_st, logi)
    f_w = torch.exp(logf + m_st - m_new)
    i_w = torch.exp(logi - m_new)
    k32, v32 = k.to(torch.float32), v.to(torch.float32)
    ki = k32 * i_w[..., None]
    C_new = C_st * f_w[..., None, None] + ki[..., :, None] * v32[..., None, :]
    n_new = n_st * f_w[..., None] + ki
    qs = q.to(torch.float32) / (hd ** 0.5)
    num = torch.matmul(qs[..., None, :], C_new)[..., 0, :]      # (B, nh, hd)
    den = torch.maximum(torch.abs(torch.sum(qs * n_new, dim=-1)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, d_in)
    state["C"].copy_(C_new)
    state["n"].copy_(n_new)
    state["m"].copy_(m_new)
    return _mlstm_out(p, cfg, y, gate, x, tp), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_dims(cfg: ModelConfig):
    nh = cfg.n_heads
    return nh, cfg.d_model // nh, int(cfg.xlstm.proj_factor_slstm
                                      * cfg.d_model)


def slstm_init(f: ParamFactory, cfg: ModelConfig, name: str = "slstm"):
    d = cfg.d_model
    nh, hd, d_ff = slstm_dims(cfg)
    m = f.child(name)
    # 4 gates (z, i, f, o): input weights (d, 4d), block-diagonal R
    m.param("w_x", (d, 4 * d), ("embed", "mlp"))
    m.param("w_h", (nh, hd, 4 * hd), (None, None, None))
    m.param("b", (4 * d,), ("mlp",), init="zeros")
    # the gated FFN after the recurrence
    m.param("w_ff_gate", (d, d_ff), ("embed", "mlp"))
    m.param("w_ff_up", (d, d_ff), ("embed", "mlp"))
    m.param("w_ff_down", (d_ff, d), ("mlp", "embed"))


def slstm_state_init(cfg: ModelConfig, n_layers: int, batch: int,
                     device="cpu", tp=None):
    """The stacked decode state, f32, each (n_layers, B, nh, hd): h, c
    and n zeros, m at SLSTM_M0; under ``tp`` the rank's nh / M heads."""
    nh, hd, _ = slstm_dims(cfg)
    shape = (n_layers, batch, nh if tp is None else nh // tp.ax.n, hd)
    state = {k: torch.zeros(shape, dtype=torch.float32, device=device)
             for k in ("h", "c", "n")}
    state["m"] = torch.full(shape, SLSTM_M0, dtype=torch.float32,
                            device=device)
    return state


def slstm_zero_state(cfg: ModelConfig, batch: int, device="cpu"):
    """(h, c, n, m), each (B, nh, hd) f32: zeros, m at SLSTM_M0."""
    return tuple(v[0] for v in slstm_state_init(cfg, 1, batch,
                                                device).values())


def state_axes():
    """The logical axes of the decode state ``transformer`` stacks:
    {"mlstm": {"C", "n", "m"}, "slstm": {"h", "c", "n", "m"}}."""
    laxes = ("layers", "batch", "heads", None)
    return {"mlstm": {"C": ("layers", "batch", "heads", None, None),
                      "n": laxes, "m": ("layers", "batch", "heads")},
            "slstm": {k: laxes for k in ("h", "c", "n", "m")}}


def slstm_scan(p, cfg: ModelConfig, x, init_state=None, tp=None):
    """The strict recurrence over time. x (B, S, d). The input gates are
    laid out gate-major over the whole width, (B, S, 4, nh, hd); the
    recurrent ones head-major, (B, nh, 4, hd), as in JAX. Returns (y
    (B, S, d) in x's dtype, the final (h, c, n, m)). Under ``tp`` the
    rank's nh/M heads: y (B, S, d/M), the state (B, nh/M, hd)."""
    B, S, _ = x.shape
    nh, hd, _ = slstm_dims(cfg)
    if tp is not None:
        p = dict(p, w_h=tp.rank_heads(p["w_h"]))
        nh //= tp.ax.n
    # the bias is added in the compute dtype, as in JAX
    xg = (x @ p["w_x"].to(x.dtype) + p["b"].to(x.dtype)).reshape(
        B, S, 4, nh, hd)
    if init_state is None:
        init_state = tuple(v[:, :nh] for v in
                           slstm_zero_state(cfg, B, x.device))
    h, c, n, m = init_state
    w_h = p["w_h"].to(torch.float32)                     # (nh, hd, 4 hd)
    # JAX casts each step's slice to f32: the same values, cast at once
    xg = xg.to(torch.float32)
    hs = []
    for t in range(S):
        rec = torch.matmul(h.transpose(0, 1), w_h)       # (nh, B, 4 hd)
        rec = rec.reshape(nh, B, 4, hd).permute(1, 2, 0, 3)   # (B, 4, nh, hd)
        pre = xg[:, t] + rec
        z = torch.tanh(pre[:, 0])
        i_pre, f_pre, o_pre = pre[:, 1], pre[:, 2], pre[:, 3]
        log_f = F.logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_w = torch.exp(i_pre - m_new)
        f_w = torch.exp(log_f + m - m_new)
        c = f_w * c + i_w * z
        n = f_w * n + i_w
        h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, nh * hd).to(x.dtype)
    return y, (h, c, n, m)


def slstm_block_apply(p, cfg: ModelConfig, x, init_state=None, tp=None):
    """The recurrence, then the gated FFN (tanh GELU whatever ``cfg.act``
    says: JAX's ``jax.nn.gelu`` default). Returns (y, the final state).
    Under ``tp`` the recurrence runs the rank's heads and its output is
    gathered whole for the FFN, which every rank computes alike."""
    if tp is not None:
        x = tp.enter(x)
    y, state = slstm_scan(p, cfg, x, init_state, tp)
    if tp is not None:
        y = tp.whole_features(y)
    act = F.gelu(y @ p["w_ff_gate"].to(x.dtype), approximate="tanh")
    h = act * (y @ p["w_ff_up"].to(x.dtype))
    return h @ p["w_ff_down"].to(x.dtype), state
