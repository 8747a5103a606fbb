"""Mamba2 (SSD, state-space duality) block of the port
(``repro/models/ssm.py``): the training path and the decode recurrence.

Training uses the chunked SSD algorithm: within a chunk the output is a
masked, decay-weighted attention-like product; across chunks a small
(nh, hd, d_state) state is carried. ``cfg.scan_impl`` picks how:
"xla" is ``ssd_chunked``, the JAX model's computation, in plain
PyTorch; "kernel" is ``kernels.linear_scan.ops.ssd_mamba2``, the port's
CUDA scan kernel on CUDA tensors (its plain recurrence on CPU tensors),
which the JAX package keeps beside its model as the TPU target. The
rounding points follow the JAX code. Decoding runs the O(1)
recurrence one token at a time (``mamba2_decode``) against a stacked
state it updates in place.

Shapes follow the Mamba2 paper: input (B, S, d_model), inner dim
d_in = expand * d, nh = d_in / head_dim heads, n_groups shared B/C
groups.

Under tensor parallelism (``tp``, ``dist.tensor_parallel``) a rank runs
its nh / M heads: its blocks of the z, x and dt columns of ``w_in`` and
of the x channels of the conv, with the B and C columns whole
(``tensor_parallel.Segments``; their gradient, like that of ``a_log``,
``dt_bias`` and ``d_skip``, which it slices to its heads, summed over
the ranks), the scan on its heads, the gated norm's sum of squares
summed over the ranks (``tp.sum``), and ``w_out`` row-parallel; the
decode the same on the rank's block of the state (its heads of ``ssm``,
the ``conv`` state cut as ``w_conv``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.linear_scan.ops import ssd_mamba2
from repro_torch.models.common import ParamFactory

SCAN_IMPLS = ("xla", "kernel")


def mamba2_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim


def mamba2_init(f: ParamFactory, cfg: ModelConfig, name: str = "mamba"):
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh = mamba2_dims(cfg)
    m = f.child(name)
    # fused input projection -> [z, x, B, C, dt]
    m.param("w_in", (d, 2 * d_in + 2 * s.n_groups * s.d_state + nh),
            ("embed", "mlp"))
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    m.param("w_conv", (s.d_conv, conv_dim), (None, "mlp"))
    m.param("b_conv", (conv_dim,), ("mlp",), init="zeros")
    m.param("a_log", (nh,), (None,), init="ones")
    m.param("dt_bias", (nh,), (None,), init="zeros")
    m.param("d_skip", (nh,), (None,), init="ones")
    m.param("norm_scale", (d_in,), ("mlp",), init="ones")
    m.param("w_out", (d_in, d), ("mlp", "embed"))


def _silu(x):
    """jax.nn.silu's form, x * sigmoid(x): in bf16 the sigmoid rounds
    before the product, as in JAX."""
    return x * torch.sigmoid(x)


def _softplus(x):
    """jax.nn.softplus's form, logaddexp(x, 0)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _split_proj(p, cfg: ModelConfig, u, dims=None):
    """u (B, S, d) -> z (B, S, d_in), xBC (B, S, conv_dim), dt (B, S, nh)
    (``dims``: a rank's (d_in, nh), default the whole block's)."""
    s = cfg.ssm
    d_in, nh = dims or mamba2_dims(cfg)
    proj = u @ p["w_in"].to(u.dtype)
    z = proj[..., :d_in]
    xBC = proj[..., d_in:d_in + d_in + 2 * s.n_groups * s.d_state]
    dt = proj[..., -nh:]
    return z, xBC, dt


def _causal_conv(p, xBC, conv_state=None):
    """Depthwise causal conv of width d_conv over xBC (B, S, C), then
    silu; the taps are summed in JAX's order. With ``conv_state``
    (B, d_conv - 1, C), the decode path, the state is put in front of
    xBC in place of the zero padding. Returns (out, the last d_conv - 1
    inputs: the next state, in xBC's dtype)."""
    w = p["w_conv"].to(xBC.dtype)                  # (W, C)
    W, S = w.shape[0], xBC.shape[1]
    if conv_state is not None:
        xpad = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    else:
        xpad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(xpad[:, i:i + S, :] * w[i] for i in range(W))
    return _silu(out + p["b_conv"].to(xBC.dtype)), xpad[:, -(W - 1):, :]


def _gated_norm(p, y, z, eps, tp=None, d_in=None):
    """RMSNorm of y * silu(z) over the inner dim; under ``tp`` over the
    whole ``d_in`` of every rank's columns."""
    y = y * _silu(z)
    dtype = y.dtype
    y32 = y.to(torch.float32)
    if tp is None:
        var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    else:
        var = tp.sum(torch.sum(torch.square(y32), dim=-1,
                               keepdim=True)) / d_in
    y32 = y32 * torch.rsqrt(var + eps)
    return (y32 * p["norm_scale"].to(torch.float32)).to(dtype)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan, the JAX model's (``ssd_chunked``).

    x (Bt, S, nh, hd); dt (Bt, S, nh) post-softplus; A (nh,) negative
    decay rates; B, C (Bt, S, g, d_state). Returns y (Bt, S, nh, hd) in
    x's dtype and the final state (Bt, nh, hd, d_state) f32."""
    Bt, S, nh, hd = x.shape
    g = B.shape[2]
    rep = nh // g
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk

    xc = x.reshape(Bt, nc, chunk, nh, hd)
    dtc = dt.reshape(Bt, nc, chunk, nh)
    Bc = B.reshape(Bt, nc, chunk, g, -1)
    Cc = C.reshape(Bt, nc, chunk, g, -1)

    dA = dtc * A[None, None, None, :]                      # (Bt,nc,L,nh)
    cum = torch.cumsum(dA, dim=2)                          # running log-decay
    seg_total = cum[:, :, -1, :]                           # (Bt,nc,nh)

    # intra-chunk: y_i += C_i . sum_{j <= i} exp(cum_i - cum_j) dt_j B_j x_j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (Bt,nc,L,L,nh)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # the mask comes BEFORE the exp: the i < j entries are > 0 and would
    # overflow, and exp-then-mask puts inf * 0 = NaN into the gradient
    diff = torch.where(mask[None, None, :, :, None], diff, -torch.inf)
    L = torch.exp(diff)
    CB = torch.einsum("bnigs,bnjgs->bnijg", Cc, Bc)        # (Bt,nc,L,L,g)
    CB = torch.repeat_interleave(CB, rep, dim=-1)          # (Bt,nc,L,L,nh)
    scores = CB * L * dtc[:, :, None, :, :]                # weight by dt_j
    y_diag = torch.einsum("bnijh,bnjhd->bnihd", scores.to(x.dtype), xc)

    # chunk states: the decay-weighted sum of B x within each chunk
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)
    Bfull = torch.repeat_interleave(Bc, rep, dim=3) if g != nh else Bc
    Bx = torch.einsum("bnlhs,bnlhd->bnhds", Bfull,
                      (xc * (dtc * decay_to_end)[..., None]).to(Bfull.dtype))

    # inter-chunk recurrence over the chunks (small state), f32
    h = torch.zeros((Bt, nh, hd, Bc.shape[-1]), dtype=torch.float32,
                    device=x.device)
    Bx32, seg32 = Bx.to(torch.float32), seg_total.to(torch.float32)
    h_in = []
    for n in range(nc):
        h_in.append(h)                                     # state entering n
        h = h * torch.exp(seg32[:, n])[:, :, None, None] + Bx32[:, n]
    h_in = torch.stack(h_in, dim=1)                        # (Bt,nc,nh,hd,s)

    # inter-chunk contribution: y_i += exp(cum_i) C_i . h_in
    Cfull = torch.repeat_interleave(Cc, rep, dim=3) if g != nh else Cc
    y_off = torch.einsum("bnlhs,bnhds->bnlhd",
                         Cfull * torch.exp(cum)[..., None].to(Cfull.dtype),
                         h_in.to(Cfull.dtype))
    y = (y_diag + y_off.to(y_diag.dtype)).reshape(Bt, S, nh, hd)
    return y, h


def mamba2_segments(cfg: ModelConfig, name: str, ndim: int):
    """The tensor-parallel cut (``tensor_parallel.Segments``, on the
    last of ``ndim`` dims) of the fused leaf ``name``: ``w_in``'s
    columns [z | x | B | C | dt], ``w_conv`` / ``b_conv``'s channels
    [x | B | C]; a rank holds its heads' block of z, x and dt and the B
    and C columns whole."""
    from repro_torch.dist.tensor_parallel import Segments
    d_in, nh = mamba2_dims(cfg)
    bc = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    if name == "w_in":
        return Segments(ndim - 1, ((0, d_in, True), (d_in, d_in, True),
                                   (2 * d_in, bc, False),
                                   (2 * d_in + bc, nh, True)))
    return Segments(ndim - 1, ((0, d_in, True), (d_in, bc, False)))


def _rank_params(p, cfg: ModelConfig, tp):
    """The block's leaves as a rank computes with them: the whole parts
    of the fused leaves (the B and C columns) and the per-head leaves
    through ``tp.whole_param`` (their gradient summed over the ranks),
    the per-head ones sliced to the rank's heads."""
    p = dict(p)
    for name in ("w_in", "w_conv", "b_conv"):
        w = p[name]
        parts = mamba2_segments(cfg, name, w.dim()).local_parts(tp.ax.n)
        p[name] = torch.cat([
            w.narrow(-1, ofs, width) if split
            else tp.whole_param(w.narrow(-1, ofs, width))
            for ofs, width, split in parts], dim=-1)
    for name in ("a_log", "dt_bias", "d_skip"):
        p[name] = tp.rank_heads(p[name])
    return p


def mamba2_apply(p, cfg: ModelConfig, u, tp=None):
    """Full sequence (training). u (B, S, d) -> (B, S, d); under ``tp``
    on the rank's heads (u and the output the rank's sequence block
    under ``seq_parallel``)."""
    s = cfg.ssm
    d_in, nh = mamba2_dims(cfg)
    d_whole = d_in
    if tp is not None:
        p = _rank_params(p, cfg, tp)
        d_in, nh = d_in // tp.ax.n, nh // tp.ax.n
        u = tp.enter(u)
    z, xBC, dt = _split_proj(p, cfg, u, (d_in, nh))
    xBC, _ = _causal_conv(p, xBC)
    x = xBC[..., :d_in]
    Bmat = xBC[..., d_in:d_in + s.n_groups * s.d_state]
    Cmat = xBC[..., d_in + s.n_groups * s.d_state:]
    Bt, S, _ = u.shape
    chunk = min(s.chunk_size, S)
    pad = (-S) % chunk
    if pad:  # to a chunk multiple; the padded steps follow every real one
        x = F.pad(x, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-30.0)
    Sp = S + pad
    x = x.reshape(Bt, Sp, nh, s.head_dim)
    Bmat = Bmat.reshape(Bt, Sp, s.n_groups, s.d_state)
    Cmat = Cmat.reshape(Bt, Sp, s.n_groups, s.d_state)
    dt_act = _softplus(dt.to(torch.float32)
                       + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["a_log"].to(torch.float32))
    if cfg.scan_impl == "kernel":
        # the kernel returns the dtype of x * dt (f32): back to x's, as
        # ssd_chunked returns it
        y = ssd_mamba2(x, dt_act, A, Bmat, Cmat, chunk=chunk).to(x.dtype)
    elif cfg.scan_impl == "xla":
        y, _ = ssd_chunked(x, dt_act, A, Bmat, Cmat, chunk)
    else:
        raise ValueError(f"unknown scan_impl {cfg.scan_impl!r}; expected "
                         f"one of {SCAN_IMPLS}")
    y = y + x * p["d_skip"].to(x.dtype)[None, None, :, None]
    if pad:
        y = y[:, :S]
    y = y.reshape(Bt, S, d_in)
    y = _gated_norm(p, y, z, cfg.norm_eps, tp, d_whole)
    out = y @ p["w_out"].to(u.dtype)
    return out if tp is None else tp.exit(out)


# ---------------------------------------------------------------------------
# Decode (the O(1) recurrence)
# ---------------------------------------------------------------------------
def mamba2_state_init(cfg: ModelConfig, n_layers: int, batch: int,
                      dtype=torch.float32, device="cpu", tp=None):
    """The stacked decode state: "ssm" (n_layers, batch, nh, head_dim,
    d_state) and "conv" (n_layers, batch, d_conv - 1, conv_dim), zeros
    in ``dtype`` (f32, as in JAX); under ``tp`` the rank's nh / M heads
    and its conv channels (its x block, B and C whole: the ``Segments``
    of ``w_conv``)."""
    s = cfg.ssm
    if s is None:
        raise ValueError("the Mamba2 decode state needs an ssm config")
    d_in, nh = mamba2_dims(cfg)
    if tp is not None:
        d_in, nh = d_in // tp.ax.n, nh // tp.ax.n
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        "ssm": torch.zeros((n_layers, batch, nh, s.head_dim, s.d_state),
                           dtype=dtype, device=device),
        "conv": torch.zeros((n_layers, batch, s.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def mamba2_state_axes():
    return {"ssm": ("layers", "batch", "heads", None, None),
            "conv": ("layers", "batch", None, "mlp")}


def mamba2_decode(p, cfg: ModelConfig, u, ssm_state, conv_state, tp=None):
    """One token. u (B, 1, d); ssm_state (B, nh, hd, ds) and conv_state
    (B, d_conv - 1, conv_dim), one layer's views into the stacked state,
    are overwritten with the new state (JAX returns it). The rounding
    points are JAX's: x * dt in the compute dtype, the outer product
    with B and the decay in f32, the read-out with C in the compute
    dtype. Under ``tp`` the rank's heads (the states its blocks: the
    ``ssm`` heads, the ``conv`` state's x block with B and C whole), the
    gated norm's sum of squares summed over the ranks and ``w_out``
    row-parallel. Returns (y, ssm_state, conv_state)."""
    s = cfg.ssm
    if u.shape[1] != 1:
        raise ValueError(f"mamba2_decode takes one token, got {u.shape[1]}")
    d_in, nh = mamba2_dims(cfg)
    d_whole = d_in
    if tp is not None:
        p = _rank_params(p, cfg, tp)
        d_in, nh = d_in // tp.ax.n, nh // tp.ax.n
        u = tp.enter(u)
    gs = s.n_groups * s.d_state
    z, xBC, dt = _split_proj(p, cfg, u, (d_in, nh))
    xBC, new_conv = _causal_conv(p, xBC, conv_state)
    x = xBC[..., :d_in].reshape(-1, nh, s.head_dim)
    Bmat = xBC[..., d_in:d_in + gs].reshape(-1, s.n_groups, s.d_state)
    Cmat = xBC[..., d_in + gs:].reshape(-1, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    Bfull = torch.repeat_interleave(Bmat, rep, dim=1)
    Cfull = torch.repeat_interleave(Cmat, rep, dim=1)
    dt_act = _softplus(dt[:, 0].to(torch.float32)
                       + p["dt_bias"].to(torch.float32))         # (B, nh)
    A = -torch.exp(p["a_log"].to(torch.float32))
    decay = torch.exp(dt_act * A[None, :])                        # (B, nh)
    xdt = (x * dt_act[..., None].to(x.dtype)).to(torch.float32)
    upd = xdt[..., :, None] * Bfull.to(torch.float32)[..., None, :]
    new_ssm = ssm_state * decay[:, :, None, None] + upd
    y = torch.einsum("bhds,bhs->bhd", new_ssm.to(x.dtype), Cfull.to(x.dtype))
    y = y + x * p["d_skip"].to(x.dtype)[None, :, None]
    y = _gated_norm(p, y.reshape(-1, 1, d_in), z, cfg.norm_eps, tp, d_whole)
    ssm_state.copy_(new_ssm)
    conv_state.copy_(new_conv)
    out = y @ p["w_out"].to(u.dtype)
    return (out if tp is None else tp.exit(out)), ssm_state, conv_state
