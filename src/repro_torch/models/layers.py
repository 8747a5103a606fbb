"""Transformer layers of the port (``repro/models/layers.py``): norms,
RoPE (partial for chatglm), GQA attention with the causal,
sliding-window and prefix-LM masks and the logit softcap, the one-token
decode against a KV cache (a rolling buffer of ``sliding_window`` slots
where the config has a window), the gated MLP, the embedding and the
tied or untied head.

Activations are (B, S, ...) as in JAX; attention holds q, k, v as
(B, S, H, D). The rounding points follow the JAX code, which the
comments name where a straightforward port would round elsewhere.
``attention_apply`` honours ``cfg.attn_impl``: "xla" is ``gqa_attend``
(the JAX model's attention, whatever its knob says), "flash" the port's
flash-attention kernels (``kernels.flash_attention``) on CUDA tensors,
their plain version on CPU tensors (the kernels take the causal mask
and the window, or no mask at all for the encoder-decoder's
bidirectional attention; a config with ``prefix_lm`` or
``logit_softcap`` under "flash" raises, as the kernels compute
neither); ``decode_attention`` runs ``gqa_attend`` under either knob,
as JAX's decode does. JAX's
``constrain`` calls are sharding hints and are left out. Past
``_CHUNK_THRESHOLD`` tokens the plain path runs ``gqa_attend`` in exact
q-blocks (``chunked_gqa_attend``), as JAX does, so it never forms the
whole (S, S) score tensor there.

Under tensor parallelism (``tp``, a ``dist.tensor_parallel.
TensorParallel``; every LM family on a mesh with ``model > 1``) the
parameters are the rank's blocks: attention runs the rank's query heads
and the kv heads they group with (sliced from whole kv leaves where the
kv heads do not split), the MLP its "mlp" columns, the head its vocab
block; ``tp.enter`` / ``tp.exit`` carry the activations in and out of
the column- and row-parallel products. The decode does the same against
the rank's block of the KV cache (its kv heads).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamFactory

NEG_INF = -1e30


def scalar(value: float, dtype) -> torch.Tensor:
    """A 0-dim tensor of ``dtype``: multiplying by it rounds the constant
    to ``dtype`` first, as JAX does with a weakly typed Python scalar."""
    return torch.tensor(value, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(f: ParamFactory, name: str, dim: int):
    f.param(name, (dim,), ("embed",), init="ones")


def rmsnorm(x, scale, eps: float):
    # the square is taken in x's dtype and only then cast to f32, as in
    # JAX (cast-then-square is another number in bf16)
    var = torch.mean(torch.square(x).to(torch.float32), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def head_rmsnorm(x, scale, eps: float):
    """Per-head qk-norm (qwen3): x (..., n_heads, head_dim), in f32."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, partial: float, theta: float, device):
    rot = int(head_dim * partial)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device)
                 ** exps)
    return inv, rot


def apply_rope(x, positions, theta: float, partial: float = 1.0):
    """x: (B, S, H, D); positions: (B, S). Rotates the first
    ``partial * D`` dims in f32 (rotate-half); chatglm's "2d RoPE" is
    partial = 0.5."""
    inv, rot = rope_frequencies(x.shape[-1], partial, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].to(torch.float32) * inv      # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = torch.chunk(x_rot.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------
def causal_mask(q_len: int, kv_len: int, device=None, *,
                window: Optional[int] = None, q_offset: int = 0):
    """(q_len, kv_len) bool, True = attend; ``q_offset`` shifts the query
    positions (a q-block of chunked attention). With ``window`` a query
    attends only to the ``window`` latest positions up to its own."""
    q_pos = torch.arange(q_len, device=device) + q_offset
    kv_pos = torch.arange(kv_len, device=device)
    m = q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - kv_pos[None, :]) < window
    return m


def prefix_lm_mask(q_len: int, kv_len: int, prefix_len: int, device=None,
                   q_offset: int = 0):
    """Bidirectional over the first ``prefix_len`` positions, causal
    after (no window, as in JAX)."""
    base = causal_mask(q_len, kv_len, device, q_offset=q_offset)
    in_prefix = torch.arange(kv_len, device=device)[None, :] < prefix_len
    return base | in_prefix


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def attention_init(f: ParamFactory, cfg: ModelConfig, name: str = "attn"):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    a = f.child(name)
    a.param("wq", (d, cfg.n_heads * hd), ("embed", "heads"))
    a.param("wk", (d, cfg.n_kv_heads * hd), ("embed", "heads"))
    a.param("wv", (d, cfg.n_kv_heads * hd), ("embed", "heads"))
    a.param("wo", (cfg.n_heads * hd, d), ("heads", "embed"))
    if cfg.qkv_bias:
        a.param("bq", (cfg.n_heads * hd,), ("heads",), init="zeros")
        a.param("bk", (cfg.n_kv_heads * hd,), ("heads",), init="zeros")
        a.param("bv", (cfg.n_kv_heads * hd,), ("heads",), init="zeros")
    if cfg.qk_norm:
        a.param("q_norm", (hd,), (None,), init="ones")
        a.param("k_norm", (hd,), (None,), init="ones")


def rank_kv(p, cfg: ModelConfig, tp):
    """(the attention leaves ``p`` as the rank under ``tp`` computes
    with them, the rank's query heads, its kv heads). Where the kv heads
    do not split over the ranks, its kv head's columns are sliced from
    the whole kv leaves (their gradient summed over the ranks)."""
    from repro_torch.dist.tensor_parallel import local_heads
    hd = cfg.resolved_head_dim
    n_q, kv0, n_kv, whole = local_heads(cfg, tp.ax)
    if whole:
        p = dict(p)
        for name in ("wk", "wv", "bk", "bv"):
            if name in p:
                p[name] = tp.whole_param(p[name]).narrow(-1, kv0 * hd,
                                                         n_kv * hd)
    return p, n_q, n_kv


def _project_qkv(p, cfg: ModelConfig, x, positions, tp=None):
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    if tp is not None:
        p, n_q, n_kv = rank_kv(p, cfg, tp)
        p = dict(p)
        if cfg.qk_norm:
            # each rank normalises its own heads
            for name in ("q_norm", "k_norm"):
                p[name] = tp.whole_param(p[name])
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, n_q, hd)
    k = k.reshape(B, S, n_kv, hd)
    v = v.reshape(B, S, n_kv, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = head_rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_partial)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_partial)
    return q, k, v


def gqa_attend(q, k, v, mask, softcap: Optional[float] = None):
    """Grouped-query attention core, the JAX model's: q (B, Sq, Hq, D),
    k and v (B, Skv, Hkv, D), mask (Sq, Skv) or broadcastable to
    (B, Hkv, G, Sq, Skv). The scores come from an einsum in q's dtype
    and are then cast to f32 (and, with ``softcap``, capped to
    softcap * tanh(scores / softcap) before the mask); the softmax
    weights are cast back to q's dtype before the second einsum."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(D)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if mask.dim() == 2:
        mask = mask[None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, Hq, D)


_Q_CHUNK = 2048          # q-block size for long-sequence attention
_CHUNK_THRESHOLD = 8192  # chunk when S exceeds this


def chunks_queries(S: int) -> bool:
    """Whether plain attention over S tokens runs in q-blocks (JAX's
    rule in ``attention_apply``)."""
    return S > _CHUNK_THRESHOLD and S % _Q_CHUNK == 0


def chunked_gqa_attend(q, k, v, mask_fn, softcap: Optional[float] = None):
    """Exact attention in q-blocks of ``_Q_CHUNK`` queries, each softmax
    over its full row: peak score memory O(_Q_CHUNK * S) instead of
    O(S^2). ``mask_fn(q_offset, q_len)`` gives the block's (q_len, Skv)
    bool mask (the window or prefix with it). JAX pins the batch
    sharding of q, k and v here; eager PyTorch has nothing to pin (the
    port's meshes keep activations whole on each rank)."""
    c = _Q_CHUNK
    return torch.cat([gqa_attend(q[:, i:i + c], k, v, mask_fn(i, c), softcap)
                      for i in range(0, q.shape[1], c)], dim=1)


def check_flash_masks(cfg: ModelConfig) -> None:
    """Raise where ``attn_impl="flash"`` meets a mask or a cap the flash
    kernels do not compute (they take the causal mask and the window):
    running the plain core instead would hide that no kernel runs."""
    if cfg.attn_impl != "flash":
        return
    for knob in ("prefix_lm", "logit_softcap"):
        if getattr(cfg, knob):
            raise NotImplementedError(
                f"attn_impl='flash' with {knob}={getattr(cfg, knob)!r}: the "
                "flash kernels compute the causal mask and the window only; "
                "use attn_impl='xla'")


def flash_attend(q, k, v, window: Optional[int] = None,
                 causal: bool = True):
    """Attention through the flash kernels, causal (with ``window`` a
    sliding window) or, with ``causal=False``, every query over every
    key (no window): q (B, Sq, H, D), k and v (B, Skv, Hkv, D) in,
    (B, Sq, H, D) out, (B, H, S, D) at the kernel API (a causal query
    sits at position i + Skv - Sq). With autograd recording (a training
    forward, or its recomputation under checkpointing) it is the
    training entry (the forward with lse, the dq and dk/dv kernels in
    backward); otherwise the inference forward without lse."""
    from repro_torch.kernels.flash_attention.ops import attend, attend_train
    if not causal and window is not None:
        raise ValueError("flash_attend: a window needs causal=True")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (qh, kh, vh))
    out = (attend_train if train else attend)(qh, kh, vh, causal=causal,
                                              window=window)
    return out.transpose(1, 2)


def attention_apply(p, cfg: ModelConfig, x, positions, mask, mask_fn=None,
                    causal: bool = True, tp=None):
    """Full-sequence (training) attention, ``cfg.attn_impl`` choosing
    the core. For S beyond the chunk threshold, pass ``mask_fn`` to run
    the plain core in exact q-blocks (``chunked_gqa_attend``); ``mask``
    may then be None. The flash core takes the window from the config
    and needs neither: it is causal, or with ``causal=False`` (the
    encoder's bidirectional attention, whose plain mask is all ones)
    runs without a mask. Under ``tp`` the rank's heads (see the
    module's docstring); ``x`` is then the rank's sequence block under
    ``seq_parallel``, and so is the output."""
    if tp is not None:
        x = tp.enter(x)
    q, k, v = _project_qkv(p, cfg, x, positions, tp)
    B, S = x.shape[:2]
    if cfg.attn_impl == "flash":
        check_flash_masks(cfg)
        out = flash_attend(q, k, v, cfg.sliding_window, causal)
    elif mask_fn is not None and chunks_queries(S):
        out = chunked_gqa_attend(q, k, v, mask_fn, cfg.logit_softcap)
    else:
        out = gqa_attend(q, k, v, mask, cfg.logit_softcap)
    out = out.reshape(B, S, -1) @ p["wo"].to(x.dtype)
    return out if tp is None else tp.exit(out)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu", tp=None):
    """The stacked cache {"k", "v"}, each (n_layers, batch, slots,
    n_kv_heads, head_dim) zeros: ``max_len`` slots, or with a sliding
    window a rolling buffer of min(window, max_len) slots; under ``tp``
    the kv heads the rank's attention reads
    (``tensor_parallel.local_kv_heads``)."""
    from repro_torch.dist.tensor_parallel import local_kv_heads
    slots = (min(cfg.sliding_window, max_len) if cfg.sliding_window
             else max_len)
    shape = (n_layers, batch, slots, local_kv_heads(cfg, tp),
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_axes(cfg: ModelConfig):
    ax = ("layers", "batch", "kv_seq", "heads", None)
    return {"k": ax, "v": ax}


def decode_attention(p, cfg: ModelConfig, x, pos, k_cache, v_cache,
                     tp=None):
    """One-token decode step against one layer's cache, written in place.

    x (B, 1, d); k_cache, v_cache (B, slots, Hkv, D), views into the
    stacked cache (JAX donates the cache through ``jit``; here the
    layer's slice is updated where it lies). ``pos`` is a scalar (an
    int or a 0-dim int tensor: lockstep decode, one position for the
    batch) or a (B,) int tensor of per-slot positions (continuous
    batching): row b writes column pos[b] and attends to the columns
    kv_pos <= pos[b], so a sequence admitted at position 0 never sees a
    previous occupant's entries. With a sliding window the cache is a
    rolling buffer: position pos writes column pos % slots, and once
    pos + 1 >= slots every column holds one of the window's latest
    positions and all are attended. K and V are rounded to the cache
    dtype on write and read back in q's dtype. Under ``tp`` the rank's
    query heads against its block of the cache (its kv heads; on the
    whole-kv route the one its heads read, projected from the whole
    ``wk`` / ``wv`` and sliced), ``wo`` row-parallel and ``tp.exit``
    summing the ranks' parts. Returns (out, k_cache, v_cache)."""
    if tp is not None:
        x = tp.enter(x)
    B = x.shape[0]
    slots = k_cache.shape[1]
    kv_pos = torch.arange(slots, device=x.device)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    col = pos % slots if cfg.sliding_window else pos
    if pos.dim() == 0:
        q, k, v = _project_qkv(p, cfg, x, pos.expand(B, 1), tp)
        k_cache[:, col] = k[:, 0].to(k_cache.dtype)
        v_cache[:, col] = v[:, 0].to(v_cache.dtype)
        valid = kv_pos <= pos
        if cfg.sliding_window:
            valid = valid | (pos + 1 >= slots)
        mask = valid[None, None, None, None, :]
    else:
        q, k, v = _project_qkv(p, cfg, x, pos[:, None], tp)
        rows = torch.arange(B, device=x.device)
        k_cache[rows, col] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, col] = v[:, 0].to(v_cache.dtype)
        valid = kv_pos[None, :] <= pos[:, None]             # (B, slots)
        if cfg.sliding_window:
            valid = valid | (pos[:, None] + 1 >= slots)
        mask = valid[:, None, None, None, :]
    out = gqa_attend(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask,
                     cfg.logit_softcap)
    out = out.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return (out if tp is None else tp.exit(out)), k_cache, v_cache


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------
def mlp_init(f: ParamFactory, cfg: ModelConfig, name: str = "mlp"):
    d, dff = cfg.d_model, cfg.d_ff
    m = f.child(name)
    m.param("w_gate", (d, dff), ("embed", "mlp"))
    m.param("w_up", (d, dff), ("embed", "mlp"))
    m.param("w_down", (dff, d), ("mlp", "embed"))


def _act(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    if name == "gelu":     # jax.nn.gelu's default is the tanh form
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def mlp_apply(p, cfg: ModelConfig, x, tp=None):
    """The gated MLP; under ``tp`` on the rank's "mlp" columns."""
    act = _act(cfg.act)
    if tp is not None:
        x = tp.enter(x)
    h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    out = h @ p["w_down"].to(x.dtype)
    return out if tp is None else tp.exit(out)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embedding_init(f: ParamFactory, cfg: ModelConfig):
    f.param("tok_emb", (cfg.padded_vocab_size, cfg.d_model),
            (None, "embed"), scale=1.0 / math.sqrt(cfg.d_model))
    if not cfg.tie_embeddings:
        f.param("out_head", (cfg.d_model, cfg.padded_vocab_size),
                ("embed", "vocab"))


def embed_tokens(params, tokens, dtype):
    return params["tok_emb"][tokens.to(torch.int64)].to(dtype)


def output_logits(params, cfg: ModelConfig, h, tp=None):
    """Logits over the padded vocab (the softmax includes the pad
    columns, as in JAX); under ``tp`` the rank's vocab block of them,
    for the whole sequence (a tied table's rows by ``tp.vocab_slice``,
    an untied head's block as the rank holds it)."""
    if tp is not None:
        h = tp.enter(h)
    if cfg.tie_embeddings:
        table = params["tok_emb"]
        if tp is not None:
            table = tp.vocab_slice(table)
        return h @ table.to(h.dtype).T
    return h @ params["out_head"].to(h.dtype)
