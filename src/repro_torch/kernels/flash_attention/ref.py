"""Plain PyTorch versions of the flash-attention kernels: the twin of
``repro/kernels/flash_attention/ref.py`` (``attention_ref``) and the
oracles the CUDA kernels are held against.

Layout as in JAX: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D); GQA by
grouping (q head h reads kv head h // (Hq // Hkv)); queries
right-aligned (query row i sits at key position i + Skv - Sq); masked
scores are ``NEG_INF = -1e30``, never -inf; the softmax is f32 and the
output comes back in q's dtype.

``attention_ref`` differentiates with autograd: that is the plain
backward. ``flash_bwd_ref`` is the backward the kernels compute,
written out from the saved lse (p = exp(s - lse)): it equals autograd
wherever a row has a valid key, and, like the TPU kernels, weighs every
key of a row that has none by exp(0) = 1 (ROADMAP C.5).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, causal: bool, window: Optional[int],
                   device) -> torch.Tensor:
    """(Sq, Skv) bool, True = attend; queries right-aligned."""
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def _scores(q, k, causal, window, scale):
    """Masked f32 scores (B, Hkv, G, Sq, Skv)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = attention_mask(Sq, Skv, causal, window, q.device)
    return torch.where(mask, s, NEG_INF)


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None):
    """(B, Hq, Sq, D) in q.dtype: softmax(q k^T scale, masked) v in f32."""
    B, Hq, Sq, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    p = torch.softmax(_scores(q, k, causal, window, scale), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def flash_fwd_lse_ref(q, k, v, *, causal: bool, window: Optional[int],
                      scale: float):
    """(o in q.dtype, lse (B, Hq, Sq) f32): the forward with the row
    logsumexp the backward recomputes p from."""
    B, Hq, Sq, D = q.shape
    s = _scores(q, k, causal, window, scale)
    # o from the softmax, not from exp(s - lse): a row with no valid key
    # has lse = -1e30 + log(Skv) = -1e30 in f32, and its output is the
    # mean of v, not the sum
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    lse = torch.logsumexp(s, dim=-1)
    return (o.reshape(B, Hq, Sq, D).to(q.dtype), lse.reshape(B, Hq, Sq))


def _bwd_parts(q, k, v, lse, delta, do, causal, window, scale):
    """(p, ds, do, q) of the recomputing backward, grouped
    (B, Hkv, G, ...) and f32."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    s = _scores(q, k, causal, window, scale)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq)[..., None])
    dog = do.reshape(B, Hkv, G, Sq, D).to(torch.float32)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.to(torch.float32))
    ds = p * (dp - delta.reshape(B, Hkv, G, Sq)[..., None]) * scale
    return p, ds, dog, q.reshape(B, Hkv, G, Sq, D).to(torch.float32)


def flash_bwd_dq_ref(q, k, v, lse, delta, do, *, causal: bool,
                     window: Optional[int], scale: float):
    """dq = ds k in q's dtype, ds = p (dp - delta) scale, p from lse."""
    _, ds, _, _ = _bwd_parts(q, k, v, lse, delta, do, causal, window, scale)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.to(torch.float32))
    return dq.reshape(q.shape).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, lse, delta, do, *, causal: bool,
                      window: Optional[int], scale: float):
    """(dk, dv) in k's dtype: ds^T q and p^T do, summed over each kv
    head's group in f32."""
    p, ds, dog, qg = _bwd_parts(q, k, v, lse, delta, do, causal, window,
                                scale)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_ref(q, k, v, lse, delta, do, *, causal: bool,
                  window: Optional[int], scale: float):
    """(dq, dk, dv) from the saved lse and delta = rowsum(do * o), in
    the inputs' dtypes: what the dq and dk/dv kernels compute."""
    kw = dict(causal=causal, window=window, scale=scale)
    return (flash_bwd_dq_ref(q, k, v, lse, delta, do, **kw),
            *flash_bwd_dkv_ref(q, k, v, lse, delta, do, **kw))
