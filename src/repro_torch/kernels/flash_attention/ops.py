"""Public wrappers of flash attention (``repro.kernels.flash_attention``).

``flash_attention`` is the inference entry (B.6: the forward without
lse); ``flash_attention_train`` the training entry, a
``torch.autograd.Function`` whose forward is B.7a (the forward with
lse) and whose backward forms delta = rowsum(do * o) in torch, then
launches B.7b's dq and dk/dv kernels. The model layers call them
through ``ModelConfig.attn_impl == "flash"``.

The signatures are JAX's, ``interpret`` replaced by ``impl``: q
(B, Hq, Sq, D), k and v (B, Hkv, Skv, D), and ``block_q``/``block_k``
must divide Sq/Skv (the JAX kernel's assert). The CUDA kernels pick
their own tiles; the block sizes are only checked, and the model layers
call ``attend``/``attend_train``, which take none. Dispatch follows
the tensors (``repro_torch.kernels.resolve_impl``): the kernels on CUDA
tensors, the plain version (``ref.attention_ref``, differentiated by
autograd) on CPU tensors and anywhere with ``impl="ref"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_bwd_ref,
                                                     flash_fwd_lse_ref)


def _check_blocks(q, k, block_q: int, block_k: int) -> None:
    sq, skv = q.shape[2], k.shape[2]
    if sq % block_q or skv % block_k:
        raise ValueError(f"Sq={sq} and Skv={skv} must be multiples of "
                         f"block_q={block_q} and block_k={block_k}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 128,
                    block_k: int = 128, impl: str = "auto"):
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    _check_blocks(q, k, block_q, block_k)
    return attend(q, k, v, causal=causal, window=window, impl=impl)


def attend(q, k, v, *, causal: bool = True, window: Optional[int] = None,
           impl: str = "auto"):
    """``flash_attention`` without the block sizes."""
    if resolve_impl(impl, q, k, v) == "ref":
        return attention_ref(q, k, v, causal=causal, window=window)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=q.shape[-1] ** -0.5)


class FlashAttentionTrain(torch.autograd.Function):
    """Flash attention with the recomputing backward: saves q, k, v, o
    and the row lse, never the (Sq, Skv) probabilities. ``use_kernel``
    picks the CUDA kernels or their plain versions for both passes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, use_kernel):
        scale = q.shape[-1] ** -0.5
        if use_kernel:
            from repro_torch.kernels.flash_attention.kernel import \
                flash_fwd_lse
        else:
            flash_fwd_lse = flash_fwd_lse_ref
        o, lse = flash_fwd_lse(q, k, v, causal=causal, window=window,
                               scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        ctx.use_kernel = use_kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
        if ctx.use_kernel:
            from repro_torch.kernels.flash_attention.kernel import \
                flash_attention_bwd as bwd
        else:
            bwd = flash_bwd_ref
        dq, dk, dv = bwd(q, k, v, lse, delta, do, causal=ctx.causal,
                         window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, causal: bool = True,
                          window: Optional[int] = None, block_q: int = 128,
                          block_k: int = 128, impl: str = "auto"):
    """Differentiable flash attention: on CUDA tensors the kernels of
    ``FlashAttentionTrain``; on CPU tensors (or ``impl="ref"``) the
    plain ``attention_ref``, whose autograd is the plain backward."""
    _check_blocks(q, k, block_q, block_k)
    return attend_train(q, k, v, causal=causal, window=window, impl=impl)


def attend_train(q, k, v, *, causal: bool = True,
                 window: Optional[int] = None, impl: str = "auto"):
    """``flash_attention_train`` without the block sizes."""
    if resolve_impl(impl, q, k, v) == "ref":
        return attention_ref(q, k, v, causal=causal, window=window)
    return FlashAttentionTrain.apply(q, k, v, causal, window, True)


__all__ = ["FlashAttentionTrain", "attend", "attend_train", "attention_ref",
           "flash_attention", "flash_attention_train"]
