"""Gradient compression operators of the port (``repro/optim/
compression.py``): symmetric int8 quantization per tensor and per row,
top-k sparsification, and top-k with error feedback.

The int8 per-row scheme with bf16 scales is the wire format of the
compressed gossip (``core.consensus``): the scale is rounded to bf16
(8-bit mantissa) before the values are quantized, so every
dequantization product ``q * scale`` (7-bit integer times 8-bit
mantissa) is exact in f32, whatever a backend contracts it into.

Divisions take their constant as a 0-dim tensor on the values' device:
PyTorch turns a division by a Python scalar on CUDA into a
multiplication by its reciprocal, which is not the correctly rounded
quotient the JAX package computes. ``torch.round`` rounds half to even,
as ``jnp.round`` does.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.arena import tree_flatten, tree_map, tree_unflatten


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127, the division correctly rounded."""
    c127 = torch.full((), 127.0, dtype=torch.float32, device=amax.device)
    return torch.div(torch.clamp(amax, min=1e-12), c127)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale), scale 0-dim f32."""
    scale = _scale_of(torch.amax(torch.abs(g)))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_int8_rows(g: torch.Tensor, scale_dtype=torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per row (the last axis quantized as
    a group): g (..., lanes) f32 -> (q int8 of g's shape, scales (...)
    in ``scale_dtype``). ``scale_dtype=torch.bfloat16`` (the gossip
    path) rounds each scale to bf16, nearest even, and quantizes by its
    f32 value."""
    scale = _scale_of(torch.amax(torch.abs(g), dim=-1)).to(scale_dtype)
    q = torch.clamp(torch.round(g / scale.to(torch.float32)[..., None]),
                    -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """Inverse of ``quantize_int8_rows``: elementwise, so it commutes
    bitwise with any permutation of the rows."""
    return q.to(torch.float32) * scale.to(torch.float32)[..., None]


def topk_sparsify(g: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top ``frac`` of the entries by magnitude: (values, flat
    indices), largest first, and among equal magnitudes the lowest index
    first, as JAX's ``lax.top_k`` orders them (``torch.topk`` leaves
    that order open, so a stable sort picks them)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    idx = torch.sort(torch.abs(flat), descending=True, stable=True).indices
    return flat[idx[:k]], idx[:k]


def topk_densify(values: torch.Tensor, idx: torch.Tensor, shape
                 ) -> torch.Tensor:
    flat = torch.zeros((math.prod(shape),), dtype=values.dtype,
                       device=values.device)
    flat[idx] = values
    return flat.reshape(tuple(shape))


class FeedbackState(NamedTuple):
    residual: Any     # a tree like the gradients, f32 leaves


def init_feedback(grads) -> FeedbackState:
    return FeedbackState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def compress_with_feedback(state: FeedbackState, grads, frac: float
                           ) -> Tuple[Any, FeedbackState]:
    """Top-k sparsification with error feedback: the dropped mass is
    carried into the next round, so the compressed stream is unbiased
    in the long run. Returns (compressed tree, new state)."""
    leaves_g, treedef = tree_flatten(grads)
    leaves_r, _ = tree_flatten(state.residual)
    dense, residual = [], []
    for g, r in zip(leaves_g, leaves_r):
        fed = g.to(torch.float32) + r
        vals, idx = topk_sparsify(fed, frac)
        d = topk_densify(vals, idx, fed.shape)
        dense.append(d)
        residual.append(fed - d)
    return (tree_unflatten(treedef, dense),
            FeedbackState(tree_unflatten(treedef, residual)))
