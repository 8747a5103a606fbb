"""Encoder-decoder of the port (``repro/models/encdec.py``): seamless-m4t.

A bidirectional encoder over the stub frame embeddings (the w2v-BERT
speech frontend is a stub: the batch carries (B, S_src, d_model) frames,
projected by ``frame_proj``) and a causal text decoder whose every layer
attends to the encoder's output through a cross-attention. Layers are
pre-RMSNorm with RoPE self-attention and a gated MLP, as in the
transformer; the cross-attention has no RoPE.

The parameter tree is JAX's: ``tok_emb`` (and ``out_head``),
``frame_proj``, the stacked ``encoder`` (ln1, attn, ln2, mlp) and
``decoder`` (ln1, attn, ln_x, xattn, ln2, mlp) children along a leading
layer dim, ``ln_enc_final`` and ``ln_final``, so
``convert.params_from_jax`` carries JAX's weights unchanged.

``cfg.attn_impl`` picks the attention core of training. Under "xla" all
three attentions are JAX's ``gqa_attend`` (in exact 2048-query blocks
past 8192 queries): the encoder's mask is all ones, the decoder's
causal, the cross-attention's all ones. Under "flash" the flash kernels
run all three (their plain version on CPU tensors): the encoder's
self-attention non-causal, the decoder's causal, the cross-attention
non-causal over the memory's K/V (Sq = S_tgt, Skv = S_src). The JAX
model has no such knob (it always runs ``gqa_attend``): the "flash"
route of the cross-attention is the port's, like the knob itself.
``block_remat`` checkpoints each encoder and each decoder layer as the
transformer does (``transformer._apply``).

Under an active mesh with ``model > 1`` the model is tensor parallel
(``dist.tensor_parallel``): the encoder's and the decoder's self-
attention and MLP blocks as the transformer's; the cross-attention's q
column-parallel over the decoder stream (``tp.enter``), its K/V
column-parallel over the memory on the rank's kv heads (8 of
seamless's 16 at M = 2), its ``wo`` row-parallel (``tp.exit``).
Every decoder layer's K/V projection reads the memory, so its gradient
is a sum over the layers and the ranks: the memory is entered once,
after the encoder (``decode_train``'s ``tp.enter``: a copy, or under
``seq_parallel`` the sequence's gather), autograd sums the layers'
gradients into it first, and its backward reduces the sum once (one
all-reduce, or one reduce-scatter, a step and microbatch; not one a
layer). ``frame_proj`` and ``ln_enc_final`` stay whole. Under
``seq_parallel`` (JAX's ``_sp`` before every encoder and decoder
layer) both streams are split over the sequence between blocks: the
source and the target lengths must each split over the ranks.

The decode (``init_decode_state``, ``decode_step``) runs one token
through the decoder against a stacked cache {"self": the KV cache,
"mem_k", "mem_v": the cross-attention's K/V over ``max_len`` source
positions}, the self-attention's slice of it written in place. As in
JAX, nothing fills ``mem_k``/``mem_v`` on the serve path: the engine
decodes against the zero memory the cache starts with (ROADMAP C.17).
The decode's cross-attention is ``gqa_attend`` under either knob, as
``decode_attention`` is. At ``model > 1`` the decode runs the rank's
heads against its kv heads of the cache and of the memory
(``tensor_parallel.active_decode``), as the training forward does.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ENCDEC, ModelConfig
from repro_torch.dist import tensor_parallel
from repro_torch.models import transformer as tf
from repro_torch.models.common import ParamFactory
from repro_torch.models.layers import (attention_apply, attention_init,
                                       cache_axes, causal_mask,
                                       chunked_gqa_attend, chunks_queries,
                                       decode_attention, embed_tokens,
                                       embedding_init, flash_attend,
                                       gqa_attend, init_kv_cache, mlp_apply,
                                       mlp_init, output_logits, rank_kv,
                                       rmsnorm, rmsnorm_init, scalar)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a knob of ``cfg`` the encoder-decoder does not carry
    (never ignore one silently): the transformer's shared checks, and
    the masks JAX's encoder-decoder leaves out of training (its encoder
    attends everywhere and its decoder is causal, whatever
    ``sliding_window`` or ``prefix_lm`` say)."""
    if cfg.family != ENCDEC:
        raise ValueError(f"models/encdec.py builds the encdec family, not "
                         f"{cfg.family!r}")
    for knob in ("sliding_window", "prefix_lm"):
        if getattr(cfg, knob):
            raise NotImplementedError(
                f"{knob}={getattr(cfg, knob)!r} on the encoder-decoder: "
                "JAX's model leaves it out of its training masks")
    tf.check_knobs(cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _enc_layer_init(f: ParamFactory, cfg: ModelConfig):
    rmsnorm_init(f, "ln1", cfg.d_model)
    attention_init(f, cfg)
    rmsnorm_init(f, "ln2", cfg.d_model)
    mlp_init(f, cfg)


def _dec_layer_init(f: ParamFactory, cfg: ModelConfig):
    rmsnorm_init(f, "ln1", cfg.d_model)
    attention_init(f, cfg, "attn")
    rmsnorm_init(f, "ln_x", cfg.d_model)
    attention_init(f, cfg, "xattn")
    rmsnorm_init(f, "ln2", cfg.d_model)
    mlp_init(f, cfg)


def init(cfg: ModelConfig, generator, device, with_axes: bool = False) -> Dict:
    """The parameter tree on ``device``, drawn from the CPU
    ``generator`` (on ``meta``: shapes only); ``with_axes``: (params,
    their logical axes)."""
    check_supported(cfg)
    f = ParamFactory(generator, tf._dtype(cfg.param_dtype), device,
                     cut=tensor_parallel.param_cutter(cfg))
    embedding_init(f, cfg)
    f.param("frame_proj", (cfg.d_model, cfg.d_model), ("embed", None))
    f.stacked_children("encoder", cfg.n_encoder_layers,
                       lambda g: _enc_layer_init(g, cfg))
    f.stacked_children("decoder", cfg.n_layers,
                       lambda g: _dec_layer_init(g, cfg))
    rmsnorm_init(f, "ln_enc_final", cfg.d_model)
    rmsnorm_init(f, "ln_final", cfg.d_model)
    return (f.params, f.axes) if with_axes else f.params


# ---------------------------------------------------------------------------
# Attention to the encoder's output
# ---------------------------------------------------------------------------
def _cross_attention(p, cfg: ModelConfig, x, memory_k, memory_v,
                     impl: str, tp=None):
    """x (B, Sq, d); memory_k, memory_v (B, Skv, Hkv, D), the encoder's
    output projected once (``_memory_kv``). Every query attends to every
    memory position, without RoPE: through the flash kernels
    (``impl="flash"``, non-causal) or ``gqa_attend`` with an all-ones
    mask (in q-blocks past the chunk threshold, as in JAX). Under ``tp``
    the rank's query heads over its kv heads (x the rank's sequence
    block under ``seq_parallel``, and so is the output)."""
    n_q = cfg.n_heads
    if tp is not None:
        x = tp.enter(x)
        n_q = tensor_parallel.local_heads(cfg, tp.ax)[0]
    B, Sq, _ = x.shape
    Skv = memory_k.shape[1]
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, Sq, n_q, cfg.resolved_head_dim)
    mk, mv = memory_k.to(q.dtype), memory_v.to(q.dtype)
    if impl == "flash":
        out = flash_attend(q, mk, mv, causal=False)
    elif chunks_queries(Sq):
        out = chunked_gqa_attend(q, mk, mv, lambda off, qn: torch.ones(
            (qn, Skv), dtype=torch.bool, device=x.device))
    else:
        out = gqa_attend(q, mk, mv, torch.ones((Sq, Skv), dtype=torch.bool,
                                               device=x.device))
    out = out.reshape(B, Sq, -1) @ p["wo"].to(x.dtype)
    return out if tp is None else tp.exit(out)


def _memory_kv(p, cfg: ModelConfig, memory, tp=None):
    """The encoder's output (B, S, d) projected into the cross-attention's
    K and V, each (B, S, Hkv, D); under ``tp`` the rank's kv heads of
    the entered memory (sliced from the whole kv leaves where the kv
    heads do not split)."""
    B, S, _ = memory.shape
    hd = cfg.resolved_head_dim
    n_kv = cfg.n_kv_heads
    if tp is not None:
        p, _, n_kv = rank_kv(p, cfg, tp)
    k = memory @ p["wk"].to(memory.dtype)
    v = memory @ p["wv"].to(memory.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(memory.dtype)
        v = v + p["bv"].to(memory.dtype)
    return k.reshape(B, S, n_kv, hd), v.reshape(B, S, n_kv, hd)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------
def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None, :]


def _enc_block(layer_p, cfg: ModelConfig, h, positions, mask, mask_fn,
               tp=None):
    h = h + attention_apply(layer_p["attn"], cfg,
                            rmsnorm(h, tf._norm_scale(layer_p["ln1"], tp),
                                    cfg.norm_eps),
                            positions, mask, mask_fn, causal=False, tp=tp)
    return h + mlp_apply(layer_p["mlp"], cfg,
                         rmsnorm(h, tf._norm_scale(layer_p["ln2"], tp),
                                 cfg.norm_eps), tp)


def _dec_block(layer_p, cfg: ModelConfig, h, memory, positions, mask,
               mask_fn, tp=None):
    h = h + attention_apply(layer_p["attn"], cfg,
                            rmsnorm(h, tf._norm_scale(layer_p["ln1"], tp),
                                    cfg.norm_eps),
                            positions, mask, mask_fn, tp=tp)
    mk, mv = _memory_kv(layer_p["xattn"], cfg, memory, tp)
    h = h + _cross_attention(layer_p["xattn"], cfg,
                             rmsnorm(h, tf._norm_scale(layer_p["ln_x"], tp),
                                     cfg.norm_eps),
                             mk, mv, cfg.attn_impl, tp)
    return h + mlp_apply(layer_p["mlp"], cfg,
                         rmsnorm(h, tf._norm_scale(layer_p["ln2"], tp),
                                 cfg.norm_eps), tp)


def _mask(cfg: ModelConfig, S: int, mask_fn):
    """The whole (S, S) mask, only where the plain core takes it
    unchunked."""
    if cfg.attn_impl == "flash" or chunks_queries(S):
        return None
    return mask_fn(0, S)


def encode(params, cfg: ModelConfig, frames, tp=None) -> torch.Tensor:
    """frames (B, S_src, d) stub embeddings -> the encoder's output
    (B, S_src, d) in the compute dtype (bidirectional); under ``tp``
    with ``seq_parallel`` the rank's sequence block of it."""
    dtype = tf._dtype(cfg.compute_dtype)
    h = frames.to(dtype) @ params["frame_proj"].to(dtype)
    S = h.shape[1]
    mask_fn = lambda off, qn: torch.ones((qn, S), dtype=torch.bool,
                                         device=h.device)
    mask = _mask(cfg, S, mask_fn)
    positions = _positions(S, h.device)
    remat = cfg.block_remat if torch.is_grad_enabled() else "none"
    if tp is not None:
        h = tp.split_seq(h)
    for layer_p in tf.unbind_layers(params["encoder"]):
        h = tf._apply(remat, _enc_block, layer_p, cfg, h, positions, mask,
                      mask_fn, tp)
    return rmsnorm(h, tf._norm_scale(params["ln_enc_final"], tp),
                   cfg.norm_eps)


def decode_train(params, cfg: ModelConfig, tokens, memory,
                 tp=None) -> torch.Tensor:
    """The teacher-forced decoder: tokens (B, S_tgt) int and the
    encoder's output -> logits (B, S_tgt, padded vocab) in the compute
    dtype; under ``tp`` the rank's vocab block of them (``memory`` the
    rank's sequence block under ``seq_parallel``, entered here once)."""
    dtype = tf._dtype(cfg.compute_dtype)
    h = embed_tokens(params, tokens, dtype) * scalar(math.sqrt(cfg.d_model),
                                                     dtype)
    S = h.shape[1]
    mask_fn = lambda off, qn: causal_mask(qn, S, h.device, q_offset=off)
    mask = _mask(cfg, S, mask_fn)
    positions = _positions(S, h.device)
    remat = cfg.block_remat if torch.is_grad_enabled() else "none"
    ln_final = params["ln_final"]
    if tp is not None:
        h = tp.split_seq(h)
        memory = tp.enter(memory)
        ln_final = tp.norm_scale(ln_final)
    for layer_p in tf.unbind_layers(params["decoder"]):
        h = tf._apply(remat, _dec_block, layer_p, cfg, h, memory, positions,
                      mask, mask_fn, tp)
    h = rmsnorm(h, ln_final, cfg.norm_eps)
    return output_logits(params, cfg, h, tp)


def loss(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """batch: {"frames": (B, S_src, d), "tokens": (B, S_tgt) int,
    "weights": (B,) f32} -> (the weighted sum of the next-token cross
    entropy, {"count": the weighted token count, "loss_sum": the same
    sum}). The decoder runs at the full target length and the logits
    are sliced, as in JAX."""
    tokens = batch["tokens"]
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones((tokens.shape[0],), dtype=torch.float32,
                             device=tokens.device)
    frames = batch["frames"]
    tp = tensor_parallel.active(cfg, frames.shape[1], tokens.shape[1])
    memory = encode(params, cfg, frames, tp)
    logits = decode_train(params, cfg, tokens, memory, tp)
    loss_sum, count = tf.next_token_loss(logits, tokens, weights, tp)
    return loss_sum, {"count": count, "loss_sum": loss_sum}


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cpu"
                      ) -> Tuple[Dict, Dict]:
    """(the decode cache, its logical-axes tree): {"self": the decoder's
    KV cache, "mem_k", "mem_v": the cross-attention's K/V, each
    (n_layers, batch, max_len, n_kv_heads, head_dim) zeros in
    ``dtype``}. Under an active mesh the rank's block of it
    (``transformer.init_decode_state``): its rows of the slots where
    ``data`` splits them, at ``model > 1`` the kv heads its
    attention reads."""
    check_supported(cfg)
    tp = tensor_parallel.active_decode(cfg)
    batch = tensor_parallel.slot_rows(batch).size
    shape = (cfg.n_layers, batch, max_len,
             tensor_parallel.local_kv_heads(cfg, tp), cfg.resolved_head_dim)
    cache = {"self": init_kv_cache(cfg, cfg.n_layers, batch, max_len, dtype,
                                   device, tp),
             "mem_k": torch.zeros(shape, dtype=dtype, device=device),
             "mem_v": torch.zeros(shape, dtype=dtype, device=device)}
    ax = ("layers", "batch", "kv_seq", "heads", None)
    return cache, {"self": cache_axes(cfg), "mem_k": ax, "mem_v": ax}


def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """One-token decode through the decoder: tokens (B, 1) int; pos a
    scalar (lockstep) or (B,) per-slot positions. The self-attention's
    cache is written in place, layer by layer; the cross-attention reads
    ``mem_k``/``mem_v``. Returns (logits (B, 1, padded vocab), cache).
    Under an active mesh B is the rank's rows of the cache; at ``model >
    1`` the self- and cross-attention run the rank's query heads against
    its kv heads of the cache and of the memory, the MLP its "mlp"
    columns, and the logits are its vocab block."""
    check_supported(cfg)
    tp = tensor_parallel.active_decode(cfg)
    dtype = tf._dtype(cfg.compute_dtype)
    h = embed_tokens(params, tokens, dtype) * scalar(math.sqrt(cfg.d_model),
                                                     dtype)
    kv = cache["self"]
    for i, layer_p in enumerate(tf.unbind_layers(params["decoder"])):
        y, _, _ = decode_attention(layer_p["attn"], cfg,
                                   rmsnorm(h, layer_p["ln1"], cfg.norm_eps),
                                   pos, kv["k"][i], kv["v"][i], tp)
        h = h + y
        h = h + _cross_attention(layer_p["xattn"], cfg,
                                 rmsnorm(h, layer_p["ln_x"], cfg.norm_eps),
                                 cache["mem_k"][i], cache["mem_v"][i], "xla",
                                 tp)
        h = h + mlp_apply(layer_p["mlp"], cfg,
                          rmsnorm(h, layer_p["ln2"], cfg.norm_eps), tp)
    h = rmsnorm(h, params["ln_final"], cfg.norm_eps)
    return output_logits(params, cfg, h, tp), cache
