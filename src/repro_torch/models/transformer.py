"""Decoder-only LM of the port (``repro/models/transformer.py``), five
families:

  dense  : [attention -> gated MLP] x L with pre-RMSNorm, RoPE, GQA,
           optional QKV bias and qk-norm, tied or untied head;
  moe    : [attention -> MoE FFN] x L (mixtral: top-k experts,
           ``models/moe.py``), each layer adding its router's aux loss;
  ssm    : [mLSTM | sLSTM] x L (xLSTM, ``models/xlstm.py``): layer i is
           an sLSTM block iff (i + 1) % slstm_every == 0, each block
           residual after its own pre-RMSNorm;
  hybrid : [Mamba2] x L with one *shared* attention + MLP block applied
           after every ``shared_attn_every`` layers (zamba2);
  vlm    : the dense backbone with the image stub in front of the text
           (paligemma): ``patches @ patch_proj + patch_pos``, the first
           ``n_frontend_tokens`` positions, attended both ways under
           ``prefix_lm``; the loss is on the text alone, and the decode
           is the dense one (it never sees the patches, as in JAX).

The encoder-decoder family is ``models/encdec.py``'s.

The attention takes the config's mask: causal, with ``sliding_window``
a window, or with ``prefix_lm`` bidirectional over a prefix; and
``logit_softcap`` caps the scores.

The parameter tree is the JAX one: a dict with the stacked ``layers``
leaves along a leading ``n_layers`` dim (the xLSTM: two stacks,
``mlstm_layers`` and ``slstm_layers``), so ``core.arena``'s sorted-key
flatten gives the JAX arena layout row for row and
``convert.params_from_jax`` carries the weights unchanged. The forward
loops over the layers on ``torch.unbind`` slices of the stack: its
backward stacks the layer gradients once, where indexing ``stacked[i]``
would write a zero gradient of the whole stack per layer.
``block_remat="full"`` (JAX's ``jax.checkpoint`` per scanned block) is
``torch.utils.checkpoint`` per layer (hybrid: per Mamba2 layer and per
shared attention block; the shared MLP is not checkpointed, as in
JAX); ``"dots"`` (JAX's ``checkpoint_dots`` policy) checkpoints the same
blocks but saves the outputs of their matrix products (``aten.mm``,
``bmm``, ``addmm``, ``baddbmm``) and recomputes the rest; ``"none"``
saves everything.

The decode path (``init_decode_state``, ``decode_step``) runs one
token through every layer against a stacked cache (KV entries, or the
Mamba2 and xLSTM recurrent states) it updates in place, slice by slice
(JAX scans the layers and donates the cache).

Under an active mesh with ``model > 1`` every family is tensor
parallel (``dist.tensor_parallel``): ``init`` keeps the rank's blocks of
the whole tree the seed draws, the blocks run the rank's heads and
"mlp" columns (the MoE every expert's, the Mamba2 and xLSTM blocks
their heads), ``forward`` returns the rank's vocab block of the logits
and ``lm_loss`` takes the vocab-parallel cross entropy.
``seq_parallel`` then splits the residual stream over the sequence
between blocks (the identity at ``model = 1`` or at one token, as JAX's
``_sp``; the VLM's split covers the patches and the text together; the
xLSTM's training forward refuses it at ``model > 1``, as JAX places no
boundary in its forward). Decoding runs on the serve profile's layout
(``tensor_parallel.active_decode``): the rank's rows of the slots where
``data`` splits them and its heads of the cache; ``decode_step`` returns
the rank's vocab block of the logits.

Knobs the slice does not carry raise ``NotImplementedError`` naming
their ROADMAP item (``check_supported``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM,
                                      VLM, ModelConfig)
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.dist import tensor_parallel
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import ParamFactory
from repro_torch.models.layers import (attention_apply, attention_init,
                                       cache_axes, causal_mask,
                                       check_flash_masks, chunks_queries,
                                       decode_attention, embed_tokens,
                                       embedding_init, init_kv_cache,
                                       mlp_apply, mlp_init, output_logits,
                                       prefix_lm_mask, rmsnorm, rmsnorm_init,
                                       scalar)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCK_REMATS = ("full", "dots", "none")
# JAX's checkpoint_dots saves the results of dot_general: here the
# matrix products autograd dispatches to
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}")
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every knob of ``cfg`` the port's transformer does not
    carry yet (never ignore one silently)."""
    if cfg.family == ENCDEC:
        raise ValueError("the encoder-decoder family is models/encdec.py's "
                         "(models.api.build_model sends it there)")
    if cfg.family not in (DENSE, HYBRID, MOE, SSM, VLM):
        raise ValueError(f"unknown model family {cfg.family!r}")
    if cfg.family == VLM and not cfg.frontend:
        raise ValueError("a vlm model needs its frontend stub (frontend, "
                         "n_frontend_tokens): JAX's model builds no patch "
                         "projection without one and fails on the patches")
    if cfg.family == SSM and cfg.xlstm is None:
        raise ValueError("an ssm (xLSTM) model needs an xlstm config")
    if cfg.family == HYBRID:
        k = cfg.shared_attn_every
        if cfg.ssm is None or k <= 0 or cfg.n_layers % k:
            raise ValueError(
                f"a hybrid model needs an ssm config and n_layers "
                f"({cfg.n_layers}) a multiple of shared_attn_every ({k})")
    if cfg.family == MOE:
        if cfg.moe is None:
            raise ValueError("a moe model needs a moe config")
        moe_mod.check_moe_impl(cfg)
    check_knobs(cfg)


def model_size() -> int:
    """The ``model`` axis of the active mesh (1 without one)."""
    from repro_torch.dist.context import active_mesh
    mesh = active_mesh()
    return 1 if mesh is None else mesh.model


def check_knobs(cfg: ModelConfig) -> None:
    """The checks every LM family shares (``models/encdec.py`` runs them
    too): the active mesh's ``model`` axis must carry the family and its
    widths (``tensor_parallel.check_model_blocks``; the training forward
    checks the rest, ``check_model_axis``), the remat, attention
    and scan knobs and the dtypes must be known, and the flash kernels
    must compute the config's masks."""
    tensor_parallel.check_model_blocks(cfg, model_size())
    if cfg.block_remat not in BLOCK_REMATS:
        raise ValueError(f"unknown block_remat {cfg.block_remat!r}; "
                         f"expected one of {BLOCK_REMATS}")
    if cfg.attn_impl not in ("xla", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    check_flash_masks(cfg)
    if cfg.scan_impl not in ssm_mod.SCAN_IMPLS:
        raise ValueError(f"unknown scan_impl {cfg.scan_impl!r}; expected "
                         f"one of {ssm_mod.SCAN_IMPLS}")
    _dtype(cfg.param_dtype)
    _dtype(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _layer_init(f: ParamFactory, cfg: ModelConfig):
    """One stacked layer's params (dense and vlm: attention + MLP; moe:
    attention + the MoE FFN; hybrid: a Mamba2 block)."""
    rmsnorm_init(f, "ln1", cfg.d_model)
    if cfg.family == HYBRID:
        ssm_mod.mamba2_init(f, cfg)
        return
    attention_init(f, cfg)
    rmsnorm_init(f, "ln2", cfg.d_model)
    if cfg.family == MOE:
        moe_mod.moe_init(f, cfg)
    else:
        mlp_init(f, cfg)


def init(cfg: ModelConfig, generator: Optional[torch.Generator],
         device, with_axes: bool = False) -> Dict:
    """The parameter tree on ``device``, drawn from the CPU
    ``generator`` (on ``meta``: shapes only, nothing drawn);
    ``with_axes``: (params, their logical axes). Under an active mesh
    with ``model > 1``: the rank's blocks of the whole tree."""
    check_supported(cfg)
    f = ParamFactory(generator, _dtype(cfg.param_dtype), device,
                     cut=tensor_parallel.param_cutter(cfg))
    embedding_init(f, cfg)
    rmsnorm_init(f, "ln_final", cfg.d_model)
    if cfg.family == SSM:
        # the two block types in two stacks, each block with its ln1
        n_ml, n_sl = xlstm_mod.n_blocks(cfg)
        for name, n, block_init in (("mlstm_layers", n_ml,
                                     xlstm_mod.mlstm_init),
                                    ("slstm_layers", n_sl,
                                     xlstm_mod.slstm_init)):
            f.stacked_children(name, n, lambda g, block_init=block_init: (
                rmsnorm_init(g, "ln1", cfg.d_model), block_init(g, cfg)))
        return (f.params, f.axes) if with_axes else f.params
    f.stacked_children("layers", cfg.n_layers, lambda g: _layer_init(g, cfg))
    if cfg.family == HYBRID:
        sh = f.child("shared_attn")
        rmsnorm_init(sh, "ln1", cfg.d_model)
        attention_init(sh, cfg)
        rmsnorm_init(sh, "ln2", cfg.d_model)
        mlp_init(sh, cfg)
    if cfg.family == VLM:
        # the stub frontend: a learned projection of the precomputed
        # patch embeddings and a positional table
        f.param("patch_proj", (cfg.d_model, cfg.d_model),
                ("embed", "embed2"))
        f.param("patch_pos", (cfg.n_frontend_tokens, cfg.d_model),
                (None, "embed"))
    return (f.params, f.axes) if with_axes else f.params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _block_apply(layer_p, cfg: ModelConfig, h, positions, mask,
                 mask_fn=None, tp=None):
    """One attention + FFN layer: (h, the layer's MoE aux loss, a 0-dim
    f32, 0 for a dense layer). Under ``tp`` the rank's heads and "mlp"
    columns (and under ``seq_parallel`` its sequence block of h)."""
    h = h + attention_apply(
        layer_p["attn"], cfg,
        rmsnorm(h, _norm_scale(layer_p["ln1"], tp), cfg.norm_eps),
        positions, mask, mask_fn, tp=tp)
    hn = rmsnorm(h, _norm_scale(layer_p["ln2"], tp), cfg.norm_eps)
    if cfg.family == MOE:
        y, aux = moe_mod.moe_apply(layer_p["moe"], cfg, hn, tp)
        return h + y, aux
    return h + mlp_apply(layer_p["mlp"], cfg, hn, tp), _zero(h.device)


def _norm_scale(scale, tp):
    """An RMSNorm scale as a block uses it (``tp.norm_scale``)."""
    return scale if tp is None else tp.norm_scale(scale)


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _mamba_block_apply(layer_p, cfg: ModelConfig, h, tp=None):
    hn = rmsnorm(h, _norm_scale(layer_p["ln1"], tp), cfg.norm_eps)
    return h + ssm_mod.mamba2_apply(layer_p["mamba"], cfg, hn, tp)


def _shared_attn_apply(sh, cfg: ModelConfig, h, positions, mask,
                       mask_fn=None, tp=None):
    hn = rmsnorm(h, _norm_scale(sh["ln1"], tp), cfg.norm_eps)
    return h + attention_apply(sh["attn"], cfg, hn, positions, mask,
                               mask_fn, tp=tp)


def _mlstm_layer(lp, cfg: ModelConfig, h, tp=None):
    return xlstm_mod.mlstm_block_apply(
        lp["mlstm"], cfg, rmsnorm(h, lp["ln1"], cfg.norm_eps), tp)


def _slstm_layer(lp, cfg: ModelConfig, h, tp=None):
    return xlstm_mod.slstm_block_apply(
        lp["slstm"], cfg, rmsnorm(h, lp["ln1"], cfg.norm_eps), tp=tp)[0]


def _xlstm_forward(params, cfg: ModelConfig, h, remat, tp=None):
    """The mLSTM and sLSTM blocks in their true layer order, each a
    residual block under ``remat`` (under ``tp`` on the rank's
    heads)."""
    ml = iter(unbind_layers(params["mlstm_layers"]))
    sl = iter(unbind_layers(params["slstm_layers"]))
    for i in range(cfg.n_layers):
        if xlstm_mod.is_slstm(cfg, i):
            h = h + _apply(remat, _slstm_layer, next(sl), cfg, h, tp)
        else:
            h = h + _apply(remat, _mlstm_layer, next(ml), cfg, h, tp)
    return h


def _hybrid_forward(params, cfg: ModelConfig, h, positions, mask, remat,
                    mask_fn=None, tp=None):
    """zamba2: groups of ``shared_attn_every`` Mamba2 layers, the one
    shared attention + MLP block after each group (its leaves' gradients
    add up over the applications)."""
    k = cfg.shared_attn_every
    sh = params["shared_attn"]
    layers = unbind_layers(params["layers"])
    for g0 in range(0, cfg.n_layers, k):
        for layer_p in layers[g0:g0 + k]:
            h = _apply(remat, _mamba_block_apply, layer_p, cfg, h, tp)
        h = _apply(remat, _shared_attn_apply, sh, cfg, h, positions, mask,
                   mask_fn, tp)
        hn = rmsnorm(h, _norm_scale(sh["ln2"], tp), cfg.norm_eps)
        h = h + mlp_apply(sh["mlp"], cfg, hn, tp)
    return h


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _apply(remat: str, fn, *args):
    """``fn(*args)`` under ``block_remat`` ``remat``: "full" saves only
    the inputs (``torch.utils.checkpoint``), "dots" the matrix products'
    outputs as well (selective checkpointing), "none" everything."""
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return fn(*args)


def unbind_layers(stacked) -> list:
    """The stacked layer tree as a list of per-layer trees (views)."""
    leaves, treedef = tree_flatten(stacked)
    per_leaf = [torch.unbind(leaf, 0) for leaf in leaves]
    n = len(per_leaf[0])
    return [tree_unflatten(treedef, [p[i] for p in per_leaf])
            for i in range(n)]


def forward(params, cfg: ModelConfig, tokens, *, extra: Optional[Dict] = None,
            prefix_len=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S_text) int -> (logits (B, S, padded vocab) in the
    compute dtype, the MoE aux loss summed over the layers: a 0-dim f32,
    0 for the other families), JAX's signature. For the VLM,
    ``extra["patches"]`` (B, P, d) goes in front of the text (S = P +
    S_text). Under ``prefix_lm`` the first ``prefix_len`` positions
    (default n_frontend_tokens for the VLM, 0 otherwise, as in JAX)
    attend to each other both ways. Under tensor parallelism the logits
    are the rank's vocab block (B, S, padded vocab / model)."""
    return _forward(params, cfg, tokens, extra, prefix_len,
                    tensor_parallel.active(cfg, _length(cfg, tokens, extra)))


def _length(cfg: ModelConfig, tokens, extra) -> int:
    """The positions the forward runs (and ``seq_parallel`` splits): the
    VLM's patches in front of its text."""
    if cfg.family == VLM and extra is not None and "patches" in extra:
        return extra["patches"].shape[1] + tokens.shape[1]
    return tokens.shape[1]


def _forward(params, cfg: ModelConfig, tokens, extra, prefix_len, tp):
    """``forward`` under the tensor parallelism ``tp`` (None: none)."""
    dtype = _dtype(cfg.compute_dtype)
    h = embed_tokens(params, tokens, dtype) * scalar(math.sqrt(cfg.d_model),
                                                     dtype)
    if cfg.family == VLM and extra is not None and "patches" in extra:
        patches = extra["patches"].to(dtype) @ params["patch_proj"].to(dtype)
        patches = patches + params["patch_pos"].to(dtype)[None]
        h = torch.cat([patches, h], dim=1)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device)[None, :]
    if cfg.prefix_lm:
        plen = prefix_len if prefix_len is not None else (
            cfg.n_frontend_tokens if cfg.family == VLM else 0)
        mask_fn = lambda off, qn: prefix_lm_mask(qn, S, plen, h.device,
                                                 q_offset=off)
    else:
        mask_fn = lambda off, qn: causal_mask(
            qn, S, h.device, window=cfg.sliding_window, q_offset=off)
    # the whole (S, S) mask only where the plain core takes it unchunked
    mask = (None if cfg.family == SSM or cfg.attn_impl == "flash"
            or chunks_queries(S) else mask_fn(0, S))
    remat = cfg.block_remat if torch.is_grad_enabled() else "none"
    aux_total = _zero(h.device)
    ln_final = params["ln_final"]
    if tp is not None:
        h = tp.split_seq(h)
        ln_final = tp.norm_scale(ln_final)
    if cfg.family == SSM:
        h = _xlstm_forward(params, cfg, h, remat, tp)
    elif cfg.family == HYBRID:
        h = _hybrid_forward(params, cfg, h, positions, mask, remat, mask_fn,
                            tp)
    else:
        for layer_p in unbind_layers(params["layers"]):
            h, aux = _apply(remat, _block_apply, layer_p, cfg, h, positions,
                            mask, mask_fn, tp)
            aux_total = aux_total + aux
    h = rmsnorm(h, ln_final, cfg.norm_eps)
    return output_logits(params, cfg, h, tp), aux_total


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """Per-sample-weighted next-token cross entropy.

    batch: {"tokens": (B, S) int, "weights": (B,) f32, the VLM's
    "patches"}. Returns (sum of the weighted loss + the MoE aux loss
    times the count, {"count": weighted token count, "loss_sum": the
    weighted loss without aux}), so AMB-DG normalizes by the global
    count (paper eq. (5)). The forward runs at the full length and the
    logits are sliced, as in JAX: the VLM's patch positions first, then
    the last position."""
    tokens = batch["tokens"]
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones((tokens.shape[0],), dtype=torch.float32,
                             device=tokens.device)
    extra = {k: v for k, v in batch.items()
             if k not in ("tokens", "weights", "targets")}
    extra = extra or None
    tp = tensor_parallel.active(cfg, _length(cfg, tokens, extra))
    logits, aux = _forward(params, cfg, tokens, extra, None, tp)
    if cfg.family == VLM and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    loss_sum, count = next_token_loss(logits, tokens, weights, tp)
    return loss_sum + aux * count, {"count": count, "loss_sum": loss_sum}


def next_token_loss(logits, tokens, weights, tp=None):
    """(the weighted sum of the next-token cross entropy of ``logits``
    (B, S, V) at positions 0..S-2 against ``tokens`` (B, S) at 1..S-1, in
    f32; the weighted token count). Under ``tp`` the logits are the
    rank's vocab block and the softmax spans every rank's
    (``TensorParallel.cross_entropy``)."""
    targets = tokens[:, 1:].to(torch.int64)
    if tp is not None:
        ll = tp.cross_entropy(logits[:, :-1].to(torch.float32), targets)
    else:
        logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    per_sample = -torch.sum(ll, dim=-1)                       # (B,)
    loss_sum = torch.sum(per_sample * weights)
    count = torch.sum(weights) * targets.shape[1]
    return loss_sum, count


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cpu"
                      ) -> Tuple[Dict, Dict]:
    """(the decode cache, its logical-axes tree): DENSE, VLM and MOE, the
    KV cache of every layer (a rolling buffer under a sliding window);
    HYBRID, {"mamba": the f32 Mamba2 states of every layer,
    "shared": the KV cache of each of the n_layers // shared_attn_every
    applications of the shared block}; SSM, {"mlstm": {"C", "n", "m"},
    "slstm": {"h", "c", "n", "m"}}, the f32 recurrent states of each
    stack (``dtype`` and ``max_len`` unused, as in JAX; each ``m`` starts
    at its block's own floor, NEG_INF and SLSTM_M0). Under an active
    mesh: the rank's block of the cache of ``batch`` slots
    (``tensor_parallel.cache_dims``: its rows of the slots where
    ``data`` splits them, ``slot_rows``; its heads at ``model > 1``)."""
    check_supported(cfg)
    tp = tensor_parallel.active_decode(cfg)
    batch = tensor_parallel.slot_rows(batch).size
    if cfg.family == SSM:
        n_ml, n_sl = xlstm_mod.n_blocks(cfg)
        cache = {"mlstm": xlstm_mod.mlstm_state_init(cfg, n_ml, batch,
                                                     device, tp),
                 "slstm": xlstm_mod.slstm_state_init(cfg, n_sl, batch,
                                                     device, tp)}
        return cache, xlstm_mod.state_axes()
    if cfg.family == HYBRID:
        cache = {
            "mamba": ssm_mod.mamba2_state_init(cfg, cfg.n_layers, batch,
                                               device=device, tp=tp),
            "shared": init_kv_cache(cfg, cfg.n_layers // cfg.shared_attn_every,
                                    batch, max_len, dtype, device, tp),
        }
        return cache, {"mamba": ssm_mod.mamba2_state_axes(),
                       "shared": cache_axes(cfg)}
    return (init_kv_cache(cfg, cfg.n_layers, batch, max_len, dtype, device,
                          tp),
            cache_axes(cfg))


def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """One-token decode. tokens (B, 1) int; pos a scalar (lockstep) or
    (B,) per-slot positions (continuous batching; see
    ``layers.decode_attention``). The cache is updated in place, layer
    by layer (the xLSTM's recurrence reads no position). Returns
    (logits (B, 1, padded vocab), cache). Under an active mesh B is the
    rank's rows of the cache (``init_decode_state``); at ``model > 1``
    every block runs the rank's heads and "mlp" columns
    (``tensor_parallel.active_decode``) and the logits are the rank's
    vocab block (B, 1, padded vocab / model), whose argmax over every
    rank's is ``tensor_parallel.vocab_argmax``."""
    check_supported(cfg)
    tp = tensor_parallel.active_decode(cfg)
    dtype = _dtype(cfg.compute_dtype)
    h = embed_tokens(params, tokens, dtype) * scalar(math.sqrt(cfg.d_model),
                                                     dtype)
    if cfg.family == SSM:
        h = _xlstm_decode(params, cfg, h, cache, tp)
    elif cfg.family == HYBRID:
        h = _hybrid_decode(params, cfg, h, cache, pos, tp)
    else:
        for i, layer_p in enumerate(unbind_layers(params["layers"])):
            hn = rmsnorm(h, layer_p["ln1"], cfg.norm_eps)
            y, _, _ = decode_attention(layer_p["attn"], cfg, hn, pos,
                                       cache["k"][i], cache["v"][i], tp)
            h = h + y
            hn = rmsnorm(h, layer_p["ln2"], cfg.norm_eps)
            if cfg.family == MOE:
                # the (B, 1, d) step routed as a group of B tokens; its
                # aux loss is dropped, as in JAX
                y, _ = moe_mod.moe_apply(layer_p["moe"], cfg, hn, tp)
            else:
                y = mlp_apply(layer_p["mlp"], cfg, hn, tp)
            h = h + y
    h = rmsnorm(h, params["ln_final"], cfg.norm_eps)
    return output_logits(params, cfg, h, tp), cache


def _hybrid_decode(params, cfg: ModelConfig, h, cache, pos, tp=None):
    """zamba2's decode: each Mamba2 layer's recurrence, the shared block
    after every ``shared_attn_every`` layers with its own KV cache per
    application (under ``tp`` on the rank's heads)."""
    k = cfg.shared_attn_every
    sh = params["shared_attn"]
    mamba, shared = cache["mamba"], cache["shared"]
    for i, layer_p in enumerate(unbind_layers(params["layers"])):
        hn = rmsnorm(h, layer_p["ln1"], cfg.norm_eps)
        y, _, _ = ssm_mod.mamba2_decode(layer_p["mamba"], cfg, hn,
                                        mamba["ssm"][i], mamba["conv"][i],
                                        tp)
        h = h + y
        if (i + 1) % k == 0:
            g = i // k
            hn = rmsnorm(h, sh["ln1"], cfg.norm_eps)
            y, _, _ = decode_attention(sh["attn"], cfg, hn, pos,
                                       shared["k"][g], shared["v"][g], tp)
            h = h + y
            h = h + mlp_apply(sh["mlp"], cfg,
                              rmsnorm(h, sh["ln2"], cfg.norm_eps), tp)
    return h


def _xlstm_decode(params, cfg: ModelConfig, h, cache, tp=None):
    """The xLSTM's decode: each block's recurrence in layer order, its
    slice of the stacked state updated in place (under ``tp`` the rank's
    heads; an sLSTM block's output is gathered whole for its FFN)."""
    ml = unbind_layers(params["mlstm_layers"])
    sl = unbind_layers(params["slstm_layers"])
    m_st, s_st = cache["mlstm"], cache["slstm"]
    ml_i = sl_i = 0
    for i in range(cfg.n_layers):
        if xlstm_mod.is_slstm(cfg, i):
            lp = sl[sl_i]
            st = tuple(s_st[k][sl_i] for k in ("h", "c", "n", "m"))
            y, out = xlstm_mod.slstm_block_apply(
                lp["slstm"], cfg, rmsnorm(h, lp["ln1"], cfg.norm_eps), st,
                tp)
            for view, new in zip(st, out):
                view.copy_(new)
            sl_i += 1
        else:
            lp = ml[ml_i]
            y, _ = xlstm_mod.mlstm_block_decode(
                lp["mlstm"], cfg, rmsnorm(h, lp["ln1"], cfg.norm_eps),
                {k: m_st[k][ml_i] for k in ("C", "n", "m")}, tp)
            ml_i += 1
        h = h + y
    return h
