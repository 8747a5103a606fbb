"""Closed-form per-device wire models of the exchange paths (the port of
``repro/launch/wire_model.py``).

Each function returns ``{dtype: per-device wire bytes}``, split by the
payload's dtype in JAX's short names ("f32", "s8", "u16"), with the ring
algorithm's integer formulas:

  all-reduce  2 (n-1)/n * P        all-gather  (n-1)/n * P_gathered

``dist.collectives`` adds every call's bytes to its census with the same
formulas, so a run holds census == model with ``==``, no tolerance.

``master_pod_exchange_bytes``  the fixed-delay ring pop across the
    ``pod`` axis. int8: one s8 all-gather of the due slot and one f32
    all-gather of its row scales, then a local fold
    (``ring_slot_rotate_int8_sharded``). Uncompressed: one f32
    all-reduce of the slot.

``variable_pod_exchange_bytes``  the delay-tolerant (v3) ring pop: each
    pod folds its due slots locally and ships one f32 all-reduce, int8
    or not (``ring_variable_pop_sharded``).

``gossip_round_bytes``  one decentralized gossip round a worker: its
    total is ``consensus.payload_bytes_per_round``, split s8 payload /
    bf16 scales as their u16 bits under int8.

``publish_pop_bytes``  the weight publication's pop: the s8 snapshot
    and its bf16 scales (as u16 bits) all-gathered over the shards.

``model_axis_bytes``  one AMB-DG step of an LM under tensor
    parallelism, on the ``model`` axis (``dist.tensor_parallel`` and
    ``core.ambdg``'s bridges), keyed by (census tag, dtype).

``decode_axis_bytes``  one continuous-batching decode step of an LM on
    the serve profile's layout (``serve.engine``), keyed by (census tag,
    dtype): the blocks' all-reduces and gathers over ``model``, the
    argmax's exchange, the next tokens' gather over ``data``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core import consensus

LANES = 128


def _allreduce(n: int, p_bytes: int) -> int:
    return 2 * (n - 1) * p_bytes // max(n, 1)


def _allgather(n: int, gathered_bytes: int) -> int:
    return (n - 1) * gathered_bytes // max(n, 1)


def master_pod_exchange_bytes(rows: int, n_pods: int, compression: str,
                              lanes: int = LANES) -> Dict[str, int]:
    """The fixed-delay ring pop across the pod axis, per device."""
    if n_pods <= 1:
        return {}
    if compression == "int8":
        return {
            # s8 all-gather of the due slot: gathered (n_pods, rows, lanes)
            "s8": _allgather(n_pods, n_pods * rows * lanes),
            # f32 all-gather of its row scales: (n_pods, rows)
            "f32": _allgather(n_pods, n_pods * rows * 4),
        }
    # uncompressed: one f32 all-reduce of the (rows, lanes) slot
    return {"f32": _allreduce(n_pods, rows * lanes * 4)}


def variable_pod_exchange_bytes(rows: int, n_pods: int,
                                lanes: int = LANES) -> Dict[str, int]:
    """The delay-tolerant (v3) ring pop: one f32 all-reduce of the
    locally folded due rows, whatever the compression."""
    if n_pods <= 1:
        return {}
    return {"f32": _allreduce(n_pods, rows * lanes * 4)}


def gossip_round_bytes(topology: str, n_workers: int, rows: int,
                       compression: str = "none",
                       lanes: int = LANES) -> Dict[str, int]:
    """One gossip round a worker, split by wire dtype. The total equals
    ``consensus.payload_bytes_per_round`` (asserted, so the two models
    cannot drift apart)."""
    total = consensus.payload_bytes_per_round(
        topology, n_workers, rows, lanes=lanes, compression=compression)
    n_terms = sum(1 for nbr, _ in
                  consensus.topology_stencil(topology, n_workers)
                  if not consensus._is_self_term(nbr))
    if compression == "int8":
        out = {"s8": n_terms * rows * lanes,   # the quantized message
               "u16": n_terms * rows * 2}      # bf16 scales as u16 bits
    else:
        out = {"f32": n_terms * rows * lanes * 4}
    assert sum(out.values()) == total, (out, total)
    return out


def publish_pop_bytes(rows: int, n_shards: int,
                      lanes: int = LANES) -> Dict[str, int]:
    """The publication pop: the flat-sharded s8 snapshot and its bf16
    scales (as their u16 bits) gathered to every server device, per
    device."""
    if n_shards <= 1:
        return {}
    return {
        "s8": _allgather(n_shards, rows * lanes),
        "u16": _allgather(n_shards, rows * 2),
    }


_BYTES = {"float32": 4, "bfloat16": 2}
_SHORT = {"float32": "f32", "bfloat16": "bf16"}


def model_axis_bytes(cfg, layout, dims, micro_batch: int, seq: int,
                     n_micro: int, n_model: int, compression: str = "none",
                     n_data: int = 1, n_pods: int = 1,
                     src_seq: Optional[int] = None
                     ) -> Dict[Tuple[str, str], int]:
    """One AMB-DG step of the LM ``cfg`` a rank, on the ``model`` axis of
    ``n_model`` ranks: {(census tag, dtype): bytes}. ``layout`` is the
    whole tree's arena layout and ``dims`` each leaf's model cut
    (``tensor_parallel.model_dims``); the rank runs ``n_micro``
    microbatches of ``micro_batch`` sequences of ``seq`` positions (the
    VLM's patches and text together; the encoder-decoder's target, its
    source ``src_seq``, by default ``seq``). Counted from the shapes, per
    microbatch (X = b T d for a stream of T positions).

    Each tensor-parallel block (``enter`` ... ``exit``) costs, without
    ``seq_parallel``, an f32 all-reduce of X forward (its exit) and one
    backward (its enter); with it, a gather of X in the compute dtype
    and an f32 reduce-scatter of X each way. Under ``block_remat=
    "full"`` the recomputed forward adds a block's enter (a gather
    under ``seq_parallel``) and, where the checkpoint's recomputation
    runs on past it, its exit (torch stops at the last tensor the
    backward needs): a dense / MoE / VLM layer is attention (both
    recomputed) then the FFN (enter only); an encoder layer likewise, a
    decoder layer self-attention and cross-attention (both) then the FFN
    (enter only); zamba2's Mamba2 layers and shared attention are
    checkpoints of their own (enter only), its shared MLP none; an
    mLSTM block is one block (enter only), an sLSTM block an enter
    without an exit (its FFN runs whole on every rank). The head's enter
    adds one block half (backward; under ``seq_parallel`` a gather
    forward, a reduce-scatter back), and so does the encoder-decoder's
    memory, entered once for every decoder layer; each split stream's
    embedding adds one gather back. The tags:

      tp_act    the blocks' all-reduces (no ``seq_parallel``);
      tp_seq    the blocks' gathers and reduce-scatters
                (``seq_parallel``);
      tp_loss   the cross entropy's three f32 all-reduces of b (S - 1),
                S the text (the VLM's loss skips its patches);
      tp_router the MoE gates' f32 all-reduce of (b S, top_k) backward
                a layer, and under ``seq_parallel`` the router's gather
                of X forward (again when recomputed);
      tp_norm   the Mamba2 gated norm's and the mLSTM norm's f32
                all-reduce of (b, S), forward and backward (and
                recomputed);
      tp_feat   the xLSTM's feature gathers: an mLSTM's ``a`` (b, S,
                d_in) forward (and recomputed), its f32 reduce-scatter
                backward; an sLSTM's output (b, S, d) forward (and
                recomputed);
      tp_param  the backward of each whole parameter a rank uses a part
                of (an f32 all-reduce): q_norm and k_norm, the whole kv
                leaves (the cross-attention's too), the norms' scales
                under ``seq_parallel`` (per application of zamba2's
                shared block; the encoder-decoder's ``ln_enc_final``),
                Mamba2's ``a_log``, ``dt_bias``, ``d_skip`` and the B / C
                columns of ``w_in``, ``w_conv`` and ``b_conv``, the
                mLSTM's ``b_i`` and ``b_f``, the sLSTM's ``w_h``; a tied
                table's vocab rows (all-gather);

    and a step: "grad_leaves" (each model-cut leaf's f32 gradient
    blocks all-gathered), and, where the arena's rows split over
    ``model`` alone, "w_rows", "metrics", "scales_max" (int8) and, in a
    world of ``n_model`` ranks, "pod_counts"."""
    from repro_torch.configs.base import ENCDEC, HYBRID, MOE, SSM, VLM
    from repro_torch.dist.tensor_parallel import Segments
    m = n_model
    if m <= 1:
        return {}
    act, pdt = cfg.compute_dtype, cfg.param_dtype
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim
    b = micro_batch
    if cfg.block_remat not in ("full", "none"):
        raise ValueError("model_axis_bytes counts block_remat 'full' and "
                         f"'none', not {cfg.block_remat!r}")
    full = cfg.block_remat == "full"
    out: Dict[Tuple[str, str], int] = {}

    def add(tag, dtype, n):
        if n:
            out[(tag, _SHORT.get(dtype, dtype))] = \
                out.get((tag, _SHORT.get(dtype, dtype)), 0) + n

    src = seq if src_seq is None else src_seq
    text = seq - cfg.n_frontend_tokens if cfg.family == VLM else seq
    sp = cfg.seq_parallel and seq > 1 and src > 1
    x, x_src = b * seq * d, b * src * d
    # the blocks of a forward: (X, enter recomputed, exit recomputed,
    # has an exit)
    if cfg.family == HYBRID:
        n_apps = L // cfg.shared_attn_every
        blocks = ([(x, full, False, True)] * (L + n_apps)
                  + [(x, False, False, True)] * n_apps)
    elif cfg.family == ENCDEC:
        blocks = ([(x_src, full, full, True), (x_src, full, False, True)]
                  * cfg.n_encoder_layers
                  + [(x, full, full, True)] * 2 * L
                  + [(x, full, False, True)] * L)
    elif cfg.family == SSM:
        from repro_torch.models.xlstm import is_slstm
        slstm = [is_slstm(cfg, i) for i in range(L)]
        blocks = [(x, full, False, not s) for s in slstm]
    else:
        blocks = [(x, full, full, True), (x, full, False, True)] * L
    # the blocks' extra halves (the head's enter, the memory's) and the
    # split streams
    halves = [x] + ([x_src] if cfg.family == ENCDEC else [])
    splits = [x] + ([x_src] if cfg.family == ENCDEC else [])
    # the whole attention leaves a rank uses a part of, per application
    attn_whole = []
    kv_whole = []
    if cfg.n_kv_heads % m:
        kv = cfg.n_kv_heads * hd
        kv_whole = [d * kv, d * kv] + ([kv, kv] if cfg.qkv_bias else [])
    if cfg.qk_norm:
        attn_whole += [hd, hd]
    attn_whole += kv_whole
    norms = [d, d] if sp else []
    whole = []
    if cfg.family == HYBRID:
        from repro_torch.models.ssm import mamba2_dims
        nh = mamba2_dims(cfg)[1]
        bc = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        whole += L * ([nh, nh, nh, d * bc, cfg.ssm.d_conv * bc, bc]
                      + ([d] if sp else []))
        whole += n_apps * (attn_whole + norms)
    elif cfg.family == ENCDEC:
        whole += cfg.n_encoder_layers * (attn_whole + norms)
        whole += L * (attn_whole + kv_whole + norms + ([d] if sp else []))
        if sp:
            whole.append(d)                               # ln_enc_final
    elif cfg.family == SSM:
        from repro_torch.models.xlstm import mlstm_dims, slstm_dims
        d_in, nh, _ = mlstm_dims(cfg)
        s_hd = slstm_dims(cfg)[1]
        whole += [nh * s_hd * 4 * s_hd for s in slstm if s]    # w_h
        whole += [nh] * 2 * slstm.count(False)              # b_i, b_f
    else:
        whole += L * (attn_whole + norms)
    if sp:
        whole.append(d)                                   # ln_final
    for _ in range(n_micro):
        if sp:
            gathers = [(2 + e) * bx for bx, e, _, _ in blocks] + halves \
                + splits
            scatters = [(2 + x_) * bx for bx, _, x_, _ in blocks] + halves
            add("tp_seq", act, sum(_allgather(m, g * _BYTES[act])
                                   for g in gathers))
            add("tp_seq", "float32", sum((m - 1) * n * 4 // m
                                         for n in scatters))
        else:
            reds = [(2 + x_ if ex else 1) * bx
                    for bx, _, x_, ex in blocks] + halves
            add("tp_act", "float32", sum(_allreduce(m, r * 4)
                                         for r in reds))
        add("tp_loss", "float32", 3 * _allreduce(m, b * (text - 1) * 4))
        if cfg.family == MOE:
            gates = _allreduce(m, b * seq * cfg.moe.top_k * 4)
            route = (1 + full) * _allgather(m, x * _BYTES[act]) if sp else 0
            add("tp_router", "float32", L * gates)
            add("tp_router", act, L * route)
        if cfg.family == HYBRID:
            add("tp_norm", "float32",
                L * (2 + full) * _allreduce(m, b * seq * 4))
        if cfg.family == SSM:
            n_ml = slstm.count(False)
            add("tp_norm", "float32",
                n_ml * (2 + full) * _allreduce(m, b * seq * 4))
            add("tp_feat", act, (1 + full) * (
                n_ml * _allgather(m, b * seq * d_in * _BYTES[act])
                + (L - n_ml) * _allgather(m, x * _BYTES[act])))
            add("tp_feat", "float32",
                n_ml * (m - 1) * b * seq * d_in * 4 // m)
        add("tp_param", "float32", sum(_allreduce(m, n * 4) for n in whole))
        if cfg.tie_embeddings:
            add("tp_param", pdt,
                _allgather(m, cfg.padded_vocab_size * d * _BYTES[pdt]))

    def gathered(size, dim):
        """A cut leaf's elements all-gathered: every rank's block."""
        if not isinstance(dim, Segments):
            return size
        cols = sum(s for _, s, _ in dim.parts)
        return m * (size // cols) * sum(w for _, w, _ in dim.local_parts(m))

    add("grad_leaves", pdt, sum(
        _allgather(m, gathered(size, dim) * _BYTES[pdt])
        for size, dim in zip(layout.sizes, dims) if dim is not None))
    if n_data == 1:
        add("w_rows", "float32", _allgather(m, layout.rows * LANES * 4))
        add("metrics", "float32", _allreduce(m, 4))
        if compression == "int8":
            add("scales_max", "float32",
                _allreduce(m, (layout.n_leaves + 1) * 4))
        if n_pods == 1:
            add("pod_counts", "float32", (m - 1) * 8)
    return out


def decode_axis_bytes(cfg, slots: int, n_model: int, n_data: int = 1
                      ) -> Dict[Tuple[str, str], int]:
    """One decode step of the LM ``cfg`` a rank (``serve.engine``'s
    ``continuous_decode_step``) serving ``slots`` slots on a mesh with
    ``n_model`` model and ``n_data`` data ranks: {(census tag, dtype):
    bytes}, counted from the shapes. A rank holds b = slots / n_data
    rows where ``n_data`` divides the slots, else every slot. The step
    runs forward only, one token a row (X = b d), without
    ``seq_parallel``: a block's ``enter`` is a copy and moves nothing.

      tp_act    each block's exit, an f32 all-reduce of X: a dense / MoE
                / VLM layer's attention and FFN, a decoder layer's self-
                and cross-attention and MLP (the encoder does not run),
                each Mamba2 layer and each application of zamba2's
                shared attention and MLP, each mLSTM block (an sLSTM
                block has no exit: its FFN runs whole on every rank);
      tp_norm   the Mamba2 gated norm's and the mLSTM norm's f32
                all-reduce of (b,);
      tp_feat   the mLSTM's ``a`` (b, d_in) and the sLSTM's output
                (b, d) all-gathered in the compute dtype;
      tp_logits the argmax's (value, index) f64 pair a row, all-gathered
                over ``model``;
      slots     the next tokens, (b,) s32, all-gathered over ``data``
                (where ``data`` splits the slots)."""
    from repro_torch.configs.base import ENCDEC, HYBRID, SSM
    m = n_model
    split = n_data > 1 and slots % n_data == 0
    b = slots // n_data if split else slots
    act = cfg.compute_dtype
    L, d = cfg.n_layers, cfg.d_model
    out: Dict[Tuple[str, str], int] = {}

    def add(tag, dtype, n):
        if n:
            key = (tag, _SHORT.get(dtype, dtype))
            out[key] = out.get(key, 0) + n

    if split:
        add("slots", "s32", _allgather(n_data, n_data * b * 4))
    if m <= 1:
        return out
    x = _allreduce(m, b * d * 4)
    if cfg.family == HYBRID:
        n_apps = L // cfg.shared_attn_every
        add("tp_act", "float32", (L + 2 * n_apps) * x)
        add("tp_norm", "float32", L * _allreduce(m, b * 4))
    elif cfg.family == ENCDEC:
        add("tp_act", "float32", 3 * L * x)
    elif cfg.family == SSM:
        from repro_torch.models.xlstm import mlstm_dims, n_blocks
        n_ml, n_sl = n_blocks(cfg)
        add("tp_act", "float32", n_ml * x)
        add("tp_norm", "float32", n_ml * _allreduce(m, b * 4))
        add("tp_feat", act, n_ml * _allgather(
            m, b * mlstm_dims(cfg)[0] * _BYTES[act])
            + n_sl * _allgather(m, b * d * _BYTES[act]))
    else:
        add("tp_act", "float32", 2 * L * x)
    add("tp_logits", "f64", _allgather(m, m * b * 16))
    return out
