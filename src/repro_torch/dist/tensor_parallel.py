"""Tensor parallelism over the mesh's ``model`` axis for every LM
family: the collectives GSPMD inserts for the JAX package's train
profile (``dist.sharding``: "heads", "mlp" and "vocab" on ``model``),
written out, and the rule that cuts each rank's parameters.

The layout (Megatron's, on JAX's specs):

  * ``wq``, ``wk``, ``wv`` and their biases are column-parallel, cut by
    whole heads: rank m runs query heads [m H/M, (m+1) H/M) and the kv
    heads they group with; ``wo`` is row-parallel. Where ``n_kv_heads
    % M != 0`` (chatglm3's 2 kv heads at M = 4, paligemma's one) each
    rank keeps ``wk``, ``wv``, ``bk`` and ``bv`` whole and slices the kv
    head it needs (JAX's resolver would cut such a head in half, which a
    hand-written split cannot);
  * ``w_gate`` and ``w_up`` are column-parallel over "mlp", ``w_down``
    row-parallel;
  * ``tok_emb`` keeps its vocab dim whole (``(None, "embed")``); an
    untied ``out_head`` is vocab-parallel; a tied head multiplies by the
    rank's vocab rows of the table (``vocab_slice``, JAX's reshard at
    the use site);
  * the loss is the vocab-parallel cross entropy over the padded vocab
    (``cross_entropy``);
  * MoE: every expert's ``w_gate`` and ``w_up`` are column-parallel
    over "mlp", ``w_down`` row-parallel; the expert dim stays whole
    (JAX's profile has no entry for "expert"), and so does
    ``w_router``: every rank routes every token alike, from the
    residual input before ``enter`` (under ``seq_parallel`` from
    ``router_input``'s gather), and one ``exit`` follows the combine;
  * Mamba2: a rank runs the heads [m nh/M, (m+1) nh/M). JAX's "mlp" cut
    of the fused ``w_in`` columns [z | x | B | C | dt] (and of
    ``w_conv`` / ``b_conv``'s [x | B | C]) is one contiguous block,
    which straddles the parts; here each rank holds its heads' z, x and
    dt columns and the B and C columns whole (n_groups = 1: every head
    reads them), a ``Segments`` cut. ``a_log``, ``dt_bias`` and
    ``d_skip`` stay whole and are sliced to the rank's heads;
    ``norm_scale`` and ``w_out`` keep JAX's contiguous block (y is laid
    out head-major), and the gated norm's mean over the whole inner dim
    sums the ranks' parts (``sum``);
  * the encoder-decoder (``models.encdec``): the encoder's and the
    decoder's blocks as the dense ones; the cross-attention's q is
    column-parallel over the decoder stream, its K/V column-parallel
    over the encoder's output (the memory) on the rank's kv heads, its
    ``wo`` row-parallel. The memory is entered once, after the encoder,
    so its gradient, which autograd sums over the decoder layers first,
    is reduced once; ``frame_proj`` and ``ln_enc_final`` stay whole;
  * the VLM: the dense layers; the frontend stub's ``patch_proj`` and
    ``patch_pos`` stay whole (JAX's profile gives them no ``model``
    entry), every rank projecting every patch alike;
  * the xLSTM (``models.xlstm``): heads-parallel, a rank running nh/M of
    the mLSTM's heads and nh/M of the sLSTM's (``xlstm.xlstm_spec``
    says where the cut departs from JAX's contiguous blocks); the
    mLSTM's up-projection ``a`` is gathered along the features
    (``gather_features``), the sLSTM's output gathered whole before its
    FFN (``whole_features``), which every rank computes alike;
  * the weights stay whole over ``data`` (JAX's train profile puts
    "embed" there, FSDP; the port does not).

Decoding and serving (``active_decode``) take the same weight blocks,
on the serve profile's layout of JAX's ``continuous_decode_step``
(``sharding_profile(mesh, "serve")``, ``dist.sharding``):

  * the weights: each rank holds the blocks of the train layout above
    (``leaf_spec`` / ``param_cutter``, at init): whole heads of ``wq``,
    ``wk``, ``wv`` and the whole kv leaves where ``n_kv_heads % M`` is
    not 0, every expert's "mlp" columns, the Mamba2 ``Segments``, the
    xLSTM's cut (``xlstm.xlstm_spec``), the vocab blocks of
    ``out_head`` and of a tied table (``vocab_slice``). They stay whole
    over ``data``: JAX's serve profile stores the TP dims over the
    whole ``data x model`` slice, which the port leaves to ROADMAP
    A.11 part 2, item 9;
  * the decode cache (``cache_dims``): the slots over ``data`` where
    ``data`` divides them (``slot_rows``; otherwise every rank holds
    every slot, as JAX's resolver falls back), the KV cache and the
    encoder-decoder's ``mem_k`` / ``mem_v`` on the rank's kv heads (on
    the whole-kv route the one kv head its query heads read), the
    Mamba2 ``ssm`` state on its heads and the ``conv`` state cut by the
    ``Segments`` of ``w_conv`` (its x columns, B and C whole), the
    xLSTM's mLSTM ``C``, ``n``, ``m`` and sLSTM ``h``, ``c``, ``n``,
    ``m`` on its heads. Where JAX's resolver moves "heads" onto ``data
    x model`` because the slots fall back, the port keeps them on
    ``model`` (the weights' storage of item 9);
  * one token a step, so no ``seq_parallel`` (the serve profile
    resolves "seq_sp" to nothing): ``enter`` is a copy, ``exit`` an
    all-reduce; the logits are the rank's vocab block, and the next
    token is their distributed argmax (``vocab_argmax``: each rank's
    max and first index, exchanged over ``model``, ties to the lowest
    index as ``jnp.argmax``, the padded columns included), all-gathered
    over ``data`` (``gather_slots``) where the slots split there;
  * pods replicate: no serve axis names ``pod``, every pod runs the
    same slots and nothing crosses it.

The autograd ops, each a ``torch.autograd.Function``:

  copy        identity forward, all-reduce backward: before a
              column-parallel product, and on a whole parameter whose
              gradient each rank holds a part of (the whole kv leaves,
              ``q_norm``/``k_norm``, the norms' scales under
              ``seq_parallel``), so every replicated leaf's gradient is
              the same on every rank;
  reduce      all-reduce forward, identity backward: after a
              row-parallel product;
  gather_seq  under ``seq_parallel``: the sequence's all-gather before
              a block (backward: its reduce-scatter);
  scatter_seq the reduce-scatter of the sequence after it (backward:
              the all-gather);
  split_seq   the rank's sequence block of the embedding (backward: the
              all-gather);
  vocab_slice the rank's vocab rows of the tied table (backward: the
              all-gather of the rows' gradients over the vocab);
  sum         all-reduce forward and backward: the gated norm's sum of
              squares, which every rank's columns feed and read;
  router_input under ``seq_parallel``: the sequence's all-gather whose
              backward keeps the rank's own block (the router, which
              every rank computes whole);
  gates       a ``copy`` on the MoE's gates: each rank's combine sees
              its partial expert outputs, so the gates' gradient is
              summed before it reaches the softmax;
  gather_features the all-gather of the last (feature) dim, backward
              its reduce-scatter: the mLSTM's ``a``, whose whole every
              rank's heads read;
  whole_features  the all-gather of the feature dim whose backward
              keeps the rank's own block: the sLSTM's output before the
              FFN every rank computes whole.

Reductions run in f32 (a bf16 partial is widened first and the sum
rounded back once), gathers in the tensor's own dtype. Every call adds
its bytes to the census (``dist.collectives``) under axis "model":
"tp_act" (copy and reduce on activations), "tp_seq" (the sequence's
gathers and scatters), "tp_param" (copy on parameters, the tied
table's gather), "tp_loss" (the loss's three reductions), "tp_router"
(``gates`` and ``router_input``), "tp_norm" (``sum``), "tp_feat"
(``gather_features`` and ``whole_features``), "tp_logits" (the decode
argmax's exchange); ``core.ambdg``'s gradient bridge adds
"grad_leaves", and the decode's next tokens cross ``data`` under
"slots".
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)

# the attention leaves kept whole where the kv heads do not split
_KV_LEAVES = ("wk", "wv", "bk", "bv")
# the families the axis carries: every LM family
_FAMILIES = (DENSE, MOE, HYBRID, ENCDEC, VLM, SSM)
# the fused Mamba2 leaves (``models.ssm.mamba2_segments``)
_SEGMENTED = ("w_in", "w_conv", "b_conv")


class ModelAxis(NamedTuple):
    """This rank on the ``model`` axis: the group, its size and rank."""
    group: object
    n: int
    rank: int


def model_axis() -> Optional[ModelAxis]:
    """The ``model`` axis of the active mesh when it is larger than 1,
    else None; raises when such a mesh has no process group behind it
    (tensor parallelism never drops back to the whole weights)."""
    from repro_torch.dist.context import active_mesh
    mesh = active_mesh()
    if mesh is None or mesh.model == 1:
        return None
    from repro_torch.dist.collectives import require_mesh
    ranks = require_mesh("tensor parallelism over 'model'")
    return ModelAxis(ranks.group("model"), ranks.sizes["model"],
                     ranks.coords["model"])


def check_model_axis(cfg: ModelConfig, n: int) -> None:
    """Raise for a config the ``model`` axis of size ``n`` does not
    train: what ``check_model_blocks`` refuses, and the xLSTM under
    ``seq_parallel`` (``NotImplementedError``: JAX's xLSTM places no
    sequence-parallel boundary, and the sLSTM is a strict recurrence
    over the whole sequence). The training forward (``active``) checks
    it; building, init and decoding check ``check_model_blocks`` only,
    so such a config still serves."""
    check_model_blocks(cfg, n)
    if n > 1 and cfg.family == SSM and cfg.seq_parallel:
        raise NotImplementedError(
            f"seq_parallel=True on the xLSTM with model={n}: JAX's xLSTM "
            "forward places no sequence-parallel boundary, and the sLSTM "
            "is a strict recurrence over the whole sequence, so its "
            "blocks cannot run on a rank's sequence block")


def check_model_blocks(cfg: ModelConfig, n: int) -> None:
    """Raise for a config whose blocks the ``model`` axis of size ``n``
    does not cut: a family but the LM families
    (``NotImplementedError``), Mamba2's grouped B/C
    (``NotImplementedError``, ROADMAP A.11 part 2, item 6), or widths
    that do not split over ``n`` ranks by whole heads, whole kv groups,
    "mlp" columns, vocab rows, whole Mamba2 heads (HYBRID) and whole
    mLSTM / sLSTM heads (SSM) (``ValueError``). The MoE's expert count
    is not cut, nor is the sLSTM's FFN, which stays whole (its width,
    int(4/3 d), is odd in both xLSTM configs, so JAX's resolver keeps it
    whole too)."""
    if n == 1:
        return
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} on a mesh with model={n}: tensor "
            "parallelism over 'model' carries the LM families (dense, MoE, "
            "hybrid, encoder-decoder, VLM and xLSTM)")
    if cfg.family == HYBRID:
        from repro_torch.models.ssm import mamba2_dims
        if cfg.ssm.n_groups != 1:
            raise NotImplementedError(
                f"Mamba2 with n_groups={cfg.ssm.n_groups} on model={n}: "
                "the rank's heads read the one B/C group whole; grouped "
                "B/C columns are ROADMAP A.11 part 2, item 6")
        nh = mamba2_dims(cfg)[1]
        if nh % n:
            raise ValueError(f"{nh} Mamba2 heads do not split over "
                             f"model={n} ranks by whole heads")
    if cfg.n_heads % n:
        raise ValueError(f"{cfg.n_heads} attention heads do not split over "
                         f"model={n} ranks by whole heads")
    q_local = cfg.n_heads // n
    group = cfg.n_heads // cfg.n_kv_heads
    if cfg.n_kv_heads % n and group % q_local:
        raise ValueError(
            f"the {q_local} query heads of a rank (model={n}) straddle the "
            f"kv groups of {group} heads: each rank must hold whole kv "
            "groups or lie inside one")
    for what, dim in (("d_ff", cfg.d_ff),
                      ("padded_vocab_size", cfg.padded_vocab_size)):
        if dim % n:
            raise ValueError(f"{what}={dim} does not split over model={n} "
                             "ranks")


def local_heads(cfg: ModelConfig, ax: ModelAxis) -> Tuple[int, int, int,
                                                         bool]:
    """(query heads a rank, its first kv head, kv heads it runs, whether
    it slices them from the whole kv leaves)."""
    q_local = cfg.n_heads // ax.n
    if cfg.n_kv_heads % ax.n == 0:
        return q_local, 0, cfg.n_kv_heads // ax.n, False
    group = cfg.n_heads // cfg.n_kv_heads
    return q_local, ax.rank * q_local // group, 1, True


class Segments(NamedTuple):
    """A leaf whose ``model`` blocks are not one contiguous block of a
    dim: along ``dim`` the whole leaf is ``parts``, each (start, size,
    split); rank m of M holds block m of each split part (size / M
    columns) and each other part whole, in that order. The whole parts
    are the same on every rank: a join takes them from rank 0."""
    dim: int
    parts: Tuple[Tuple[int, int, bool], ...]

    def local_parts(self, n: int):
        """(offset, width, split) of each part in a rank's block."""
        out, ofs = [], 0
        for _, size, split in self.parts:
            width = size // n if split else size
            out.append((ofs, width, split))
            ofs += width
        return out

    def cut(self, whole: torch.Tensor, n: int, m: int) -> torch.Tensor:
        """Rank ``m``'s block of ``whole`` (a tensor of its own)."""
        cols = torch.cat([
            torch.arange(start + m * (size // n), start + (m + 1) *
                         (size // n)) if split
            else torch.arange(start, start + size)
            for start, size, split in self.parts])
        return whole.index_select(self.dim, cols.to(whole.device))

    def join(self, blocks) -> torch.Tensor:
        """The whole leaf from every rank's block (rank order)."""
        return torch.cat([
            b.narrow(self.dim, ofs, width)
            for ofs, width, split in self.local_parts(len(blocks))
            for b in (blocks if split else blocks[:1])], dim=self.dim)


def leaf_spec(cfg: ModelConfig, name: str, shape, axes, mesh):
    """The cut a rank takes of leaf ``name`` (its logical ``axes`` and
    whole ``shape``): JAX's train-profile spec restricted to its
    ``model`` entry (the weights stay whole over ``data``); no cut for
    the kv leaves where the kv heads do not split; a ``Segments`` for
    the Mamba2 leaves JAX's contiguous block would straddle; the
    xLSTM's heads-parallel cut (``xlstm.xlstm_spec``) where it departs
    from JAX's."""
    from repro_torch.dist.sharding import Spec, entry_axes, spec_for
    if name in _KV_LEAVES and cfg.n_kv_heads % mesh.model:
        return Spec()
    if cfg.family == HYBRID and name in _SEGMENTED:
        from repro_torch.models.ssm import mamba2_segments
        return mamba2_segments(cfg, name, len(shape))
    if cfg.family == SSM:
        from repro_torch.models.xlstm import xlstm_spec
        spec = xlstm_spec(cfg, name, len(shape))
        if spec is not None:
            return spec
    entries = [e if "model" in entry_axes(e) else None
               for e in spec_for(tuple(axes), tuple(shape), mesh)]
    while entries and entries[-1] is None:
        entries.pop()
    return Spec(*entries)


def shard_leaf(value, spec, mesh, coords):
    """The block of the whole leaf ``value`` the rank at ``coords``
    holds under ``leaf_spec``'s ``spec`` (a view for a ``Spec``)."""
    if isinstance(spec, Segments):
        return spec.cut(value, mesh.model, coords.get("model", 0))
    from repro_torch.dist.sharding import local_shard
    return local_shard(value, spec, mesh, coords)


def param_cutter(cfg: ModelConfig):
    """Under an active mesh with ``model > 1``: the hook
    ``models.common.ParamFactory`` cuts each drawn leaf with (this
    rank's block by ``leaf_spec``, a copy of its own); else None."""
    ax = model_axis()
    if ax is None:
        return None
    check_model_blocks(cfg, ax.n)
    from repro_torch.dist.context import active_mesh
    mesh, coords = active_mesh(), {"model": ax.rank}

    def cut(name, value, axes):
        spec = leaf_spec(cfg, name, value.shape, axes, mesh)
        return shard_leaf(value, spec, mesh, coords).clone() if spec \
            else value
    return cut


def model_dims(cfg: ModelConfig, layout, axes_tree, mesh):
    """For each leaf of the whole tree's ``layout`` (sorted-key order):
    how its ``model`` block is cut, the dim of a contiguous block, a
    ``Segments``, or None for a whole leaf."""
    specs = _leaf_specs(cfg, layout, axes_tree, mesh)
    return [spec if isinstance(spec, Segments) else
            next((d for d, e in enumerate(spec) if e is not None), None)
            for _, spec in specs]


def param_specs(cfg: ModelConfig, layout, axes_tree, mesh):
    """{path in the parameter tree ("layers/attn/wq"): its ``leaf_spec``}
    of each leaf a rank holds a ``model`` block of (the checkpoints join
    and cut them, ``shard_leaf``)."""
    return {path: spec for path, spec in
            _leaf_specs(cfg, layout, axes_tree, mesh) if spec}


def _leaf_specs(cfg, layout, axes_tree, mesh):
    from repro_torch.core.arena import tree_flatten
    axes, _ = tree_flatten(axes_tree)
    paths = _leaf_paths(layout.treedef)
    return [(path, leaf_spec(cfg, path.rsplit("/", 1)[-1], shape, ax, mesh))
            for path, ax, shape in zip(paths, axes, layout.shapes)]


def _leaf_paths(treedef, prefix: str = ""):
    """Each leaf's path ("a/b/c"), in ``tree_flatten`` order."""
    out = []
    for k, d, _ in treedef:
        path = f"{prefix}{k}"
        out += [path] if d is None else _leaf_paths(d, path + "/")
    return out


def cut_leaf(leaf, dim, ax: ModelAxis):
    """The rank's model block of one whole leaf (``dim`` a
    ``model_dims`` entry), a tensor of its own."""
    if isinstance(dim, Segments):
        return dim.cut(leaf, ax.n, ax.rank)
    if dim is not None:
        size = leaf.shape[dim] // ax.n
        leaf = leaf.narrow(dim, ax.rank * size, size)
    return leaf.clone()


def join_leaf(blocks, dim):
    """The whole leaf from every ``model`` rank's block of it (rank
    order; ``dim`` a ``model_dims`` entry, not None)."""
    if isinstance(dim, Segments):
        return dim.join(blocks)
    return torch.cat(list(blocks), dim=dim)


def cut_params(params, dims, ax: ModelAxis):
    """The rank's model blocks of a whole parameter tree (``dims`` from
    ``model_dims``), each leaf a tensor of its own (none keeps the
    whole tree's storage alive)."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [cut_leaf(leaf, dim, ax)
                                    for leaf, dim in zip(leaves, dims)])


# ---------------------------------------------------------------------------
# The autograd ops
# ---------------------------------------------------------------------------
def _reduce(x: torch.Tensor, ax: ModelAxis, tag: str,
            op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` all-reduced over ``model`` in f32, back in x's dtype."""
    from repro_torch.dist.collectives import all_reduce
    y = x.to(torch.float32, copy=True).contiguous()
    all_reduce(y, ax.group, op, axis="model", tag=tag)
    return y.to(x.dtype)


def _gather(x: torch.Tensor, ax: ModelAxis, dim: int, tag: str):
    """Every rank's ``x`` joined along ``dim`` in rank order."""
    from repro_torch.dist.collectives import all_gather
    parts = all_gather(x, ax.group, ax.n, axis="model", tag=tag)
    return torch.cat(parts.unbind(0), dim=dim)


def _reduce_scatter(x: torch.Tensor, ax: ModelAxis, dim: int, tag: str):
    """The sum over ``model`` of ``x``, this rank keeping its block of
    ``dim`` (reduced in f32, back in x's dtype)."""
    from repro_torch.dist.collectives import reduce_scatter_rows
    blocks = torch.stack(x.chunk(ax.n, dim=dim)).to(torch.float32)
    out = reduce_scatter_rows(blocks, ax.group, ax.n, axis="model", tag=tag)
    return out[0].to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, tag):
        ctx.ax, ctx.tag = ax, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.ax, ctx.tag), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, tag):
        return _reduce(x, ax, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Sum(torch.autograd.Function):
    """All-reduce forward and backward: a sum every rank's part feeds
    and every rank reads, so each rank's gradient of its part is the sum
    of every rank's gradient of the total."""

    @staticmethod
    def forward(ctx, x, ax, tag):
        ctx.ax, ctx.tag = ax, tag
        return _reduce(x, ax, tag)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.ax, ctx.tag), None, None


class _GatherWhole(torch.autograd.Function):
    """An all-gather along ``dim`` for a computation every rank runs
    whole (its gradient is the same on every rank): backward keeps the
    rank's own block, no communication."""

    @staticmethod
    def forward(ctx, x, ax, dim, tag):
        ctx.ax, ctx.dim = ax, dim
        return _gather(x, ax, dim, tag)

    @staticmethod
    def backward(ctx, g):
        size = g.shape[ctx.dim] // ctx.ax.n
        return g.narrow(ctx.dim, ctx.ax.rank * size, size).contiguous(), \
            None, None, None


class _Gather(torch.autograd.Function):
    """An all-gather along ``dim`` whose backward reduce-scatters: each
    rank's part feeds a computation split over the ranks."""

    @staticmethod
    def forward(ctx, x, ax, dim, tag):
        ctx.ax, ctx.dim, ctx.tag = ax, dim, tag
        return _gather(x, ax, dim, tag)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.ax, ctx.dim, ctx.tag), None, None, \
            None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _reduce_scatter(x, ax, 1, "tp_seq")

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.ax, 1, "tp_seq"), None


class _Split(torch.autograd.Function):
    """The rank's block of ``dim`` forward; the blocks' gradients
    gathered backward, so the whole tensor's is the same on every
    rank."""

    @staticmethod
    def forward(ctx, x, ax, dim, tag):
        ctx.ax, ctx.dim, ctx.tag = ax, dim, tag
        size = x.shape[dim] // ax.n
        return x.narrow(dim, ax.rank * size, size)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.ax, ctx.dim, ctx.tag), None, \
            None, None


class _CrossEntropy(torch.autograd.Function):
    """log p(target) over the padded vocab from each rank's vocab block
    of the logits: the row max (all-reduce MAX), the sum of exps
    (all-reduce SUM) and the target's logit, from the rank that holds it
    (all-reduce SUM). log p = (z_t - max) - log(sum exp(z - max)), as
    ``log_softmax`` forms it."""

    @staticmethod
    def forward(ctx, logits, targets, ax):
        n_local = logits.shape[-1]
        v0 = ax.rank * n_local
        mx = _reduce(torch.amax(logits, dim=-1), ax, "tp_loss",
                     dist.ReduceOp.MAX)
        shifted = logits - mx[..., None]
        e = torch.exp(shifted)
        se = _reduce(torch.sum(e, dim=-1), ax, "tp_loss")
        mine = (targets >= v0) & (targets < v0 + n_local)
        idx = torch.where(mine, targets - v0, torch.zeros_like(targets))
        zt = torch.gather(shifted, -1, idx[..., None])[..., 0]
        zt = _reduce(torch.where(mine, zt, torch.zeros_like(zt)), ax,
                     "tp_loss")
        ctx.save_for_backward(e, se, idx, mine)
        return zt - torch.log(se)

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        grad = -(e / se[..., None]) * g[..., None]
        hit = torch.where(mine, g, torch.zeros_like(g))
        grad.scatter_add_(-1, idx[..., None], hit[..., None])
        return grad, None, None


class TensorParallel:
    """A forward's tensor parallelism: the ``model`` axis and whether
    the residual stream is split over the sequence between blocks
    (``seq_parallel`` at a length of more than one token)."""

    def __init__(self, ax: ModelAxis, seq_parallel: bool):
        self.ax = ax
        self.sp = seq_parallel

    def enter(self, x):
        """Into a column-parallel product: the whole sequence (under
        ``seq_parallel`` gathered), its gradient summed over ranks."""
        if self.sp:
            return _Gather.apply(x, self.ax, 1, "tp_seq")
        return _Copy.apply(x, self.ax, "tp_act")

    def exit(self, x):
        """Out of a row-parallel product: the ranks' partial sums added
        (under ``seq_parallel`` each rank keeping its sequence block)."""
        if self.sp:
            return _ScatterSeq.apply(x, self.ax)
        return _Reduce.apply(x, self.ax, "tp_act")

    def whole_param(self, p):
        """A whole parameter each rank uses a part of: its gradient is
        summed over ranks, so it is the same on every rank."""
        return _Copy.apply(p, self.ax, "tp_param")

    def rank_heads(self, leaf):
        """A whole per-head leaf (heads on its first dim) sliced to the
        rank's block of heads, its gradient summed over the ranks."""
        n = leaf.shape[0] // self.ax.n
        return self.whole_param(leaf).narrow(0, self.ax.rank * n, n)

    def gates(self, gates):
        """The MoE's gates before the combine: each rank combines its
        partial expert outputs, so their gradient is summed over
        ranks."""
        return _Copy.apply(gates, self.ax, "tp_router")

    def router_input(self, x):
        """What the MoE's router reads: the residual input itself (its
        gradient whole on every rank, so it bypasses ``enter``), under
        ``seq_parallel`` the whole sequence, gathered (its backward
        keeps the rank's own block)."""
        return _GatherWhole.apply(x, self.ax, 1, "tp_router") if self.sp \
            else x

    def sum(self, x):
        """``x`` summed over the ranks, the gradient as well (the gated
        norm's sum of squares)."""
        return _Sum.apply(x, self.ax, "tp_norm")

    def gather_features(self, x):
        """The ranks' blocks of the last dim joined in rank order (the
        mLSTM's ``a``): backward, the sum of every rank's gradient, each
        rank keeping its block."""
        return _Gather.apply(x, self.ax, x.dim() - 1, "tp_feat")

    def whole_features(self, x):
        """The ranks' blocks of the last dim joined in rank order, for a
        computation every rank then runs alike (the sLSTM's output before
        its FFN): backward keeps the rank's own block."""
        return _GatherWhole.apply(x, self.ax, x.dim() - 1, "tp_feat")

    def norm_scale(self, scale):
        """An RMSNorm scale of the residual stream: under
        ``seq_parallel`` each rank normalizes its own tokens."""
        return self.whole_param(scale) if self.sp else scale

    def split_seq(self, h):
        """The embedding's sequence block of this rank (under
        ``seq_parallel``)."""
        return _Split.apply(h, self.ax, 1, "tp_seq") if self.sp else h

    def vocab_slice(self, table):
        """The rank's vocab rows of the tied (V, d) table."""
        return _Split.apply(table, self.ax, 0, "tp_param")

    def cross_entropy(self, logits, targets):
        """log p(target) of each row of the rank's vocab block of the
        logits (f32), over the whole padded vocab."""
        return _CrossEntropy.apply(logits, targets, self.ax)


def active(cfg: ModelConfig, *lengths: int) -> Optional[TensorParallel]:
    """The forward's tensor parallelism under the active mesh (None at
    ``model = 1``). ``lengths`` are the sequences ``seq_parallel`` would
    split (the encoder-decoder's source and target, the VLM's patches
    and text together): each must split over the ranks (``ValueError``
    naming it); at one token ``seq_parallel`` is the identity."""
    ax = model_axis()
    if ax is None:
        return None
    check_model_axis(cfg, ax.n)
    sp = cfg.seq_parallel and all(n > 1 for n in lengths)
    for n in lengths if sp else ():
        if n % ax.n:
            raise ValueError(f"seq_parallel: {n} tokens do not split over "
                             f"model={ax.n} ranks")
    return TensorParallel(ax, sp)


# ---------------------------------------------------------------------------
# Decoding and serving (the serve profile's layout, see the docstring)
# ---------------------------------------------------------------------------
# the cache leaves that hold kv heads (the KV cache, the encoder-decoder's
# memory K/V): cut as the rank's attention reads them
_KV_CACHE = ("k", "v", "mem_k", "mem_v")


def active_decode(cfg: ModelConfig) -> Optional[TensorParallel]:
    """A decode step's tensor parallelism under the active mesh (None at
    ``model = 1``): the blocks of ``active`` without ``seq_parallel``
    (one token a step, and the serve profile resolves "seq_sp" to
    nothing). It checks ``check_model_blocks`` only: the xLSTM's
    refusal of ``seq_parallel`` is the training forward's, so such a
    config serves."""
    ax = model_axis()
    if ax is None:
        return None
    check_model_blocks(cfg, ax.n)
    return TensorParallel(ax, False)


class SlotRows(NamedTuple):
    """The decode batch's rows this rank holds: [start, start + size) of
    the ``batch`` slots, split over ``n`` data ranks (1: every rank holds
    every slot), ``group`` the ``data`` group (None where n is 1)."""
    start: int
    size: int
    n: int
    group: object

    def of(self, x):
        """This rank's rows of a whole (batch, ...) array."""
        return x[self.start:self.start + self.size]


def slot_rows(batch: int) -> SlotRows:
    """The rows of a decode batch of ``batch`` slots this rank holds
    under the active mesh: the serve profile's "batch" entry (JAX's
    ``spec_for(("batch",), (batch,), mesh, "serve")``), a block of
    batch / D rows where ``data`` (D) divides the slots, else every
    row (JAX's resolver falls back to replication)."""
    from repro_torch.dist.context import active_mesh
    mesh = active_mesh()
    if mesh is None or not _splits_slots(batch, mesh):
        return SlotRows(0, batch, 1, None)
    from repro_torch.dist.collectives import require_mesh
    ranks = require_mesh("the decode batch over 'data'")
    size = batch // mesh.data
    return SlotRows(ranks.coords["data"] * size, size, mesh.data,
                    ranks.group("data"))


def _splits_slots(batch: int, mesh) -> bool:
    """Whether the serve profile splits ``batch`` slots over ``data``."""
    from repro_torch.dist.sharding import Spec, spec_for
    return mesh.data > 1 and spec_for(("batch",), (batch,), mesh,
                                      profile="serve") != Spec()


class CacheCut(NamedTuple):
    """How a rank's block of one decode-cache leaf is cut from the
    whole: ``batch`` the dim the slots split over ``data`` (None: every
    slot), ``model`` None (whole), ("kv", dim) (the rank's kv heads, as
    its attention reads them, ``local_heads``), ("heads", dim) (a
    contiguous block of heads) or a ``Segments`` (the Mamba2 ``conv``
    state's [x | B | C] channels, as ``w_conv``)."""
    batch: Optional[int]
    model: object


def cache_dims(cfg: ModelConfig, caxes, batch: int, mesh):
    """For each leaf of a decode cache of ``batch`` slots (its logical
    axes ``caxes``, in ``tree_flatten`` order) on ``mesh``: its
    ``CacheCut``."""
    from repro_torch.core.arena import tree_flatten
    axes, treedef = tree_flatten(caxes)
    split = _splits_slots(batch, mesh)
    out = []
    for path, ax in zip(_leaf_paths(treedef), axes):
        b = ax.index("batch") if split and "batch" in ax else None
        m = None
        if mesh.model > 1 and "mlp" in ax:
            from repro_torch.models.ssm import mamba2_segments
            m = mamba2_segments(cfg, "w_conv", len(ax))
        elif mesh.model > 1 and "heads" in ax:
            kind = "kv" if path.rsplit("/", 1)[-1] in _KV_CACHE else "heads"
            m = (kind, ax.index("heads"))
        out.append(CacheCut(b, m))
    return out


def cut_cache(cfg: ModelConfig, cache, dims, mesh, coords):
    """The block of the whole decode ``cache`` the rank at ``coords``
    holds (``dims`` from ``cache_dims``), each leaf a tensor of its
    own."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(cache)
    ax = ModelAxis(None, mesh.model, coords.get("model", 0))
    out = []
    for leaf, cut in zip(leaves, dims):
        if cut.batch is not None:
            size = leaf.shape[cut.batch] // mesh.data
            leaf = leaf.narrow(cut.batch, coords["data"] * size, size)
        if isinstance(cut.model, Segments):
            leaf = cut.model.cut(leaf, ax.n, ax.rank)
        elif cut.model is not None:
            kind, dim = cut.model
            if kind == "kv":
                _, kv0, size, whole = local_heads(cfg, ax)
                start = kv0 if whole else ax.rank * size
            else:
                size = leaf.shape[dim] // ax.n
                start = ax.rank * size
            leaf = leaf.narrow(dim, start, size)
        out.append(leaf.clone())
    return tree_unflatten(treedef, out)


def local_kv_heads(cfg: ModelConfig, tp: Optional[TensorParallel]) -> int:
    """The kv heads a rank's attention (and its KV cache) holds."""
    return cfg.n_kv_heads if tp is None else local_heads(cfg, tp.ax)[2]


def vocab_argmax(logits: torch.Tensor, ax: Optional[ModelAxis] = None):
    """The index over the whole padded vocab of the largest logit of each
    row of ``logits`` (the last dim: under ``ax`` the rank's vocab block,
    rank order along the vocab), the first of equal maxima as
    ``jnp.argmax`` takes it: each rank's max and its first index, as an
    f64 (value, global index) pair, all-gathered over ``model``
    ("tp_logits"), and the lowest rank holding the max wins. Returns
    int64 indices."""
    if ax is None:
        return torch.argmax(logits, dim=-1)
    from repro_torch.dist.collectives import all_gather
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    pair = torch.stack([val.to(torch.float64),
                        (idx + ax.rank * logits.shape[-1]).to(torch.float64)],
                       dim=-1)
    pairs = all_gather(pair, ax.group, ax.n, axis="model", tag="tp_logits")
    vals = pairs[..., 0]
    first = torch.argmax((vals == vals.amax(0)).to(torch.int32), dim=0)
    return torch.gather(pairs[..., 1], 0, first[None])[0].to(torch.int64)


def gather_slots(x: torch.Tensor, rows: SlotRows) -> torch.Tensor:
    """Every slot's ``x`` from each data rank's rows (``x`` this rank's,
    (rows.size, ...)), all-gathered over ``data`` ("slots"); ``x``
    itself where every rank holds every slot."""
    if rows.n == 1:
        return x
    from repro_torch.dist.collectives import all_gather_rows
    return all_gather_rows(x.contiguous(), rows.group, rows.n, axis="data",
                           tag="slots")
