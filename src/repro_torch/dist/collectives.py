"""The collectives of the multi-process path, over the groups of the
ambient ``DeviceMesh`` (dims "pod", "data", "model") and the
decentralized gossip's worker group (one worker a rank):

  pod    the cross-site channel of the paper: the folded f32 rows of
         the variable pop (one ``all_reduce`` a step), the compressed
         int8 payload and its row scales of the slot rotate
         (``all_gather``), each pod's count and loss (``all_gather``);
  data   the pod's gradient rows (``reduce_scatter``); a decode step's
         next tokens (``all_gather``);
  model  tensor parallelism (``dist.tensor_parallel``): the blocks'
         activations and the vocab-parallel loss's reductions
         (``all_reduce``), the sequence's gathers and scatters under
         ``seq_parallel``, the model-sharded gradient leaves
         (``all_gather``);
  data+model  the intra-pod slice the arena's rows shard over (its
         product group, or the one axis of it that is larger than 1):
         the dual update's w (``all_gather``), the int8 scales'
         per-leaf maxima and the step's sums of squares
         (``all_reduce``);
  worker the gossip's neighbour exchange (``permute``, one point-to-point
         send and receive a stencil term), each worker's count and loss
         (``all_gather``), and the metrics' whole-message sums
         (``all_reduce``).

Every call goes to the group whatever its size (a group of one still
runs through its backend). A collective that fails raises: nothing here
falls back to another route. One rule moves a tensor through the host:
gloo's point-to-point ``send``/``recv`` reads a tensor's memory as the
host's, so ``permute`` on a gloo group stages a CUDA tensor through host
copies (its collectives take CUDA tensors and stage them themselves).

The byte census: every call adds the bytes it puts on the wire, per
device, to ``CENSUS`` under (axis, dtype, tag), with the ring formulas
of ``launch.wire_model``: an all-reduce 2 (n-1)/n P, an all-gather
(n-1)/n of the gathered bytes, a reduce-scatter (n-1)/n P, a permute
its payload. The dtype is JAX's short name ("f32", "s8", ...; bf16
crosses as its raw bits, "u16"); the tag names the call site
("pod_pop", "pod_counts", "grad_rows", "w_rows", "scales_max",
"metrics", "gossip", "worker_counts", and ``dist.tensor_parallel``'s
"tp_act", "tp_seq", "tp_loss", "tp_param", "tp_router", "tp_norm",
"tp_feat", "grad_leaves", and a decode step's "tp_logits" and "slots").
The census is Python integer sums
on the host: no device sync, always on. ``wire_census()`` reads it:

    with wire_census() as census:
        ...                                  # steps, rounds
    census.select(tag="gossip")              # {"f32": bytes, ...}
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.context import active_device_mesh

AXES = ("pod", "data", "model")

# the single-tensor forms, under their current names where they exist
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


# (id of a DeviceMesh, its axes) -> this rank's group over the product
# of those axes (``launch.mesh.make_mesh`` makes the ("data", "model")
# one of every pod and registers this rank's)
_PRODUCT_GROUPS: Dict[tuple, object] = {}


def register_product_group(device_mesh, axes: Tuple[str, ...], group):
    """Record ``group`` as this rank's group over the product of
    ``axes`` of ``device_mesh`` (``Ranks.group(axes)`` returns it)."""
    _PRODUCT_GROUPS[(id(device_mesh), tuple(axes))] = group


def axis_label(axes, sizes: Dict[str, int]) -> str:
    """The census's name of a group over ``axes``: those larger than 1,
    joined by "+" ("data+model", "model", ...)."""
    return "+".join(a for a in axes if sizes[a] > 1)


class Ranks(NamedTuple):
    """Where this rank sits in the ambient mesh: its coordinates and
    the axis sizes, by axis name."""
    device_mesh: object
    coords: Dict[str, int]
    sizes: Dict[str, int]

    def group(self, axis):
        """The group over mesh axis ``axis``, or over the product of a
        tuple of axes: of those larger than 1, the one axis's group, or
        the product group ``make_mesh`` registered (None where every
        axis is 1)."""
        if isinstance(axis, str):
            return self.device_mesh.get_group(axis)
        big = tuple(a for a in axis if self.sizes[a] > 1)
        if not big:
            return None
        if len(big) == 1:
            return self.device_mesh.get_group(big[0])
        key = (id(self.device_mesh), tuple(axis))
        if key not in _PRODUCT_GROUPS:
            raise RuntimeError(
                f"no group over the product of {axis} is registered for "
                "the active DeviceMesh (launch.mesh.make_mesh makes it)")
        return _PRODUCT_GROUPS[key]

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of the world's rank ``rank``."""
        idx = (self.device_mesh.mesh == rank).nonzero()[0].tolist()
        return dict(zip(AXES, idx))


def require_mesh(what: str) -> Ranks:
    """The ambient mesh of a sharded route; raises when there is none or
    no process group behind it (the sharded route never drops back to
    the off-mesh one)."""
    dm = active_device_mesh()
    if dm is None:
        raise RuntimeError(
            f"{what} runs under a multi-rank mesh: it needs an active "
            "DeviceMesh (enter the launch.mesh.Mesh that make_mesh "
            "built), and none is active")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what}: the active mesh has no process group behind it "
            "(torch.distributed.init_process_group was not called)")
    if tuple(dm.mesh_dim_names) != AXES:
        raise ValueError(f"{what}: the mesh's dims are "
                         f"{dm.mesh_dim_names}, expected {AXES}")
    shape = tuple(dm.mesh.shape)
    return Ranks(dm, {a: dm.get_local_rank(a) for a in AXES},
                 dict(zip(AXES, shape)))


class WorkerGroup(NamedTuple):
    """The decentralized gossip's 1-D ``('worker',)`` layout over the
    world: worker i is rank i of ``group``, a group over every rank."""
    group: object
    n: int
    rank: int

    @property
    def coords(self) -> Dict[str, int]:
        return {"worker": self.rank}

    @property
    def sizes(self) -> Dict[str, int]:
        return {"worker": self.n}

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of the world's rank ``rank``."""
        return {"worker": rank}


def worker_group(n_workers: int) -> WorkerGroup:
    """One worker a rank over the initialised world, in a group of its
    own over every rank (JAX's private ``('worker',)`` mesh over the
    first n devices). A collective: every rank calls it. Raises a
    ``RuntimeError`` naming both counts when there is no process group
    or the world has another size than ``n_workers``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"the per-rank gossip runs one worker a rank: "
            f"{n_workers} workers need an initialised process group of "
            f"{n_workers} ranks, and there is none (0 ranks)")
    world = dist.get_world_size()
    if world != n_workers:
        raise RuntimeError(
            f"the per-rank gossip runs one worker a rank: "
            f"{n_workers} workers need a world of {n_workers} ranks; the "
            f"world has {world}")
    group = dist.new_group(list(range(world)))
    return WorkerGroup(group, world, dist.get_rank())


# ---------------------------------------------------------------------------
# The byte census
# ---------------------------------------------------------------------------
_WIRE_NAMES = {torch.float32: "f32", torch.float64: "f64",
               torch.float16: "f16", torch.bfloat16: "bf16",
               torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
               torch.uint16: "u16", torch.int32: "s32", torch.int64: "s64"}


class WireCensus:
    """Per-device wire bytes by (axis, dtype, tag)."""

    def __init__(self):
        self.bytes: Dict[tuple, int] = collections.Counter()

    def add(self, axis: str, dtype: str, tag: str, n_bytes: int):
        if n_bytes:
            self.bytes[(axis, dtype, tag)] += n_bytes

    def select(self, tag: Optional[str] = None, axis: Optional[str] = None
               ) -> Dict[str, int]:
        """{dtype: bytes} over the entries of ``tag`` and ``axis`` (None:
        any), the form of ``launch.wire_model``'s functions."""
        out: Dict[str, int] = collections.Counter()
        for (a, dt, t), n in self.bytes.items():
            if (tag is None or t == tag) and (axis is None or a == axis):
                out[dt] += n
        return dict(out)


CENSUS = WireCensus()


@contextlib.contextmanager
def wire_census():
    """Reset the census, run the block and yield what it counted: a
    ``WireCensus`` filled when the block ends (the census is reset
    again then)."""
    CENSUS.bytes.clear()
    counted = WireCensus()
    try:
        yield counted
    finally:
        counted.bytes.update(CENSUS.bytes)
        CENSUS.bytes.clear()


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------
def all_gather(x: torch.Tensor, group, n: int, *, axis: str,
               tag: str) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group-rank order. A bf16
    tensor crosses as its raw bytes (a gather moves bits; not every
    backend takes bf16). On a gloo group a CUDA tensor is gathered
    through host copies here: gloo's own staging of a CUDA gather holds
    a second device buffer of the output's size (6.4 GiB of a mixtral
    rank's w rows, where the card has none to spare)."""
    wire = x.contiguous().reshape(-1)
    if x.dtype == torch.bfloat16:
        wire = wire.view(torch.uint8)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    out = torch.empty((n * wire.numel(),), dtype=wire.dtype,
                      device="cpu" if staged else x.device)
    _all_gather(out, wire.cpu() if staged else wire, group=group)
    if staged:
        out = out.to(x.device)
    # (n - 1) / n of the n * x.nbytes gathered
    CENSUS.add(axis, _WIRE_NAMES[x.dtype], tag, (n - 1) * x.nbytes)
    return out.view(x.dtype).reshape((n,) + tuple(x.shape))


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM, *, axis: str,
               tag: str) -> torch.Tensor:
    """``x`` reduced over the group, in place; returns ``x``."""
    dist.all_reduce(x, op=op, group=group)
    n = dist.get_world_size(group)
    CENSUS.add(axis, _WIRE_NAMES[x.dtype], tag, 2 * (n - 1) * x.nbytes // n)
    return x


def reduce_scatter_rows(x: torch.Tensor, group, n: int, *, axis: str,
                        tag: str) -> torch.Tensor:
    """The sum over the group of ``x`` (rows, ...), this rank keeping
    its block of rows / n."""
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _reduce_scatter(out, x.contiguous(), group=group)
    CENSUS.add(axis, _WIRE_NAMES[x.dtype], tag, (n - 1) * x.nbytes // n)
    return out


def all_gather_rows(x: torch.Tensor, group, n: int, *, axis: str,
                    tag: str) -> torch.Tensor:
    """The row blocks of the group's ranks, back to back: (n * rows,
    ...)."""
    out = all_gather(x, group, n, axis=axis, tag=tag)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def permute(x: torch.Tensor, group, perm: Sequence[int], *, axis: str,
            tag: str) -> torch.Tensor:
    """The twin of ``lax.ppermute`` for a true permutation of the
    group's ranks: receiver i takes sender ``perm[i]``'s ``x``. One
    ``batch_isend_irecv`` of a send and a receive a rank (a rank that
    is its own source copies ``x`` and sends nothing). A bf16 tensor
    crosses as its raw 16 bits ("u16" in the census): viewed as uint16,
    or as it is on NCCL, which has no 16-bit integer type (a
    point-to-point send copies bytes either way). On a gloo group a
    CUDA tensor is staged through host copies (gloo's point-to-point
    reads the tensor's memory as the host's). The census counts the
    payload, whatever the staging."""
    rank = dist.get_rank(group)
    src = int(perm[rank])
    if src == rank:
        return x.clone()
    dst = [int(p) for p in perm].index(rank)
    backend = dist.get_backend(group)
    wire, name = x.contiguous(), _WIRE_NAMES[x.dtype]
    if x.dtype == torch.bfloat16:
        name = "u16"
        if backend != "nccl":
            wire = wire.view(torch.uint16)
    staged = x.is_cuda and backend == "gloo"
    if staged:
        wire = wire.cpu()
    got = torch.empty_like(wire)
    peer = (lambda r: r) if group is None else \
        (lambda r: dist.get_global_rank(group, r))
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wire, peer(dst), group),
            dist.P2POp(dist.irecv, got, peer(src), group)]):
        work.wait()
    CENSUS.add(axis, name, tag, x.nbytes)
    if staged:
        got = got.to(x.device)
    return got.view(x.dtype) if x.dtype == torch.bfloat16 else got
