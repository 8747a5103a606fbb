"""Logical axes -> mesh axes: the port of ``repro/dist/sharding.py``.

Models record a tuple of *logical* axis names per parameter dimension
(``models.common.ParamFactory``); this module maps them onto the mesh
axes of a ``MeshConfig``. Resolution is greedy, left to right over the
dimensions of one array, as in the JAX package:

  * each logical axis has an ordered preference list of mesh axes (or
    axis tuples, sharded over their product);
  * a candidate is taken only if every mesh axis in it exists on this
    mesh, none of them is used by an earlier dimension of the same
    array, and the dimension divides the candidate's device count;
    otherwise the next preference is tried, falling back to None
    (replicated);
  * trailing Nones are trimmed.

A spec is the port's own ``Spec``: a tuple with one entry per leading
dimension, each None, a mesh-axis name, or a tuple of names (the
dimension sharded over their product, the first name the slowest). Its
entries equal those of the JAX resolver's ``PartitionSpec``.
``local_shard`` cuts the block one rank holds.

Two profiles: "train" (FSDP weights: embed on 'data', TP dims on
'model', batch over ('pod', 'data')) and "serve" (weights gathered:
embed replicated, TP dims over the whole ('data', 'model') slice). The
"flat" axis names the row dimension of the gradient arena
(``core.arena``), whose rows shard over the whole intra-pod slice.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

from repro_torch.configs.base import MeshConfig

Entry = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """A resolved spec: one entry per leading dimension. A tuple (it
    equals the same entries as a plain tuple, and a JAX
    ``PartitionSpec``'s entries), typed apart so that a tree of specs
    tells its leaves from its tuple nodes."""

    def __new__(cls, *entries: Entry):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


# preference lists: logical axis -> candidates, each a mesh axis name or
# a tuple of names (sharded over the product)
_TRAIN_PREFS = {
    "batch": (("pod", "data"),),
    "embed": ("data",),
    "mlp": ("model",),
    "heads": ("model",),
    "vocab": ("model",),
    "kv_seq": ("data", "model"),
    "seq_sp": ("model",),
    "pod": ("pod",),
    "flat": (("data", "model"), "data"),
}

_SERVE_PREFS = {
    "batch": ("data",),
    "embed": (),                       # weights gathered at use
    "mlp": (("data", "model"), "model"),
    "heads": (("data", "model"), "model"),
    "vocab": (("data", "model"), "model"),
    "kv_seq": (),
    "seq_sp": (),
    "pod": ("pod",),
    "flat": (("data", "model"), "data"),
}

_PROFILES = {"train": _TRAIN_PREFS, "serve": _SERVE_PREFS}


def _is_axes_leaf(x) -> bool:
    """A logical-axes annotation: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def mesh_sizes(mesh) -> Dict[str, int]:
    """The mesh's axis sizes by name ('pod' only when n_pods > 1, as
    ``MeshConfig.axis_names``). ``mesh`` may also be the sizes
    themselves, a mapping: the gossip's ``{"worker": n}``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    sizes = {"data": mesh.data, "model": mesh.model}
    if mesh.n_pods > 1:
        sizes["pod"] = mesh.n_pods
    return sizes


def spec_for(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
             mesh: MeshConfig, profile: str = "train") -> Spec:
    """Resolve one array's logical axes to a spec."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not match shape {shape}")
    prefs = _PROFILES[profile]
    sizes = mesh_sizes(mesh)
    used = set()
    entries = []
    for name, dim in zip(axes, shape):
        choice = None
        for cand in prefs.get(name, ()):
            cand = cand if isinstance(cand, tuple) else (cand,)
            cand = tuple(a for a in cand if a in sizes)
            if not cand or any(a in used for a in cand):
                continue
            if dim % math.prod(sizes[a] for a in cand) != 0:
                continue
            choice = cand
            break
        if choice:
            used.update(choice)
            entries.append(choice[0] if len(choice) == 1 else choice)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return Spec(*entries)


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry shards over (none for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def dim_shard(entry: Entry, mesh: MeshConfig) -> int:
    """How many blocks a dimension with this spec entry splits into."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in entry_axes(entry))


def block(entry: Entry, mesh: MeshConfig,
          coords: Dict[str, int]) -> Tuple[int, int]:
    """(how many blocks a dimension with this spec entry splits into,
    the index of the block the rank at ``coords`` (mesh axis -> index)
    holds): row-major over the entry's axes, its first axis the
    slowest."""
    sizes = mesh_sizes(mesh)
    n, idx = 1, 0
    for a in entry_axes(entry):
        idx = idx * sizes[a] + coords.get(a, 0)
        n *= sizes[a]
    return n, idx


def local_shard(tensor, spec: Spec, mesh: MeshConfig,
                coords: Dict[str, int]):
    """The block of ``tensor`` the rank at ``coords`` (mesh axis ->
    index) holds under ``spec``: each sharded dimension is cut into
    ``dim_shard`` equal blocks, the rank's by ``block``. A view, never a
    copy."""
    out = tensor
    for dim, entry in enumerate(spec):
        n, idx = block(entry, mesh, coords)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split into {n} blocks ({spec})")
        size = out.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def arena_slot_specs(mesh: MeshConfig, rows: int,
                     profile: str = "train") -> Tuple[Spec, Spec, Spec]:
    """Specs of one v2 delay-ring slot and its per-step operands, shared
    by the state specs (``arena.arena_logical_axes``), the sharded slot
    rotate and the tests:

      slot_spec    (n_pods, rows, 128) buffers: ring slots, residual,
                   staging, the pod-stacked gradient
      scales_spec  (n_pods, rows) per-row int8 scales
      row_spec     (rows, 128) pod-reduced row buffers (popped grad, z)
    """
    slot_spec = spec_for(("pod", "flat", None), (mesh.n_pods, rows, 128),
                         mesh, profile=profile)
    scales_spec = spec_for(("pod", "flat"), (mesh.n_pods, rows),
                           mesh, profile=profile)
    row_spec = spec_for(("flat", None), (rows, 128), mesh, profile=profile)
    return slot_spec, scales_spec, row_spec


def arena_ring_specs(mesh: MeshConfig, rows: int,
                     profile: str = "train") -> Tuple[Spec, Spec, Spec]:
    """Specs of the stacked (layout v3) delay-tolerant ring, the variable
    delay's analogue of ``arena_slot_specs``:

      ring_spec    (n_slots, n_pods, rows, 128): the slot dimension is
                   indexed by metadata, never sharded
      scales_spec  (n_slots, n_pods, rows) stacked per-row int8 scales
      row_spec     (rows, 128) pod-reduced popped rows
    """
    ring_spec = spec_for((None, "pod", "flat", None),
                         (1, mesh.n_pods, rows, 128), mesh,
                         profile=profile)
    scales_spec = spec_for((None, "pod", "flat"), (1, mesh.n_pods, rows),
                           mesh, profile=profile)
    row_spec = spec_for(("flat", None), (rows, 128), mesh, profile=profile)
    return ring_spec, scales_spec, row_spec


def publish_ring_specs(mesh: MeshConfig, rows: int,
                       profile: str = "serve") -> Tuple[Spec, Spec]:
    """Specs of the weight-publication ring (``serve.publisher``), the
    serving analogue of ``arena_ring_specs`` without the pod dimension:

      ring_spec    (n_slots, rows, 128) int8 snapshots; rows over the
                   serve slice
      scales_spec  (n_slots, rows) per-row bf16 scales
    """
    ring_spec = spec_for((None, "flat", None), (1, rows, 128), mesh,
                         profile=profile)
    scales_spec = spec_for((None, "flat"), (1, rows), mesh,
                           profile=profile)
    return ring_spec, scales_spec


class GossipSpecs(NamedTuple):
    """Specs of the decentralized gossip state under the 1-D
    ``('worker',)`` mesh (one index a worker; ``local_shard`` cuts a
    rank's block with the sizes ``{"worker": n}``):

      msg      (n_workers, rows, 128) per-worker duals and messages, the
               int8 payload and its residual: worker dim sharded, whole
               rows local
      scales   (n_workers, rows) per-row scales of the compressed payload
      scalar   (n_workers,) per-worker scalars
    """
    msg: Spec
    scales: Spec
    scalar: Spec


def gossip_specs() -> GossipSpecs:
    return GossipSpecs(msg=Spec("worker", None, None),
                       scales=Spec("worker", None),
                       scalar=Spec("worker"))


def shapes_and_axes(model):
    """(the parameter tree on the ``meta`` device, its logical-axes
    tree): the port of ``shapes_and_axes(model.init, key)``, with
    nothing allocated or drawn."""
    return model.param_shapes(), model.param_axes()
