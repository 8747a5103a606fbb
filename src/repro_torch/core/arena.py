"""Persistent, lane-aligned flat gradient arena: the master pipeline's
memory layout, ported from ``repro/core/arena.py``.

Every leaf of the parameter tree is flattened and padded up to a whole
number of 128-lane rows; leaves lie back to back in one ``(rows, 128)``
f32 buffer (rows padded to a multiple of ``BLOCK_ROWS``). The layout
is computed once (``ArenaLayout``); per step the gradient is written
into preallocated buffers with static-offset copies, and the dual
variable ``z``, the delay ring and the int8 error-feedback residual
live in arena form for good.

Row alignment makes int8 compression cheap: every row belongs to one
leaf, so per-tensor scales become per-row vectors through a static
row -> leaf map, bitwise equal to the per-tensor reference (a max is a
max whatever the order).

The delay ring has three layouts (see ``GradArena``): v2, the default
for a fixed tau, keeps ``tau + 1`` per-slot buffers selected by a phase
counter kept as a Python int, so each step pops slot ``(phase + 1) %
(tau + 1)`` and overwrites slot ``phase``, two different buffers; v1
is one stacked ``(tau, ...)`` buffer whose slot is the device scalar
``head``, kept for migration (``convert_ring``) and as a layout oracle;
v3 is the delay-tolerant ring of a stochastic delay process, stacked
like v1 and pushed at v2's phase schedule, with per-slot ``due`` and
``stale`` tags driving a masked pop (``push_pop_variable``).

Under a multi-rank mesh (an active ``dist.context`` profile of more
than one device, ``launch.mesh``: pods over ranks, rows over the
``data x model`` ranks of a pod) each rank holds its ``(local_pods,
rows_local, 128)`` shard of every ring buffer (``init_arena(...,
local=...)``) and the counts whole, and ``push_pop`` /
``push_pop_variable`` take the sharded wrappers of
``kernels.delay_ring.ops``; their gradient is then the rank's row shard
in arena form, already summed over the pod's ``data`` ranks. The rows
are always those of the whole parameter tree (JAX's layout), whatever
the ``model`` axis cuts of the parameters: the int8 scales are per row,
so the ring, the checkpoint and the stacked run quantize the same
rows. An active multi-rank mesh with no process group raises;
the stacked off-mesh route runs only when no such mesh is active.

Where the JAX package donates buffers to ``jit``
(``input_output_aliases`` in the kernels, ``donate_argnums`` in the
loop), the port writes in place: the push slot, its scales, the staging
buffer, the residual and the ring's tags are updated where they lie,
and an arena passed to ``push_pop`` or ``push_pop_variable`` must not
be used again (use the one it returns).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.delayed import pod_sum
from repro_torch.device import resolve_device

LANES = 128
BLOCK_ROWS = 256  # total rows padded to a multiple (the JAX kernel block)


# ---------------------------------------------------------------------------
# Trees: nested dicts of tensors, leaves in sorted-key order (the order
# jax.tree.flatten gives a dict, so both packages lay leaves out alike)
# ---------------------------------------------------------------------------
def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) of a nested dict; anything else is a leaf."""
    if isinstance(tree, dict):
        leaves, defs = [], []
        for k in sorted(tree):
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append((k, d, len(sub)))
        return leaves, defs
    return [tree], None


def tree_unflatten(treedef, leaves):
    if treedef is None:
        (leaf,) = leaves
        return leaf
    out, i = {}, 0
    for k, d, n in treedef:
        out[k] = tree_unflatten(d, leaves[i:i + n])
        i += n
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), as ``jax.tree.map``."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_sum(trees):
    """The leafwise sum of a list of trees, a left fold in list order."""
    out = trees[0]
    for t in trees[1:]:
        out = tree_map(lambda a, b: a + b, out, t)
    return out


class ArenaLayout:
    """Static flatten metadata (plain Python and numpy)."""

    def __init__(self, treedef, shapes, dtypes):
        self.treedef = treedef
        self.shapes = tuple(tuple(s) for s in shapes)
        self.dtypes = tuple(dtypes)
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        self.row_counts = tuple(-(-s // LANES) for s in self.sizes)
        offs, o = [], 0
        for rc in self.row_counts:
            offs.append(o)
            o += rc
        self.row_offsets = tuple(offs)
        self.n_leaves = len(self.sizes)
        self.rows = -(-o // BLOCK_ROWS) * BLOCK_ROWS
        # static row -> leaf map; tail-pad rows get the sentinel segment
        # ``n_leaves`` (their scale is pinned to 1, their data to 0)
        r2l = np.full((self.rows,), self.n_leaves, np.int32)
        for i, (ro, rc) in enumerate(zip(self.row_offsets, self.row_counts)):
            r2l[ro:ro + rc] = i
        self.row_to_leaf = r2l
        self._r2l_on: Dict[torch.device, torch.Tensor] = {}

    @property
    def numel(self) -> int:
        return self.rows * LANES

    def row_to_leaf_on(self, device) -> torch.Tensor:
        """``row_to_leaf`` as an int64 tensor on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._r2l_on:
            self._r2l_on[device] = torch.as_tensor(
                self.row_to_leaf, dtype=torch.int64).to(device)
        return self._r2l_on[device]


def make_layout(params) -> ArenaLayout:
    """Build the layout from a parameter tree (tensors, arrays, or
    anything with ``shape`` and ``dtype``). Called once, never per step."""
    leaves, treedef = tree_flatten(params)
    return ArenaLayout(treedef, [tuple(l.shape) for l in leaves],
                       [l.dtype for l in leaves])


def _leaf_strip(out, leading: int, ofs: int, rc: int):
    """The rows [ofs, ofs + rc) of ``out`` as a (*lead, rc*128) view."""
    strip = out.narrow(leading, ofs, rc)
    return strip.reshape(tuple(strip.shape[:leading]) + (rc * LANES,))


def flatten_tree(layout: ArenaLayout, tree, leading: int = 0, out=None):
    """Write a tree into arena form: ``(*lead, rows, 128)`` f32.

    ``leading`` counts extra leading dims shared by every leaf (the
    pod-stacked gradient uses leading=1). With ``out`` (a persistent
    buffer: the staging buffer, or the ring slot being overwritten) the
    leaves are copied into it in place, their pad lanes zeroed; rows
    past the last leaf are left as they are (zero in every arena
    buffer). Without ``out`` a zeroed buffer is allocated."""
    leaves, _ = tree_flatten(tree)
    if out is None:
        lead = tuple(leaves[0].shape[:leading]) if leaves else ()
        out = torch.zeros(lead + (layout.rows, LANES), dtype=torch.float32,
                          device=leaves[0].device)
    for leaf, ofs, size, rc in zip(leaves, layout.row_offsets,
                                   layout.sizes, layout.row_counts):
        strip = _leaf_strip(out, leading, ofs, rc)
        lead = tuple(leaf.shape[:leading])
        strip[..., :size].copy_(leaf.reshape(lead + (size,)))
        strip[..., size:].zero_()
    return out


def scatter_fed(layout: ArenaLayout, tree, residual, out):
    """int8 error feedback: write fed = g + residual in arena form into
    ``out`` (the staging buffer), one leaf strip at a time. ``tree``
    leaves are (n_pods, *shape). Returns ``out``."""
    leaves, _ = tree_flatten(tree)
    for leaf, ofs, size, rc in zip(leaves, layout.row_offsets,
                                   layout.sizes, layout.row_counts):
        strip = _leaf_strip(out, 1, ofs, rc)
        strip[..., :size].copy_(leaf.reshape(leaf.shape[0], size))
        strip[..., size:].zero_()
        strip.add_(_leaf_strip(residual, 1, ofs, rc))
    return out


def unflatten_tree(layout: ArenaLayout, mat, cast: bool = True, scale=None):
    """Gather arena rows back into the tree. ``cast=False`` keeps every
    leaf f32; ``cast=True`` restores the layout dtypes. ``scale``
    multiplies each slice on the way out."""
    lead = tuple(mat.shape[:-2])
    flat = mat.reshape(lead + (layout.numel,))
    out = []
    for ofs, size, shape, dtype in zip(layout.row_offsets, layout.sizes,
                                       layout.shapes, layout.dtypes):
        x = flat[..., ofs * LANES:ofs * LANES + size]
        if scale is not None:
            x = scale * x
        x = x.reshape(lead + shape)
        out.append(x.to(dtype) if cast else x)
    return tree_unflatten(layout.treedef, out)


# ---------------------------------------------------------------------------
# Delay state in arena form
# ---------------------------------------------------------------------------
_ARENA_FIELDS = ("ring", "scales", "residual", "staging", "counts", "head",
                 "due", "stale")


class GradArena:
    """The delay ring + int8 error feedback, all contiguous, on one
    device. ``ring`` is f32 (compression "none") or int8; ``scales``
    (per-row f32), ``residual`` and ``staging`` ((n_pods, rows, 128) f32)
    exist only under int8. Three ring layouts:

      v2  ``ring`` a tuple of ``tau + 1`` per-slot (n_pods, rows, 128)
          buffers, ``scales`` a tuple of (n_pods, rows); ``counts``
          (tau + 1, n_pods) f32; ``head`` a 0-dim int32 mirroring
          ``phase``, the slot to overwrite next.
      v1  ``ring`` one stacked (tau, n_pods, rows, 128) buffer,
          ``scales`` (tau, n_pods, rows); ``head`` the device-side slot
          to pop and overwrite; ``phase`` stays 0.
      v3  the delay-tolerant ring: stacked (n_slots, ...) like v1, with
          n_slots = tau_max + 1, pushed at the v2 phase schedule;
          ``due`` and ``stale`` ((n_slots,) int32) tag each slot with
          the step it is applied at and the delay it was pushed with;
          ``head`` is the absolute step counter and ``phase`` mirrors
          ``head % n_slots``.

    ``due`` and ``stale`` are None on fixed-tau rings."""

    __slots__ = _ARENA_FIELDS + ("phase",)

    def __init__(self, ring, scales, residual, staging, counts, head,
                 due=None, stale=None, phase: int = 0):
        self.ring = ring
        self.scales = scales
        self.residual = residual
        self.staging = staging
        self.counts = counts
        self.head = head
        self.due = due
        self.stale = stale
        self.phase = int(phase)

    def _replace(self, **kw) -> "GradArena":
        vals = {f: getattr(self, f) for f in self.__slots__}
        vals.update(kw)
        return GradArena(**vals)


def init_arena(layout: ArenaLayout, tau: int, n_pods: int,
               compression: str = "none", device="cuda",
               ring_version: int = 2, variable: bool = False,
               local: Optional[Tuple[int, int]] = None
               ) -> Optional[GradArena]:
    """Allocate the delay state on ``device`` (None for tau = 0). With
    ``variable=True``, ``tau`` is the cap ``tau_max`` of a stochastic
    delay process and the ring is the delay-tolerant v3 layout:
    ``tau + 1`` stacked slots with ``due``/``stale`` tags.
    ``ring_version=1`` gives the stacked fixed ring of ``tau`` slots.
    ``local=(local_pods, rows_local)``: a rank's shard under a
    multi-rank mesh (ring, scales, residual and staging hold that many
    pods and rows; the counts stay (n_slots, n_pods))."""
    if tau == 0:
        return None
    if ring_version not in (1, 2):
        raise ValueError(f"unknown ring_version {ring_version!r}")
    if variable and ring_version != 2:
        raise ValueError("the delay-tolerant (variable-delay) ring "
                         "extends the default v2 schedule (stored "
                         "stacked as layout v3); ring_version=1 has no "
                         "delay-tolerant form")
    if compression not in ("none", "int8"):
        raise ValueError(f"unknown pod_compression {compression!r}")
    device = resolve_device(device)
    shape = (n_pods, layout.rows, LANES) if local is None else \
        (*local, LANES)
    f32 = dict(dtype=torch.float32, device=device)
    v2 = ring_version == 2
    n_slots = tau + 1 if v2 else tau
    stacked = variable or not v2      # v1 and v3 share the stacked shape
    residual = staging = scales = None
    if compression == "int8":
        if stacked:
            ring = torch.zeros((n_slots,) + shape, dtype=torch.int8,
                               device=device)
            scales = torch.ones((n_slots,) + shape[:2], **f32)
        else:
            ring = tuple(torch.zeros(shape, dtype=torch.int8, device=device)
                         for _ in range(n_slots))
            scales = tuple(torch.ones(shape[:2], **f32)
                           for _ in range(n_slots))
        residual = torch.zeros(shape, **f32)
        staging = torch.zeros(shape, **f32)
    elif stacked:
        ring = torch.zeros((n_slots,) + shape, **f32)
    else:
        ring = tuple(torch.zeros(shape, **f32) for _ in range(n_slots))
    due = stale = None
    if variable:
        # due = -1: never applied (the step counter starts at 0); stale
        # = 0 until a push tags the slot
        due = torch.full((n_slots,), -1, dtype=torch.int32, device=device)
        stale = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    return GradArena(ring=ring, scales=scales, residual=residual,
                     staging=staging,
                     counts=torch.zeros((n_slots, n_pods), **f32),
                     head=torch.zeros((), dtype=torch.int32, device=device),
                     due=due, stale=stale, phase=0)


def ring_version(arena: GradArena) -> int:
    """2 for the per-slot tuple layout (fixed rings, the default), 3 for
    the stacked delay-tolerant ring, 1 for the stacked fixed ring."""
    if isinstance(arena.ring, tuple):
        return 2
    return 3 if is_variable(arena) else 1


def is_variable(arena: GradArena) -> bool:
    """True for delay-tolerant rings (per-slot due/stale tags)."""
    return arena.due is not None


def arena_tau(arena: GradArena) -> int:
    """The staleness depth tau this arena implements (v2 and v3 carry
    one spare slot beyond tau)."""
    v = ring_version(arena)
    if v == 2:
        return len(arena.ring) - 1
    if v == 3:
        return int(arena.ring.shape[0]) - 1
    return int(arena.ring.shape[0])


def convert_ring(arena: GradArena, version: int) -> GradArena:
    """Convert a fixed ring between layouts v1 and v2. v1 slot
    ``(head + i) % tau`` (the i-th oldest entry) becomes v2 slot
    ``1 + i`` with phase and head reset to 0 (v2 pops slot phase + 1
    first, so slot 1 holds the oldest entry; slot 0, the first push
    target, is dead and zeroed); v2 to v1 is the inverse. Reads
    ``head`` on the host: a migration, not a step."""
    if ring_version(arena) == version:
        return arena
    if is_variable(arena):
        raise ValueError("variable-delay rings have no v1 layout and "
                         "no per-slot v2 form (they are always the "
                         "stacked v3 layout, which carries the "
                         "due/stale metadata)")
    head = torch.zeros_like(arena.head)
    if version == 2:
        tau = int(arena.ring.shape[0])
        h = int(arena.head)
        perm = [(h + i) % tau for i in range(tau)]
        ring = ((torch.zeros_like(arena.ring[0]),)
                + tuple(arena.ring[k].clone() for k in perm))
        scales = None
        if arena.scales is not None:
            scales = ((torch.ones_like(arena.scales[0]),)
                      + tuple(arena.scales[k].clone() for k in perm))
        counts = torch.cat([torch.zeros_like(arena.counts[:1]),
                            arena.counts[perm]])
        return arena._replace(ring=ring, scales=scales, counts=counts,
                              head=head, phase=0)
    if version == 1:
        tau = len(arena.ring) - 1
        p = arena.phase
        perm = [(p + 1 + i) % (tau + 1) for i in range(tau)]
        ring = torch.stack([arena.ring[k] for k in perm])
        scales = None
        if arena.scales is not None:
            scales = torch.stack([arena.scales[k] for k in perm])
        counts = torch.stack([arena.counts[k] for k in perm])
        return arena._replace(ring=ring, scales=scales, counts=counts,
                              head=head, phase=0)
    raise ValueError(f"unknown ring_version {version!r}")


def arena_logical_axes(arena: GradArena) -> GradArena:
    """Logical axes per arena field, the JAX package's table (None
    fields stay None): rows over the intra-pod slice ("flat"), slots
    replicated, pods on 'pod'; a v2 ring one entry per slot buffer, the
    stacked layouts one entry with a replicated slot dim. Under a mesh
    the port keeps ``counts`` whole on every rank, where this table
    shards its pod dim: each rank knows every pod's count from the
    step's one gather of the pods' counts."""
    if ring_version(arena) == 2:
        ring_ax = tuple(("pod", "flat", None) for _ in arena.ring)
        scales_ax = (None if arena.scales is None
                     else tuple(("pod", "flat") for _ in arena.scales))
    else:
        ring_ax = (None, "pod", "flat", None)
        scales_ax = None if arena.scales is None else (None, "pod", "flat")
    return GradArena(
        ring=ring_ax, scales=scales_ax,
        residual=None if arena.residual is None else ("pod", "flat", None),
        staging=None if arena.staging is None else ("pod", "flat", None),
        counts=(None, "pod"), head=(),
        due=None if arena.due is None else (None,),
        stale=None if arena.stale is None else (None,),
        phase=arena.phase)


def arena_specs(arena: GradArena, mesh) -> GradArena:
    """``arena_logical_axes`` resolved against ``mesh`` (a MeshConfig),
    field by field."""
    from repro_torch.dist.sharding import spec_for
    axes = arena_logical_axes(arena)

    def resolve(ax, t):
        if ax is None:
            return None
        if isinstance(t, tuple):     # a v2 ring's per-slot buffers
            return tuple(resolve(a, x) for a, x in zip(ax, t))
        return spec_for(tuple(ax), tuple(t.shape), mesh)

    return GradArena(**{f: resolve(getattr(axes, f), getattr(arena, f))
                        for f in _ARENA_FIELDS}, phase=arena.phase)


def row_scales(layout: ArenaLayout, fed, row0: int = 0,
               group=None, axis: str = "data") -> torch.Tensor:
    """Per-row int8 scales reproducing the per-(pod, leaf) symmetric
    scales bitwise: a row max, a segment max over the static
    row -> leaf map, max(amax, 1e-12) / 127. fed: (n_pods, rows, 128)
    f32. Returns (n_pods, rows) f32. On a row shard (rows ``row0`` on
    of the arena) ``group`` is the group the rows shard over (``axis``
    its name in the census): the per-leaf maxima are all-reduced (MAX)
    across it, still bitwise (a max is a max whatever the order)."""
    r2l = layout.row_to_leaf_on(fed.device)
    if fed.shape[1] != layout.rows:
        r2l = r2l[row0:row0 + fed.shape[1]]
    rowmax = torch.amax(torch.abs(fed), dim=-1)                # (P, rows)
    n_pods = fed.shape[0]
    # a leaf with no row here keeps 0, below any |fed| of another shard
    amax = torch.zeros((n_pods, layout.n_leaves + 1), dtype=torch.float32,
                       device=fed.device)
    amax.scatter_reduce_(1, r2l.expand(n_pods, -1), rowmax, reduce="amax",
                         include_self=False)
    if group is not None:
        import torch.distributed as dist

        from repro_torch.dist.collectives import all_reduce
        all_reduce(amax, group, op=dist.ReduceOp.MAX, axis=axis,
                   tag="scales_max")
    # sentinel segment (tail pad rows) -> scale 1: pads are zero
    amax[:, layout.n_leaves] = 127.0
    c127 = torch.full((), 127.0, dtype=torch.float32, device=fed.device)
    scales = torch.div(torch.clamp(amax, min=1e-12), c127)
    return torch.index_select(scales, 1, r2l)


def _slot_pod_sum(slot, scales_slot=None):
    """Left fold over the pods of one slot, dequantized under int8
    (``q.f32 * s``, its own op, as the JAX package pins it): bitwise
    the JAX off-mesh ``_slot_pod_sum``. With one f32 pod it returns the
    view ``slot[0]``."""
    acc = None
    for p in range(slot.shape[0]):
        x = slot[p]
        if scales_slot is not None:
            x = x.to(torch.float32) * scales_slot[p][:, None]
        acc = x if acc is None else acc + x
    return acc


def _fed(layout: ArenaLayout, arena: GradArena, pod_grads, ranks=None):
    """The int8 push's first half: fed = g + residual in arena form,
    written into the staging buffer, and its per-row scales. Off the
    mesh ``pod_grads`` is the pod-stacked tree (``scatter_fed``); under
    a multi-rank mesh (``ranks``) it is the rank's (local_pods,
    rows_local, 128) arena-form shard, whose pads are zero already, and
    the scales' per-leaf maxima are reduced over the group its rows
    shard over. Returns (fed, scale_new)."""
    if ranks is None:
        fed = scatter_fed(layout, pod_grads, arena.residual,
                          out=arena.staging)
        return fed, row_scales(layout, fed)
    fed = torch.add(pod_grads, arena.residual, out=arena.staging)
    _, row0, group = shard_rows(layout, ranks)
    return fed, row_scales(layout, fed, row0=row0, group=group,
                           axis=rows_axis(ranks))


def _int8_quantize(layout: ArenaLayout, arena: GradArena, pod_grads,
                   ranks=None):
    """The int8 push arithmetic of the stacked rings (v1 on the CPU, v3):
    fed and its scales (``_fed``), q = clip(round(fed / s), -127, 127),
    and the error-feedback residual fed - q * s written over the old
    residual's buffer (its contents are spent once fed is formed).
    Returns (q f32, scale_new)."""
    fed, scale_new = _fed(layout, arena, pod_grads, ranks)
    s = scale_new[..., None]
    q = torch.clamp(torch.round(fed / s), -127, 127)
    torch.sub(fed, q * s, out=arena.residual)
    return q, scale_new


def push_pop(layout: ArenaLayout, arena: GradArena, pod_grads, pod_counts,
             compression: str = "none"
             ) -> Tuple[torch.Tensor, torch.Tensor, GradArena]:
    """One fixed-tau rotation (the port of ``repro.core.arena.push_pop``):
    insert this step's pod-stacked gradient tree, return the tau-old
    entry summed over pods, its count, and the updated arena.

    pod_grads: dict of (n_pods, *shape) tensors; pod_counts: (n_pods,)
    f32. Returns (grad_sum (rows, 128) f32, count () f32, new_arena).
    On a v2 ring the returned grad_sum may be a view of the popped
    slot: read it before the next rotation. Under a multi-rank mesh
    (``sharded_route``) ``pod_grads`` is the rank's (local_pods,
    rows_local, 128) arena-form shard and grad_sum its rows, summed over
    every pod; a v1 ring raises there."""
    if is_variable(arena):
        raise ValueError("delay-tolerant arenas rotate via "
                         "push_pop_variable (per-step tau_t), not the "
                         "fixed-tau push_pop")
    if compression not in ("none", "int8"):
        raise ValueError(f"unknown pod_compression {compression!r}")
    ranks = sharded_route("push_pop")
    if ring_version(arena) == 2:
        return _push_pop_v2(layout, arena, pod_grads, pod_counts,
                            compression, ranks)
    if ranks is not None:
        raise ValueError(
            "a v1 (stacked fixed) ring has no sharded rotate (nor has the "
            "JAX package's); under a multi-rank mesh use the default v2 "
            "ring (convert_ring(arena, 2))")
    return _push_pop_v1(layout, arena, pod_grads, pod_counts, compression)


def sharded_route(what: str):
    """The ambient mesh's ``dist.collectives.Ranks`` when a multi-rank
    mesh is active (a ``dist.context`` profile of more than one device),
    else None. Raises when that mesh has no ``DeviceMesh`` or process
    group behind it: the sharded route never falls back to the stacked
    one."""
    from repro_torch.dist.context import active_mesh
    mesh = active_mesh()
    if mesh is None or mesh.n_devices == 1:
        return None
    from repro_torch.dist.collectives import require_mesh
    return require_mesh(what)


def shard_rows(layout: ArenaLayout, ranks) -> Tuple[int, int, Any]:
    """(rows_local, row0, group or None): the block of the arena's rows
    this rank holds, where ``dist.sharding.block`` places it under
    ``arena_slot_specs``'s row spec (JAX's global layout of the whole
    parameter tree, cut into ``data x model`` blocks, ``data`` the
    slowest), and the group of the ranks that share its pod's rows (all
    the rows, and no group, where the spec does not split them)."""
    from repro_torch.dist.context import active_mesh
    from repro_torch.dist.sharding import arena_slot_specs, block, entry_axes
    mesh = active_mesh()
    _, _, row_spec = arena_slot_specs(mesh, layout.rows)
    entry = row_spec[0] if row_spec else None
    n, idx = block(entry, mesh, ranks.coords)
    if n == 1:
        return layout.rows, 0, None
    rows_local = layout.rows // n
    return rows_local, idx * rows_local, ranks.group(entry_axes(entry))


def rows_axis(ranks) -> str:
    """The census's name of the group the arena's rows shard over."""
    from repro_torch.dist.collectives import axis_label
    return axis_label(("data", "model"), ranks.sizes)


_SHARDED_FIELDS = ("ring", "scales", "residual", "staging")


def arena_shard_specs(layout: ArenaLayout, arena: GradArena, mesh
                      ) -> Dict[str, Any]:
    """The spec of each arena buffer a rank holds a shard of under a
    multi-rank ``mesh`` (a MeshConfig), keyed by its checkpoint path
    within the arena (".ring/0", ".residual", ...): ``arena_specs`` of
    the whole stacked arena's shapes (``mesh.n_pods`` pods,
    ``layout.rows`` rows). The counts, head and tags are whole on every
    rank."""
    axes = arena_logical_axes(arena)

    def whole(ax, t):
        if isinstance(t, tuple):            # a v2 ring's slot buffers
            return tuple(whole(a, x) for a, x in zip(ax, t))
        return torch.empty([mesh.n_pods if a == "pod" else
                            layout.rows if a == "flat" else n
                            for a, n in zip(ax, t.shape)], device="meta")

    full = arena._replace(**{f: whole(getattr(axes, f), getattr(arena, f))
                             for f in _SHARDED_FIELDS
                             if getattr(arena, f) is not None})
    specs = arena_specs(full, mesh)
    out = {}
    for f in _SHARDED_FIELDS:
        spec = getattr(specs, f)
        if type(spec) is tuple:             # per slot (a Spec is a tuple)
            out.update({f".{f}/{i}": s for i, s in enumerate(spec)})
        elif spec is not None:
            out[f".{f}"] = spec
    return out


def _push_pop_v2(layout, arena, pod_grads, pod_counts, compression,
                 ranks=None):
    """One v2 rotation: push slot ``phase``, pop slot ``(phase + 1) %
    (tau + 1)``.

    int8: fed = g + residual is written into the staging buffer, the
    per-row scales come from fed (``_fed``), and the slot rotate
    (``kernels.delay_ring.ops``: the CUDA kernel on the card, the plain
    version on the CPU) dequantizes the pop, quantizes fed into the
    push slot and writes the residual over fed; staging and residual
    then swap buffers. "none" needs no kernel: the pop is a read of one
    slot and the push a copy into the other.

    Under a multi-rank mesh (``ranks``) ``pod_grads`` is the rank's
    shard in arena form: int8 takes ``ring_slot_rotate_int8_sharded``
    (the compressed pop all-gathered over the pods and folded, the push
    by the kernel); f32 folds the pop slot's local pods and all-reduces
    them over the pods."""
    from repro_torch.kernels.delay_ring import ops
    n_slots = len(arena.ring)
    push_i = arena.phase
    pop_i = (push_i + 1) % n_slots
    count = torch.sum(arena.counts[pop_i])

    if compression == "int8":
        fed, scale_new = _fed(layout, arena, pod_grads, ranks)
        rotate = (ops.ring_slot_rotate_int8 if ranks is None
                  else ops.ring_slot_rotate_int8_sharded)
        popped, _, _, residual = rotate(
            arena.ring[pop_i], arena.scales[pop_i], arena.ring[push_i],
            arena.scales[push_i], fed, scale_new)
        # the sharded rotate returns the pods' sum already
        grad_sum = pod_sum(popped) if ranks is None else popped
        # buffer swap: the old residual is next step's scratch
        staging = arena.residual
    else:
        slot = arena.ring[pop_i]
        grad_sum = pod_sum(slot)
        if ranks is None:
            flatten_tree(layout, pod_grads, leading=1,
                         out=arena.ring[push_i])
        else:
            from repro_torch.dist.collectives import all_reduce
            # one local pod: a view of the slot; the reduce must not
            # write it
            grad_sum = all_reduce(grad_sum.clone() if slot.shape[0] == 1
                                  else grad_sum, ranks.group("pod"),
                                  axis="pod", tag="pod_pop")
            arena.ring[push_i].copy_(pod_grads)
        residual, staging = None, None

    arena.counts[push_i].copy_(pod_counts)
    next_phase = (push_i + 1) % n_slots
    arena.head.fill_(next_phase)
    return grad_sum, count, arena._replace(residual=residual,
                                           staging=staging, phase=next_phase)


def _pop_sum(ring, head, scales=None):
    """v1, CPU tensors: the pod sum of ring[head], dequantized (the JAX
    off-mesh ``_pop_sum``). Reads ``head`` on the host; the result
    never aliases the ring."""
    h = int(head)
    acc = _slot_pod_sum(ring[h], None if scales is None else scales[h])
    # one f32 pod: a view of the slot the push is about to overwrite
    return acc.clone() if scales is None and ring.shape[1] == 1 else acc


def _scatter_slot(layout: ArenaLayout, ring, tree, head):
    """v1, CPU tensors: scatter the pod-stacked tree straight into
    ring[head] (reads ``head`` on the host)."""
    flatten_tree(layout, tree, leading=1, out=ring[int(head)])
    return ring


def _update_slot_int8(ring, scales, q, scale_new, head):
    """v1, CPU tensors: write the quantized slot and its per-row scales
    into slot ``head`` (read on the host)."""
    h = int(head)
    ring[h].copy_(q)
    scales[h].copy_(scale_new)
    return ring, scales


def _push_pop_v1(layout, arena, pod_grads, pod_counts, compression):
    """One v1 rotation: pop and push the stacked ring's slot ``head``.
    On the card the ring rotate kernel (``ring_push_pop``) does both in
    one pass with the head read on the device; on the CPU the pod-sum
    pop, then the scatter (the JAX package's XLA path)."""
    from repro_torch.kernels import resolve_impl
    from repro_torch.kernels.delay_ring.ops import ring_push_pop
    head = arena.head
    idx = head.reshape(1).to(torch.int64)
    count = torch.sum(torch.index_select(arena.counts, 0, idx))
    int8 = compression == "int8"
    ring, scales = arena.ring, arena.scales
    residual, staging = arena.residual, arena.staging
    if resolve_impl("auto", ring) == "kernel":
        if int8:
            fed = scatter_fed(layout, pod_grads, arena.residual,
                              out=arena.staging)
            popped, _, _, residual = ring_push_pop(
                ring, fed, head, scales=scales,
                scale_new=row_scales(layout, fed))
            # buffer swap: the old residual is next step's scratch
            staging = arena.residual
        else:
            popped, _, _, _ = ring_push_pop(
                ring, flatten_tree(layout, pod_grads, leading=1), head)
        grad_sum = pod_sum(popped)
    elif int8:
        q, scale_new = _int8_quantize(layout, arena, pod_grads)
        grad_sum = _pop_sum(ring, head, scales)
        _update_slot_int8(ring, scales, q.to(torch.int8), scale_new, head)
    else:
        grad_sum = _pop_sum(ring, head)
        _scatter_slot(layout, ring, pod_grads, head)
    arena.counts.index_copy_(0, idx, pod_counts[None])
    next_head = torch.remainder(head + 1, arena.counts.shape[0])
    return grad_sum, count, arena._replace(residual=residual,
                                           staging=staging, head=next_head)


def _scatter_slot_stacked(layout: ArenaLayout, ring, tree, k: int):
    """Scatter the pod-stacked tree straight into stacked slot
    ``ring[k]`` (k chosen on the host), in place."""
    flatten_tree(layout, tree, leading=1, out=ring[k])
    return ring


def _variable_pop_ref(ring, scales, mask):
    """The CPU path's pop of the stacked delay-tolerant ring: gather the
    due slots (the JAX package's off-mesh ``_variable_pop_ref``). Each
    due slot's pods are folded first (``_slot_pod_sum``), then the due
    slots in ascending j: no arrival pops an exact zero, one arrival
    is that slot's pod sum exactly (the static path's single pop), more
    fold from a zero accumulator. Reads the due slots' indices on the
    host: CPU tensors only. A slot that is not due is never read."""
    due = torch.nonzero(mask).flatten().tolist()
    pop = [_slot_pod_sum(ring[j], None if scales is None else scales[j])
           for j in due]
    if len(pop) == 1:
        return pop[0]
    acc = torch.zeros(ring.shape[2:], dtype=torch.float32,
                      device=ring.device)
    for x in pop:
        acc = acc + x
    return acc


def push_pop_variable(layout: ArenaLayout, arena: GradArena, pod_grads,
                      pod_counts, delay, compression: str = "none"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 GradArena]:
    """Delay-tolerant rotation for a stochastic per-step delay (the port
    of ``repro.core.arena.push_pop_variable``): this step's gradient is
    pushed with delay ``tau_t = delay`` (clipped to the ring's cap) and
    applied ``tau_t`` steps later; the pop folds every slot due exactly
    now.

    * ``head`` is the absolute step counter t; the push slot is
      ``phase = t % n_slots``, whose previous entry was pushed at
      t - n_slots and so was due by t - 1 at the latest: no unread slot
      is overwritten;
    * the push tags its slot ``due[k] = t + tau_t``, ``stale[k] = tau_t``
      and records its counts; under int8 it quantizes with error
      feedback exactly as the fixed path does;
    * the pop folds the slots with ``due == t`` (the post-push ring, so
      tau_t = 0 delivers at once): on CUDA tensors one launch of the
      variable-pop kernel, then the pod fold (``pod_sum``); on CPU
      tensors the gather of ``_variable_pop_ref``. Steps with no
      arrival pop an exact zero with count 0.

    ``tau_obs`` is the count-weighted mean staleness of what was
    applied, 0 on a step with no arrival (the caller falls back to the
    ring's cap there). Nothing is read to the host on the card: t,
    ``delay`` and every scalar stay device tensors.

    pod_grads: dict of (n_pods, *shape) tensors (under a multi-rank mesh
    the rank's (local_pods, rows_local, 128) arena-form shard, the pop
    then ``ring_variable_pop_sharded``); pod_counts: (n_pods,) f32;
    delay: 0-dim int tensor on the arena's device (or a Python int).
    Returns (grad_sum (rows, 128) f32, count () f32, tau_obs () f32,
    new_arena)."""
    from repro_torch.kernels import resolve_impl
    from repro_torch.kernels.delay_ring.ops import ring_variable_pop
    if not is_variable(arena):
        raise ValueError("push_pop_variable needs a delay-tolerant "
                         "arena (init_arena(..., variable=True)); "
                         "fixed-tau rings rotate via push_pop")
    if compression not in ("none", "int8"):
        raise ValueError(f"unknown pod_compression {compression!r}")
    ranks = sharded_route("push_pop_variable")
    ring, scales = arena.ring, arena.scales
    n_slots = int(ring.shape[0])
    k = arena.phase
    t = arena.head
    if not torch.is_tensor(delay):
        delay = torch.full((), int(delay), dtype=torch.int32,
                           device=t.device)
    delay = torch.clamp(delay.to(torch.int32), 0, n_slots - 1)
    arena.due[k] = t + delay
    arena.stale[k] = delay
    arena.counts[k].copy_(pod_counts)

    if compression == "int8":
        q, scale_new = _int8_quantize(layout, arena, pod_grads, ranks)
        ring[k].copy_(q.to(torch.int8))
        scales[k].copy_(scale_new)
    elif ranks is None:
        _scatter_slot_stacked(layout, ring, pod_grads, k)
    else:
        ring[k].copy_(pod_grads)

    mask = arena.due == t
    cs = torch.stack([torch.sum(arena.counts, dim=1),
                      arena.stale.to(torch.float32)])
    if ranks is not None:
        from repro_torch.kernels.delay_ring.ops import \
            ring_variable_pop_sharded
        grad_sum, meta = ring_variable_pop_sharded(ring, mask, scales=scales,
                                                   counts_stale=cs)
    elif resolve_impl("auto", ring) == "kernel":
        partial, meta = ring_variable_pop(ring, mask, scales=scales,
                                          counts_stale=cs)
        grad_sum = pod_sum(partial)
    else:
        from repro_torch.kernels.delay_ring.ref import ring_variable_meta_ref
        grad_sum = _variable_pop_ref(ring, scales, mask)
        meta = ring_variable_meta_ref(mask, cs)
    count, stale_sum = meta[0], meta[1]
    tau_obs = torch.div(stale_sum, torch.clamp(count, min=1.0))
    return grad_sum, count, tau_obs, arena._replace(
        head=t + 1, phase=(k + 1) % n_slots)
