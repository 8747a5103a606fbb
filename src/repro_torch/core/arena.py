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

The port carries ring layout v2 only (the JAX default for a fixed
tau): ``tau + 1`` per-slot buffers, selected by a phase counter kept as
a Python int, so each step pops slot ``(phase + 1) % (tau + 1)`` and
overwrites slot ``phase``, two different buffers. Where the JAX package
donates buffers to ``jit`` (``input_output_aliases`` in the kernels,
``donate_argnums`` in the loop), the port writes in place: the push
slot, its scales, the staging buffer and the residual are updated where
they lie, and an arena passed to ``push_pop`` must not be used again
(use the one it returns).
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
# Delay state in arena form (ring layout v2)
# ---------------------------------------------------------------------------
class GradArena:
    """The delay ring + int8 error feedback, all contiguous, on one
    device. ``ring`` is a tuple of ``tau + 1`` per-slot (n_pods, rows,
    128) buffers, f32 (compression "none") or int8; ``scales`` (a tuple
    of (n_pods, rows) f32), ``residual`` and ``staging`` ((n_pods, rows,
    128) f32) exist only under int8. ``counts`` is (tau + 1, n_pods)
    f32; ``head`` a 0-dim int32 tensor mirroring ``phase`` (the slot to
    overwrite next), as the JAX arena records it for checkpoints."""

    __slots__ = ("ring", "scales", "residual", "staging", "counts", "head",
                 "phase")

    def __init__(self, ring, scales, residual, staging, counts, head,
                 phase: int = 0):
        self.ring = ring
        self.scales = scales
        self.residual = residual
        self.staging = staging
        self.counts = counts
        self.head = head
        self.phase = int(phase)


def init_arena(layout: ArenaLayout, tau: int, n_pods: int,
               compression: str = "none", device="cuda"
               ) -> Optional[GradArena]:
    """Allocate the v2 delay state on ``device`` (None for tau = 0)."""
    if tau == 0:
        return None
    if compression not in ("none", "int8"):
        raise ValueError(f"unknown pod_compression {compression!r}")
    device = resolve_device(device)
    shape = (n_pods, layout.rows, LANES)
    f32 = dict(dtype=torch.float32, device=device)
    n_slots = tau + 1
    if compression == "int8":
        ring = tuple(torch.zeros(shape, dtype=torch.int8, device=device)
                     for _ in range(n_slots))
        scales = tuple(torch.ones(shape[:2], **f32) for _ in range(n_slots))
        residual = torch.zeros(shape, **f32)
        staging = torch.zeros(shape, **f32)
    else:
        ring = tuple(torch.zeros(shape, **f32) for _ in range(n_slots))
        scales = residual = staging = None
    return GradArena(ring=ring, scales=scales, residual=residual,
                     staging=staging,
                     counts=torch.zeros((n_slots, n_pods), **f32),
                     head=torch.zeros((), dtype=torch.int32, device=device),
                     phase=0)


def row_scales(layout: ArenaLayout, fed) -> torch.Tensor:
    """Per-row int8 scales reproducing the per-(pod, leaf) symmetric
    scales bitwise: a row max, a segment max over the static
    row -> leaf map, max(amax, 1e-12) / 127. fed: (n_pods, rows, 128)
    f32. Returns (n_pods, rows) f32."""
    r2l = layout.row_to_leaf_on(fed.device)
    rowmax = torch.amax(torch.abs(fed), dim=-1)                # (P, rows)
    n_pods = fed.shape[0]
    amax = torch.zeros((n_pods, layout.n_leaves + 1), dtype=torch.float32,
                       device=fed.device)
    amax.scatter_reduce_(1, r2l.expand(n_pods, -1), rowmax, reduce="amax",
                         include_self=False)
    # sentinel segment (tail pad rows) -> scale 1: pads are zero
    amax[:, layout.n_leaves] = 127.0
    c127 = torch.full((), 127.0, dtype=torch.float32, device=fed.device)
    scales = torch.div(torch.clamp(amax, min=1e-12), c127)
    return torch.index_select(scales, 1, r2l)


def push_pop(layout: ArenaLayout, arena: GradArena, pod_grads, pod_counts,
             compression: str = "none"
             ) -> Tuple[torch.Tensor, torch.Tensor, GradArena]:
    """One v2 rotation (the port of ``repro.core.arena.push_pop`` on a
    v2 ring): insert this step's pod-stacked gradient tree into slot
    ``phase``, return the tau-old entry of slot ``(phase + 1) %
    (tau + 1)`` summed over pods, its count, and the updated arena.

    int8: fed = g + residual is written into the staging buffer, the
    per-row scales come from fed, and the slot rotate
    (``kernels.delay_ring.ops``: the CUDA kernel on the card, the plain
    version on the CPU) dequantizes the pop, quantizes fed into the
    push slot and writes the residual over fed; staging and residual
    then swap buffers. "none" needs no kernel: the pop is a read of one
    slot and the push a copy into the other.

    pod_grads: dict of (n_pods, *shape) tensors; pod_counts: (n_pods,)
    f32. Returns (grad_sum (rows, 128) f32, count () f32, new_arena).
    The returned grad_sum may be a view of the popped slot: read it
    before the next rotation."""
    from repro_torch.kernels.delay_ring.ops import ring_slot_rotate_int8
    n_slots = len(arena.ring)
    push_i = arena.phase
    pop_i = (push_i + 1) % n_slots
    count = torch.sum(arena.counts[pop_i])

    if compression == "int8":
        fed = scatter_fed(layout, pod_grads, arena.residual,
                          out=arena.staging)
        scale_new = row_scales(layout, fed)
        popped, _, _, residual = ring_slot_rotate_int8(
            arena.ring[pop_i], arena.scales[pop_i], arena.ring[push_i],
            arena.scales[push_i], fed, scale_new)
        grad_sum = pod_sum(popped)
        # buffer swap: the old residual is next step's scratch
        staging = arena.residual
    elif compression == "none":
        grad_sum = pod_sum(arena.ring[pop_i])
        flatten_tree(layout, pod_grads, leading=1, out=arena.ring[push_i])
        residual, staging = None, None
    else:
        raise ValueError(f"unknown pod_compression {compression!r}")

    arena.counts[push_i].copy_(pod_counts)
    next_phase = (push_i + 1) % n_slots
    arena.head.fill_(next_phase)
    return grad_sum, count, GradArena(
        ring=arena.ring, scales=arena.scales, residual=residual,
        staging=staging, counts=arena.counts, head=arena.head,
        phase=next_phase)
