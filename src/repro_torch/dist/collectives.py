"""The collectives of the multi-process path, over the groups of the
ambient ``DeviceMesh`` (dims "pod", "data", "model"):

  pod    the cross-site channel of the paper: the folded f32 rows of
         the variable pop (one ``all_reduce`` a step), the compressed
         int8 payload and its row scales of the slot rotate
         (``all_gather``), each pod's count and loss (``all_gather``);
  data   the intra-pod slice the arena's rows shard over: the pod's
         gradient rows (``reduce_scatter``), the dual update's w
         (``all_gather``), the int8 scales' per-leaf maxima and the
         step's sums of squares (``all_reduce``).

Every call goes to the group whatever its size (a group of one still
runs through its backend). A collective that fails raises: nothing here
falls back to another route or copies a tensor to the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.dist.context import active_device_mesh

AXES = ("pod", "data", "model")

# the single-tensor forms, under their current names where they exist
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class Ranks(NamedTuple):
    """Where this rank sits in the ambient mesh: its coordinates and
    the axis sizes, by axis name."""
    device_mesh: object
    coords: Dict[str, int]
    sizes: Dict[str, int]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

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


def all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group-rank order."""
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous().reshape(-1), group=group)
    return out.reshape((n,) + tuple(x.shape))


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the group, in place; returns ``x``."""
    dist.all_reduce(x, op=op, group=group)
    return x


def reduce_scatter_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over the group of ``x`` (rows, ...), this rank keeping
    its block of rows / n."""
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _reduce_scatter(out, x.contiguous(), group=group)
    return out


def all_gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The row blocks of the group's ranks, back to back: (n * rows,
    ...)."""
    out = all_gather(x, group, n)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
