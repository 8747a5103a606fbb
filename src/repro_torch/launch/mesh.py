"""Mesh specs of the port (``repro/launch/mesh.py``).

``parse_mesh`` turns a ``"DxM"`` / ``"PxDxM"`` spec string into a
``MeshConfig`` (a leading pod factor > 1 adds the ``pod`` axis) and
``mesh_label`` is its inverse, as in the JAX package.

``make_mesh`` builds the port's ``Mesh``: one device needs no world; a
``P x D x M`` mesh of more ranks is a ``torch.distributed`` ``DeviceMesh``
with the dims ("pod", "data", "model") over an initialised world of
exactly ``cfg.n_devices`` ranks (``torch.distributed.run`` starts them;
NCCL on cards, gloo for CPU processes), rank p D M + d M + m at (p, d,
m). Where both ``data`` and ``model`` exceed 1 it also makes each pod's
group over their product, the group the arena's rows shard over.
Entering the mesh (``with mesh:``) activates its sharding profile and
its ``DeviceMesh``, under which the arena's rotations, the train step
and, at ``model > 1``, the dense, MoE and hybrid LMs' tensor parallelism
(``dist.tensor_parallel``) take their sharded routes. JAX's TPU pod
mesh (``make_production_mesh``, 256 or 512 chips) raises.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import MeshConfig
from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


class Mesh:
    """A device mesh: its shape and axis names (``cfg``'s), the devices
    of this process (one), and over more than one rank the
    ``DeviceMesh`` and this rank's coordinates. ``with mesh:`` makes it
    the ambient mesh (``dist.context``)."""

    def __init__(self, cfg: MeshConfig, device: torch.device,
                 device_mesh=None):
        self.cfg = cfg
        self.shape: Tuple[int, ...] = cfg.shape
        self.axis_names: Tuple[str, ...] = cfg.axis_names
        self.devices: Tuple[torch.device, ...] = (device,)
        self.device_mesh = device_mesh
        # this rank's index on each of "pod", "data", "model"
        self.coords = (dict.fromkeys(AXES, 0) if device_mesh is None else
                       {a: device_mesh.get_local_rank(a) for a in AXES})
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self):
        from repro_torch.dist.context import (sharding_profile,
                                              use_device_mesh)
        self._stack = contextlib.ExitStack()
        if self.device_mesh is not None:
            self._stack.enter_context(sharding_profile(self.cfg))
            self._stack.enter_context(use_device_mesh(self.device_mesh))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self._stack = None
        return False


def make_production_mesh(*, multi_pod: bool = False):
    shape = "2x16x16" if multi_pod else "16x16"
    n = 512 if multi_pod else 256
    raise NotImplementedError(
        f"the production mesh ({shape}) is a TPU pod of {n} chips; the port "
        f"runs it only over a world of {n} ranks: build it with "
        f"make_mesh(parse_mesh({shape!r})) there")


def make_mesh(cfg: MeshConfig, device="cuda") -> Mesh:
    """The mesh of ``cfg`` on ``device``. One device: no world needed.
    More: a ``P x D x M`` ``DeviceMesh`` over the initialised world,
    whose size must equal ``cfg.n_devices`` (a collective: every rank
    calls it)."""
    device = resolve_device(device)
    if cfg.n_devices == 1:
        return Mesh(cfg, device)
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh {mesh_label(cfg)} spans {cfg.n_devices} ranks, but no "
            "process group is initialised: start the ranks with "
            "torch.distributed.run and call init_process_group first")
    world = dist.get_world_size()
    if world != cfg.n_devices:
        raise ValueError(f"mesh {mesh_label(cfg)} needs {cfg.n_devices} "
                         f"ranks; the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    dm = init_device_mesh(device.type, (cfg.n_pods, cfg.data, cfg.model),
                          mesh_dim_names=AXES)
    if cfg.data > 1 and cfg.model > 1:
        from repro_torch.dist.collectives import register_product_group
        # every rank makes every pod's group, in pod order
        slice_ = cfg.data * cfg.model
        pod = dist.get_rank() // slice_
        for p in range(cfg.n_pods):
            group = dist.new_group(list(range(p * slice_, (p + 1) * slice_)))
            if p == pod:
                register_product_group(dm, ("data", "model"), group)
    return Mesh(cfg, device, dm)


def mesh_config(multi_pod: bool = False) -> MeshConfig:
    return MeshConfig(n_pods=2 if multi_pod else 1, data=16, model=16)


def parse_mesh(spec: str) -> MeshConfig:
    """``"16x16" -> MeshConfig(1, 16, 16)``,
    ``"2x8x8" -> MeshConfig(2, 8, 8)``.  Two factors are (data, model);
    three are (pod, data, model).  A three-factor spec with pod=1
    collapses to the two-axis mesh (``MeshConfig.axis_names`` only
    grows the ``pod`` axis when ``n_pods > 1``, so "1x8x8" and "8x8"
    are the same mesh — and the same label, see ``mesh_label``)."""
    try:
        dims = [int(d) for d in spec.lower().split("x")]
    except ValueError:
        raise ValueError(f"unparsable mesh spec {spec!r} "
                         "(want DxM or PxDxM, e.g. 8x8 or 2x16x16)")
    if len(dims) == 2:
        dims = [1] + dims
    if len(dims) != 3 or any(d < 1 for d in dims):
        raise ValueError(f"mesh spec {spec!r} must have 2 or 3 "
                         "positive factors (DxM or PxDxM)")
    return MeshConfig(n_pods=dims[0], data=dims[1], model=dims[2])


def mesh_label(cfg: MeshConfig) -> str:
    """Canonical cell label; inverse of ``parse_mesh``."""
    return "x".join(str(d) for d in cfg.shape)
