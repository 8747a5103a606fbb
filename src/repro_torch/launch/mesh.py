"""Mesh specs of the port (``repro/launch/mesh.py``).

``parse_mesh`` turns a ``"DxM"`` / ``"PxDxM"`` spec string into a
``MeshConfig`` (a leading pod factor > 1 adds the ``pod`` axis) and
``mesh_label`` is its inverse, as in the JAX package. The port runs on
one card: ``make_mesh`` takes a one-device mesh, and any larger mesh,
like JAX's TPU pod mesh ``make_production_mesh``, raises until the
multi-GPU slice lands (ROADMAP A.11).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import MeshConfig
from repro_torch.device import resolve_device


class Mesh(NamedTuple):
    """A device mesh: its shape, axis names and devices (row-major)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]


def make_production_mesh(*, multi_pod: bool = False):
    shape = "2x16x16" if multi_pod else "16x16"
    raise NotImplementedError(
        f"the production mesh ({shape}, a TPU pod) needs the multi-GPU "
        "slice (ROADMAP A.11); the port runs on one card")


def make_mesh(cfg: MeshConfig, device="cuda") -> Mesh:
    """The one-device mesh of ``cfg`` on ``device``; a mesh of more
    devices raises (ROADMAP A.11)."""
    if cfg.n_devices != 1:
        raise NotImplementedError(
            f"mesh {mesh_label(cfg)} spans {cfg.n_devices} devices: the "
            "multi-GPU slice is ROADMAP A.11; the port runs on one card")
    return Mesh(cfg.shape, cfg.axis_names, (resolve_device(device),))


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
