"""The ambient mesh: the port of ``repro/dist/context.py``.

    with sharding_profile(rc.mesh):            # train profile
        ...
    with sharding_profile(rc.mesh, "serve"):   # serve profile
        ...

``constrain(x, axes)`` resolves the logical axes against the active
profile. Eager PyTorch has no sharding annotation to pin, so it checks
that the axes fit the array and returns ``x`` itself; with no active
profile it is the identity outright, so model code can call it
unconditionally.

``active_device_mesh()`` replaces JAX's ``active_physical_mesh``: the
ambient ``torch.distributed.device_mesh.DeviceMesh`` (set by
``use_device_mesh``, or by entering a ``launch.mesh.Mesh``), or None.
The sharded wrappers take their process groups from it.
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.dist.sharding import spec_for

_state = threading.local()


def _stack(name):
    stack = getattr(_state, name, None)
    if stack is None:
        stack = []
        setattr(_state, name, stack)
    return stack


def _active():
    stack = _stack("profiles")
    return stack[-1] if stack else None


def active_mesh():
    """The MeshConfig of the active sharding profile, or None. The
    arena's rotations take their sharded route only under a profile of
    more than one device."""
    active = _active()
    return active[0] if active is not None else None


def active_device_mesh():
    """The ambient ``DeviceMesh`` (dims "pod", "data", "model"), or
    None."""
    stack = _stack("device_meshes")
    return stack[-1] if stack else None


@contextlib.contextmanager
def sharding_profile(mesh_cfg, profile: str = "train"):
    """Activate (mesh, profile) for ``constrain`` and the arena's
    routes; ``mesh_cfg=None`` deactivates both inside the block."""
    stack = _stack("profiles")
    stack.append(None if mesh_cfg is None else (mesh_cfg, profile))
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def use_device_mesh(device_mesh):
    """Make ``device_mesh`` the ambient one inside the block."""
    stack = _stack("device_meshes")
    stack.append(device_mesh)
    try:
        yield device_mesh
    finally:
        stack.pop()


def constrain(x, axes):
    """``x``, after checking that its logical ``axes`` resolve against
    the active profile (the identity when none is active)."""
    active = _active()
    if active is None:
        return x
    mesh_cfg, profile = active
    spec_for(tuple(axes), tuple(x.shape), mesh_cfg, profile=profile)
    return x
