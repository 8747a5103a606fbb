"""The port's distribution layer against the JAX package's:

  * the resolver: ``spec_for`` on every parameter leaf (its logical axes
    and shape), ``arena_slot_specs`` / ``arena_ring_specs`` /
    ``publish_ring_specs`` at the arena's rows and ``gossip_specs``,
    entry by entry, for every family's SMOKE config and for
    qwen1.5-0.5b and zamba2-2.7b FULL (shapes only: the port's meta
    tree, JAX's ``eval_shape``), at meshes 1x1, 4x1, 2x8x1, 16x16 and
    2x16x16, in both profiles;
  * the logical axes the port's ``ParamFactory`` records against JAX's
    ``shapes_and_axes(model.init)``;
  * ``batch_specs`` and ``specs_for_state`` over the strategies' states;
  * ``local_shard``, the ambient profile and ``constrain``, and the
    one-device ``make_mesh``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro_torch.configs as C
from repro_torch.configs.base import (AmbdgConfig, ConsensusConfig,
                                      DelayConfig, RunConfig, TRAIN_4K)
from repro_torch.dist import sharding
from repro_torch.launch.mesh import parse_mesh

ARCHS = ["amb-linreg", "amb-cnn", "qwen1.5-0.5b", "qwen3-1.7b", "yi-6b",
         "chatglm3-6b", "mixtral-8x7b", "mixtral-8x22b", "xlstm-125m",
         "zamba2-2.7b", "seamless-m4t-large-v2", "paligemma-3b"]
CONFIGS = [(a, "smoke") for a in ARCHS] + [("qwen1.5-0.5b", "full"),
                                           ("zamba2-2.7b", "full")]
MESHES = ["1x1", "4x1", "2x8x1", "16x16", "2x16x16"]


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


@functools.lru_cache(maxsize=None)
def _port(arch, size):
    from repro_torch.core.arena import make_layout, tree_flatten
    from repro_torch.models.api import build_model
    cfg = C.get_smoke_config(arch) if size == "smoke" else C.get_config(arch)
    model = build_model(cfg, device="cpu")
    shapes, axes = sharding.shapes_and_axes(model)
    return ([tuple(s.shape) for s in tree_flatten(shapes)[0]],
            [tuple(a) for a in tree_flatten(axes)[0]],
            make_layout(shapes).rows)


@functools.lru_cache(maxsize=None)
def _jax(arch, size):
    import jax

    import repro.configs as JC
    from repro.dist.sharding import shapes_and_axes
    from repro.models.api import build_model
    cfg = JC.get_smoke_config(arch) if size == "smoke" else \
        JC.get_config(arch)
    shapes, axes = shapes_and_axes(build_model(cfg).init,
                                   jax.random.PRNGKey(0))
    return ([tuple(s.shape) for s in jax.tree.leaves(shapes)],
            [tuple(a) for a in jax.tree.leaves(axes, is_leaf=_is_axes)])


@pytest.mark.parametrize("arch, size", CONFIGS,
                         ids=[f"{a}-{s}" for a, s in CONFIGS])
def test_param_axes_match_jax(arch, size):
    shapes, axes, _ = _port(arch, size)
    assert (shapes, axes) == _jax(arch, size)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch, size", CONFIGS,
                         ids=[f"{a}-{s}" for a, s in CONFIGS])
def test_specs_match_jax(arch, size, mesh):
    from repro.dist import sharding as jsh
    from repro.launch.mesh import parse_mesh as jparse
    shapes, axes, rows = _port(arch, size)
    cfg, jcfg = parse_mesh(mesh), jparse(mesh)
    for profile in ("train", "serve"):
        for shape, ax in zip(shapes, axes):
            got = sharding.spec_for(ax, shape, cfg, profile)
            assert isinstance(got, sharding.Spec)
            assert got == tuple(jsh.spec_for(ax, shape, jcfg, profile)), (
                profile, shape, ax)
        for fn in ("arena_slot_specs", "arena_ring_specs",
                   "publish_ring_specs"):
            got = getattr(sharding, fn)(cfg, rows, profile)
            want = getattr(jsh, fn)(jcfg, rows, profile)
            assert [tuple(g) for g in got] == [tuple(w) for w in want], fn
    assert [tuple(s) for s in sharding.gossip_specs()] == \
        [tuple(s) for s in jsh.gossip_specs()]
    assert sharding.gossip_specs()._fields == jsh.gossip_specs()._fields


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "paligemma-3b",
                                  "seamless-m4t-large-v2"])
def test_batch_specs_match_jax(arch):
    from repro.dist import batch_specs as jbatch_specs
    from repro.launch.mesh import parse_mesh as jparse
    from repro.models.api import build_model as jbuild
    import repro.configs as JC

    from repro_torch.dist import batch_specs
    from repro_torch.models.api import build_model
    for mesh in ("2x8x1", "16x16"):
        rc = RunConfig(model=C.get_smoke_config(arch), shape=TRAIN_4K,
                       mesh=parse_mesh(mesh))
        jrc = _jax_rc(rc)
        got = batch_specs(build_model(rc.model, device="cpu"), rc)
        want = jbatch_specs(jbuild(JC.get_smoke_config(arch)), jrc)
        assert got == {k: tuple(v) for k, v in want.items()}, mesh
        assert jparse(mesh) == jrc.mesh


def _jax_rc(rc):
    """The JAX package's RunConfig with the same fields."""
    import repro.configs as JC
    from repro.configs import base as jb
    kw = {}
    for f in dataclasses.fields(rc):
        v = getattr(rc, f.name)
        if f.name == "model":
            kw[f.name] = JC.get_smoke_config(
                next(a for a in ARCHS if C.get_smoke_config(a) == v))
        elif dataclasses.is_dataclass(v):
            cls = getattr(jb, type(v).__name__)
            kw[f.name] = cls(**{g.name: getattr(v, g.name)
                                for g in dataclasses.fields(cls)})
        else:
            kw[f.name] = v
    return jb.RunConfig(**kw)


def _port_spec_leaves(node):
    from repro_torch.core.arena import _ARENA_FIELDS, GradArena
    if isinstance(node, sharding.Spec):
        yield tuple(node)
    elif node is None:
        return
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _port_spec_leaves(node[k])
    elif isinstance(node, GradArena):
        for f in _ARENA_FIELDS:
            yield from _port_spec_leaves(getattr(node, f))
    else:
        for c in node:
            yield from _port_spec_leaves(c)


STATES = [
    ("linreg-arena", "amb-linreg", {}),
    ("linreg-arena-int8", "amb-linreg", {"compression": "int8"}),
    ("linreg-variable-int8", "amb-linreg",
     {"compression": "int8", "delay": True}),
    ("linreg-pytree-int8", "amb-linreg",
     {"compression": "int8", "master": "pytree"}),
    ("linreg-kbatch", "amb-linreg", {"strategy": "kbatch"}),
    ("linreg-decentralized", "amb-linreg", {"strategy": "decentralized"}),
    ("qwen-arena-int8", "qwen1.5-0.5b", {"compression": "int8"}),
    ("qwen-pytree", "qwen1.5-0.5b", {"master": "pytree"}),
]


@pytest.mark.parametrize("label, arch, knobs", STATES,
                         ids=[s[0] for s in STATES])
def test_state_specs_match_jax(label, arch, knobs):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro import api as japi
    from repro.dist import specs_for_state as jspecs
    from repro.models.api import build_model as jbuild
    import repro.configs as JC

    from repro_torch import api
    from repro_torch.dist import state_specs
    from repro_torch.models.api import build_model
    cfg = C.get_smoke_config(arch)
    rc = RunConfig(
        model=cfg, shape=dataclasses.replace(TRAIN_4K, seq_len=32,
                                             global_batch=8),
        mesh=parse_mesh("2x4x2"),
        ambdg=AmbdgConfig(tau=2, n_microbatches=2, b_bar=8.0,
                          pod_compression=knobs.get("compression", "none")),
        delay=(DelayConfig(process="heavy_tail", tau_max=4)
               if knobs.get("delay") else DelayConfig()),
        consensus=ConsensusConfig(n_workers=4, gossip_impl="dense"),
        strategy=knobs.get("strategy", "ambdg"),
        master_impl=knobs.get("master", "arena"))
    model = build_model(cfg, device="cpu")
    strategy = api.build(model, rc, device="cpu")
    got = list(_port_spec_leaves(state_specs(
        model, rc, strategy.init_state, torch.Generator().manual_seed(0))))
    jrc = _jax_rc(rc)
    jmodel = jbuild(JC.get_smoke_config(arch))
    jstrategy = japi.build(jmodel, jrc)
    shapes = jax.eval_shape(jstrategy.init_state, jax.random.PRNGKey(0))
    want = [tuple(p) for p in jax.tree.leaves(
        jspecs(jmodel, jrc, shapes), is_leaf=lambda x: isinstance(x, P))]
    assert got == want


def test_local_shard_cuts_row_major_blocks():
    mesh = parse_mesh("2x4x2")
    x = torch.arange(2 * 16 * 3).reshape(2, 16, 3)
    spec = sharding.Spec("pod", ("data", "model"))
    seen = set()
    for p in range(2):
        for d in range(4):
            for m in range(2):
                blk = sharding.local_shard(x, spec, mesh,
                                           {"pod": p, "data": d, "model": m})
                assert blk.shape == (1, 2, 3)
                i = d * 2 + m                   # the first axis slowest
                assert torch.equal(blk, x[p:p + 1, 2 * i:2 * i + 2])
                seen.add((p, i))
    assert len(seen) == 16
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_shard(torch.zeros(3, 5), sharding.Spec("data"), mesh,
                             {"data": 0})
    assert sharding.dim_shard(("data", "model"), mesh) == 8
    assert sharding.dim_shard(None, mesh) == 1


def test_profile_constrain_and_one_device_mesh():
    from repro_torch.dist import context
    from repro_torch.launch.mesh import make_mesh
    x = torch.zeros(8, 4)
    assert context.active_mesh() is None
    assert context.constrain(x, ("batch", None)) is x
    mesh = parse_mesh("2x4x1")
    with context.sharding_profile(mesh):
        assert context.active_mesh() == mesh
        assert context.constrain(x, ("batch", None)) is x
        with pytest.raises(ValueError, match="do not match"):
            context.constrain(x, ("batch",))
        with context.sharding_profile(None):
            assert context.active_mesh() is None
        assert context.active_mesh() == mesh
    assert context.active_mesh() is None
    one = make_mesh(parse_mesh("1x1x1"), device="cpu")
    assert one.device_mesh is None and one.coords == {
        "pod": 0, "data": 0, "model": 0}
    with one:      # one device: no profile, no DeviceMesh
        assert context.active_mesh() is None
        assert context.active_device_mesh() is None
    assert np.prod(one.shape) == 1
