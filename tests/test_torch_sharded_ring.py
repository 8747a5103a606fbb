"""The three sharded kernel wrappers of the port across gloo CPU ranks:
``dual_update_arena_sharded`` (B.1), ``ring_slot_rotate_int8_sharded``
(B.2, v2 int8) and ``ring_variable_pop_sharded`` (B.3, v3 f32 and int8,
with the fused meta), each held against the port's off-mesh route and
against JAX's unsharded op (``impl="ref"``, eager) at the same stacked
n_pods, on inputs drawn from a seed with numpy.

The ranks are spawned once per world size (2 and 4); each runs every
mesh of its size and saves its shards, and the cases are parametrised
over the gathered results. Each rank's output is compared with its own
block (``dist.sharding.local_shard``) of the reference.

Limits: B.1 bitwise (elementwise); B.2 bitwise at every pod count (the
compressed pods fold in pod order on every rank); B.3 bitwise at 2 pods
(the pod sum commutes) and, at 4 pods, within 3 roundings of the
largest summed row value: |got - want| <= 3 * 2^-24 * max sum_p
|partial_p| (the gap measured is printed).
"""
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MeshConfig
from repro_torch.dist.sharding import (arena_ring_specs, arena_slot_specs,
                                       local_shard)

ROWS, SLOTS = 512, 5
# (label, world, mesh (P, D, 1), stacked n_pods)
MESHES = [("2x1x1-2pods", 2, (2, 1, 1), 2),
          ("2x1x1-4pods", 2, (2, 1, 1), 4),
          ("1x2x1-1pod", 2, (1, 2, 1), 1),
          ("4x1x1-4pods", 4, (4, 1, 1), 4),
          ("2x2x1-2pods", 4, (2, 2, 1), 2)]
KINDS = ["dual_update", "slot_rotate", "variable_pop_f32",
         "variable_pop_int8"]
AXES = ("pod", "data", "model")
MESHES_SEED = {m[0]: 11 + i for i, m in enumerate(MESHES)}


def _inputs(label, n_pods):
    """Every wrapper's stacked inputs, from a seed, as numpy."""
    rng = np.random.default_rng(MESHES_SEED[label])
    f32 = np.float32
    out = {
        "z": rng.standard_normal((ROWS, 128)).astype(f32),
        "g": (rng.standard_normal((ROWS, 128)) * 300).astype(f32),
        "count": f32(1500.0), "alpha": f32(0.0123),
        "slot_pop": rng.integers(-127, 128, (n_pods, ROWS, 128),
                                 dtype=np.int8),
        "slot_push": rng.integers(-127, 128, (n_pods, ROWS, 128),
                                  dtype=np.int8),
        "scales_pop": rng.uniform(1e-3, 2e-2, (n_pods, ROWS)).astype(f32),
        "scales_push": rng.uniform(1e-3, 2e-2, (n_pods, ROWS)).astype(f32),
        "fed": rng.standard_normal((n_pods, ROWS, 128)).astype(f32),
        "ring_f32": rng.standard_normal((SLOTS, n_pods, ROWS, 128)
                                        ).astype(f32),
        "ring_int8": rng.integers(-127, 128, (SLOTS, n_pods, ROWS, 128),
                                  dtype=np.int8),
        "ring_scales": rng.uniform(1e-3, 2e-2, (SLOTS, n_pods, ROWS)
                                   ).astype(f32),
        "mask": np.array([True, False, True, True, False]),
        "counts_stale": np.stack([rng.integers(0, 50, SLOTS),
                                  rng.integers(0, 4, SLOTS)]).astype(f32),
    }
    fed = out["fed"]
    amax = np.abs(fed).max(-1)
    out["scale_new"] = (np.maximum(amax, f32(1e-12)) / f32(127)).astype(f32)
    return out


def _mesh_cfg(shape):
    return MeshConfig(n_pods=shape[0], data=shape[1], model=shape[2])


def _run_rank(rank, world, init_file, out_dir):
    """One rank: every mesh of this world size, every wrapper; saves
    its outputs (and its coordinates) to ``out_dir``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.context import use_device_mesh
    from repro_torch.kernels.delay_ring.ops import (
        ring_slot_rotate_int8_sharded, ring_variable_pop_sharded)
    from repro_torch.kernels.dual_update.ops import \
        dual_update_arena_sharded
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    results = {}
    try:
        for label, w, shape, n_pods in MESHES:
            if w != world:
                continue
            cfg = _mesh_cfg(shape)
            dm = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
            coords = {a: dm.get_local_rank(a) for a in AXES}
            x = _inputs(label, n_pods)
            slot_spec, scales_spec, row_spec = arena_slot_specs(cfg, ROWS)
            ring_spec, rscales_spec, _ = arena_ring_specs(cfg, ROWS)

            def cut(name, spec):
                return local_shard(torch.from_numpy(x[name]), spec, cfg,
                                   coords).clone()
            out = {"coords": coords}
            with use_device_mesh(dm):
                z = cut("z", row_spec)
                z_new, w_new = dual_update_arena_sharded(
                    z, cut("g", row_spec), torch.tensor(x["count"]),
                    torch.tensor(x["alpha"]))
                out["dual_update"] = (z_new.numpy(), w_new.numpy())
                g, slot, sc, res = ring_slot_rotate_int8_sharded(
                    cut("slot_pop", slot_spec),
                    cut("scales_pop", scales_spec),
                    cut("slot_push", slot_spec),
                    cut("scales_push", scales_spec), cut("fed", slot_spec),
                    cut("scale_new", scales_spec))
                out["slot_rotate"] = (g.numpy(), slot.numpy(), sc.numpy(),
                                      res.numpy())
                mask = torch.from_numpy(x["mask"])
                cs = torch.from_numpy(x["counts_stale"])
                g, meta = ring_variable_pop_sharded(
                    cut("ring_f32", ring_spec), mask, counts_stale=cs)
                out["variable_pop_f32"] = (g.numpy(), meta.numpy())
                g, meta = ring_variable_pop_sharded(
                    cut("ring_int8", ring_spec), mask,
                    scales=cut("ring_scales", rscales_spec),
                    counts_stale=cs)
                out["variable_pop_int8"] = (g.numpy(), meta.numpy())
            results[label] = out
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp):
    import torch.multiprocessing as mp
    mp.spawn(_run_rank, args=(world, str(tmp / "init"), str(tmp)),
             nprocs=world)
    runs = {}
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            for label, out in pickle.load(f).items():
                runs.setdefault(label, []).append(out)
    return runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's per-rank outputs: the ranks spawn once a world."""
    runs = {}
    for world in (2, 4):
        runs.update(_spawn(world, tmp_path_factory.mktemp(f"world{world}")))
    return runs


def _pod_fold(x):
    acc = x[0]
    for p in range(1, x.shape[0]):
        acc = acc + x[p]
    return acc


def _port_reference(kind, x):
    """The port's off-mesh route on the stacked inputs (numpy out)."""
    from repro_torch.kernels.delay_ring.ops import (ring_slot_rotate_int8,
                                                    ring_variable_pop)
    from repro_torch.kernels.dual_update.ops import dual_update_arena
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    if kind == "dual_update":
        z, w = dual_update_arena(t["z"].clone(), t["g"], t["count"],
                                 t["alpha"])
        return (z.numpy(), w.numpy()), None
    if kind == "slot_rotate":
        slot, sc, fed = (t["slot_push"].clone(), t["scales_push"].clone(),
                         t["fed"].clone())
        popped, slot, sc, res = ring_slot_rotate_int8(
            t["slot_pop"], t["scales_pop"], slot, sc, fed, t["scale_new"])
        return (_pod_fold(popped).numpy(), slot.numpy(), sc.numpy(),
                res.numpy()), None
    int8 = kind.endswith("int8")
    part, meta = ring_variable_pop(
        t["ring_int8"] if int8 else t["ring_f32"], t["mask"],
        scales=t["ring_scales"] if int8 else None,
        counts_stale=t["counts_stale"])
    return (_pod_fold(part).numpy(), meta.numpy()), part.numpy()


def _jax_reference(kind, x):
    """JAX's unsharded op (``impl="ref"``, eager) on the same inputs."""
    import jax.numpy as jnp

    from repro.core.delayed import pod_sum
    from repro.kernels.delay_ring.ops import (ring_slot_rotate_int8,
                                              ring_variable_pop)
    from repro.kernels.dual_update.ops import dual_update_arena
    j = {k: jnp.asarray(v) for k, v in x.items()}
    if kind == "dual_update":
        z, w = dual_update_arena(j["z"], j["g"], j["count"], j["alpha"],
                                 impl="ref")
        return tuple(np.asarray(a) for a in (z, w))
    if kind == "slot_rotate":
        popped, slot, sc, res = ring_slot_rotate_int8(
            j["slot_pop"], j["scales_pop"], j["slot_push"],
            j["scales_push"], j["fed"], j["scale_new"], impl="ref")
        return tuple(np.asarray(a) for a in (pod_sum(popped), slot, sc, res))
    int8 = kind.endswith("int8")
    part, meta = ring_variable_pop(
        j["ring_int8"] if int8 else j["ring_f32"], j["mask"],
        scales=j["ring_scales"] if int8 else None,
        counts_stale=j["counts_stale"], impl="ref")
    return np.asarray(pod_sum(part)), np.asarray(meta)


def _out_specs(kind, cfg):
    slot_spec, scales_spec, row_spec = arena_slot_specs(cfg, ROWS)
    if kind == "dual_update":
        return (row_spec, row_spec)
    if kind == "slot_rotate":
        return (row_spec, slot_spec, scales_spec, slot_spec)
    return (row_spec, ())


@pytest.mark.parametrize("reference", ["port_off_mesh", "jax_unsharded"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES, ids=[m[0] for m in MESHES])
def test_sharded_wrapper_matches_unsharded(ranks, mesh, kind, reference):
    label, world, shape, n_pods = mesh
    cfg = _mesh_cfg(shape)
    x = _inputs(label, n_pods)
    if reference == "port_off_mesh":
        want, partial = _port_reference(kind, x)
    else:
        want = _jax_reference(kind, x)
        partial = _port_reference(kind, x)[1]
    specs = _out_specs(kind, cfg)
    assert len(ranks[label]) == world
    for out in ranks[label]:
        for i, (got, full, spec) in enumerate(zip(out[kind], want, specs)):
            block = local_shard(torch.from_numpy(np.array(full)), spec,
                                cfg, out["coords"]).numpy()
            assert got.shape == block.shape, (i, got.shape, block.shape)
            if kind.startswith("variable_pop") and i == 0 and n_pods > 2:
                # 4 pods: the pod sum's order depends on the ranks
                top = local_shard(torch.from_numpy(
                    np.abs(partial).sum(0)), spec, cfg,
                    out["coords"]).numpy().max()
                gap = float(np.abs(got - block).max())
                limit = 3 * 2.0 ** -24 * float(top)
                print(f"{label} {kind} vs {reference}: max gap {gap:.3e} "
                      f"<= {limit:.3e}")
                assert gap <= limit, (gap, limit)
            else:
                np.testing.assert_array_equal(got, block)


def test_sharded_wrappers_raise_without_a_mesh():
    """No ambient DeviceMesh, or one without a process group: the
    sharded wrappers raise; they never take the off-mesh route."""
    from repro_torch.kernels.delay_ring.ops import (
        ring_slot_rotate_int8_sharded, ring_variable_pop_sharded)
    from repro_torch.kernels.dual_update.ops import \
        dual_update_arena_sharded
    z = torch.zeros((256, 128))
    one = torch.ones(())
    with pytest.raises(RuntimeError, match="DeviceMesh"):
        dual_update_arena_sharded(z, z.clone(), one, one)
    ring = torch.zeros((2, 1, 256, 128))
    with pytest.raises(RuntimeError, match="DeviceMesh"):
        ring_variable_pop_sharded(ring, torch.tensor([True, False]))
    q = torch.zeros((1, 256, 128), dtype=torch.int8)
    s = torch.ones((1, 256))
    with pytest.raises(RuntimeError, match="DeviceMesh"):
        ring_slot_rotate_int8_sharded(q, s, q.clone(), s.clone(),
                                      torch.zeros((1, 256, 128)), s)
