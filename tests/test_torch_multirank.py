"""The port's multi-process path: AMB-DG training of amb-linreg SMOKE
on ``P x D x 1`` meshes of gloo CPU ranks (``train(..., mesh=...)``,
the sharded master), held against the single-process stacked run at the
same ``n_pods``, and the train CLI under ``torch.distributed.run``.

The ranks are spawned once per world size (2 and 4); each runs every
case of its size and ends it with a checkpoint (``train.loop``'s
``checkpoint.save_sharded``: the ranks' shards joined on rank 0's host
into the whole state), which rank 0 reads back and saves with the
per-step metrics. The cases are parametrised over those results.

Which limit holds: the fixed-delay cases agree with the stacked run bit
for bit (metrics and every state leaf: params, z, the ring, its scales
and residual, counts), 2x2x1 included, where each data rank runs one of
the pod's two microbatches (0 + g0 + g1 and g0 + g1 round alike). Two
kinds of case change a sum's order and are held to PERF.md section 2's
card-vs-CPU limits instead (loss and grad_norm rtol 1e-4; w within 1e-4
of its largest element, plus one int8 step under int8): four
microbatches a pod over two data ranks (``nmb4``), and the stochastic
delay, whose stacked CPU pop folds the due slots slot-major (each slot's
pods, then the slots: JAX's off-mesh ``_variable_pop_ref``) where the
sharded pop, like the card's kernel, folds each pod's slots first; on
a step where two slots arrive the two orders round apart.

Every case also counts the bytes its collectives send (the census of
``dist.collectives``): the "pod_pop" tag equals the ported wire model,
``master_pod_exchange_bytes`` (fixed delay) or
``variable_pod_exchange_bytes`` (the stochastic delay's v3 ring) of the
rank's rows, times the steps, exactly.

The LMs on the mesh (world 2): qwen1.5-0.5b SMOKE and zamba2 SMOKE, f32,
2 steps of 8 sequences of 16 tokens with tau 1, on 2x1x1 (int8) and
1x2x1, through ``api.build`` and ``train``, held against the stacked run
at LM_GAP_MULT times the gap between two stacked runs, leaf by leaf and
on each step's loss. An LM gradient need not repeat bit for bit on the
CPU (ROADMAP C.9), and 1x2x1 sums a pod's microbatches in the
reduce-scatter; measured here at one intra-op thread (the ranks' count,
at which the stacked runs are made too): both gaps 0, so the multiple is
1 and the check bit for bit.
"""
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (AmbdgConfig, DelayConfig, MeshConfig,
                                      RunConfig, TRAIN_4K)

ROOT = Path(__file__).resolve().parents[1]
STEPS, WORKERS, SPW = 4, 4, 4
# (label, world, mesh (P, D, 1), run-config knobs)
CASES = [
    ("2x1x1-f32", 2, (2, 1, 1), {}),
    ("2x1x1-int8", 2, (2, 1, 1), {"compression": "int8"}),
    ("2x1x1-heavy-tail-int8", 2, (2, 1, 1),
     {"compression": "int8", "delay": "heavy_tail"}),
    ("2x1x1-heavy-tail-f32", 2, (2, 1, 1), {"delay": "heavy_tail"}),
    ("2x1x1-amb", 2, (2, 1, 1), {"strategy": "amb"}),
    ("2x1x1-kbatch", 2, (2, 1, 1), {"strategy": "kbatch"}),
    ("2x1x1-while-dynamic", 2, (2, 1, 1), {"anytime": "while_dynamic"}),
    ("2x2x1-f32", 4, (2, 2, 1), {}),
    ("2x2x1-int8", 4, (2, 2, 1), {"compression": "int8"}),
    ("2x2x1-heavy-tail-int8", 4, (2, 2, 1),
     {"compression": "int8", "delay": "heavy_tail"}),
    ("2x2x1-nmb4-int8", 4, (2, 2, 1), {"compression": "int8", "n_mb": 4}),
    ("4x1x1-int8", 4, (4, 1, 1), {"compression": "int8"}),
]
BITWISE = {label for label, *_ in CASES
           if "nmb4" not in label and "heavy-tail" not in label}
# (label, mesh, arch, pod compression): the LMs on the world-2 mesh
LM_CASES = [("qwen-2x1x1-int8", (2, 1, 1), "qwen1.5-0.5b", "int8"),
            ("qwen-1x2x1", (1, 2, 1), "qwen1.5-0.5b", "none"),
            ("zamba2-2x1x1-int8", (2, 1, 1), "zamba2-2.7b", "int8"),
            ("zamba2-1x2x1", (1, 2, 1), "zamba2-2.7b", "none")]
LM_STEPS, LM_SPW, LM_SEQ = 2, 2, 16
# the mesh run's allowed gap over two stacked runs' (both measured 0)
LM_GAP_MULT = 1
# world -> (label, mesh) of the int8 run restarted from step 2
RESTARTS = {2: ("restart-2x1x1", (2, 1, 1)), 4: ("restart-2x2x1", (2, 2, 1))}


def _rc(shape, knobs) -> RunConfig:
    cfg = get_smoke_config("amb-linreg")
    total = WORKERS * SPW
    delay = (DelayConfig(process="heavy_tail", tau_max=4, seed=7)
             if knobs.get("delay") else DelayConfig())
    return RunConfig(
        model=cfg,
        shape=dataclasses.replace(TRAIN_4K, seq_len=0, global_batch=total),
        mesh=MeshConfig(n_pods=shape[0], data=shape[1], model=shape[2]),
        ambdg=AmbdgConfig(tau=2, n_microbatches=knobs.get("n_mb", 2),
                          b_bar=float(total), smoothness_L=1.0,
                          proximal="l2_ball",
                          radius_C=1.05 * math.sqrt(cfg.linreg_dim),
                          pod_compression=knobs.get("compression", "none"),
                          anytime_impl=knobs.get("anytime", "scan_masked")),
        delay=delay, strategy=knobs.get("strategy", "ambdg"))


def _loop(ckpt_dir=None, n_steps=STEPS, ckpt_every=50, spw=SPW):
    from repro_torch.train.loop import LoopConfig
    return LoopConfig(n_steps=n_steps, n_workers=WORKERS,
                      samples_per_worker=spw, log_every=1,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)


def _lm_rc(arch, shape, compression) -> RunConfig:
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    return RunConfig(
        model=cfg,
        shape=dataclasses.replace(TRAIN_4K, seq_len=LM_SEQ,
                                  global_batch=WORKERS * LM_SPW),
        mesh=MeshConfig(n_pods=shape[0], data=shape[1], model=shape[2]),
        ambdg=AmbdgConfig(tau=1, n_microbatches=2,
                          b_bar=float(WORKERS * LM_SPW), smoothness_L=8.0,
                          pod_compression=compression))


def _leaves(state):
    from repro_torch.train.checkpoint import _flatten_with_paths
    return {k: v.cpu().numpy() for k, v in _flatten_with_paths(state)}


def _ckpt_leaves(ckpt_dir):
    """The state leaves of the latest checkpoint in ``ckpt_dir``."""
    path = max(Path(ckpt_dir).glob("step_*"))
    with np.load(path / "state.npz") as f:
        return {k: f[k] for k in f.files}


def _run_rank(rank, world, init_file, out_dir):
    """One rank: every case of this world size, a checkpoint restart,
    and (world 2) the refusals that need a process group."""
    import torch.distributed as dist

    from repro_torch.dist.collectives import wire_census
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    results = {}
    try:
        for label, w, shape, knobs in CASES:
            if w != world:
                continue
            rc = _rc(shape, knobs)
            model = build_model(rc.model, device="cpu")
            mesh = make_mesh(rc.mesh, "cpu")
            ck = f"{out_dir}/{label}"
            with wire_census() as census:
                out = train(model, rc, _loop(ck, ckpt_every=STEPS),
                            device="cpu", mesh=mesh)
            results[label] = {"history": out["history"],
                              "census": dict(census.bytes),
                              "state": _ckpt_leaves(ck) if rank == 0
                              else None}
        for label, shape, arch, compression in LM_CASES:
            if world != 2:
                continue
            rc = _lm_rc(arch, shape, compression)
            mesh = make_mesh(rc.mesh, "cpu")
            ck = f"{out_dir}/{label}"
            out = train(build_model(rc.model, device="cpu"), rc,
                        _loop(ck, n_steps=LM_STEPS, ckpt_every=LM_STEPS,
                              spw=LM_SPW), device="cpu", mesh=mesh)
            results[label] = {"history": out["history"],
                              "state": _ckpt_leaves(ck) if rank == 0
                              else None}
        # a restart from a checkpoint written at step 2 of 4
        label, shape = RESTARTS[world]
        rc = _rc(shape, {"compression": "int8"})
        model = build_model(rc.model, device="cpu")
        mesh = make_mesh(rc.mesh, "cpu")
        ck = f"{out_dir}/{label}"
        train(model, rc, _loop(ck, n_steps=2, ckpt_every=2), device="cpu",
              mesh=mesh)
        out = train(model, rc, _loop(ck, ckpt_every=STEPS), device="cpu",
                    mesh=mesh)
        results[label] = {"history": out["history"],
                          "state": _ckpt_leaves(ck) if rank == 0 else None}
        if world == 2:
            results["errors"] = _refusals(world)
        if rank == 0:
            with open(f"{out_dir}/results.pkl", "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _refusals(world):
    """The messages of what a multi-rank mesh refuses."""
    from repro_torch import api
    from repro_torch.core import arena as arena_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    errors = {}

    def catch(name, fn):
        try:
            fn()
            errors[name] = None
        except Exception as e:  # noqa: BLE001 - the message is the result
            errors[name] = f"{type(e).__name__}: {e}"

    catch("world", lambda: make_mesh(MeshConfig(2 * world, 1, 1), "cpu"))
    rc = _rc((2, 1, 1), {})
    model = build_model(rc.model, device="cpu")
    mesh = make_mesh(rc.mesh, "cpu")
    with mesh:
        catch("sgd", lambda: api.build(model, rc.replace(optimizer="sgd"),
                                       device="cpu"))
        catch("pytree", lambda: api.build(
            model, rc.replace(master_impl="pytree"), device="cpu"))
        layout = arena_mod.make_layout(model.param_shapes())
        v1 = arena_mod.init_arena(layout, 2, 1, device="cpu",
                                  ring_version=1)
        catch("v1", lambda: arena_mod.push_pop(
            layout, v1, torch.zeros((1, layout.rows, 128)), torch.ones(1)))
    return errors


def _spawn(world, tmp):
    import torch.multiprocessing as mp
    mp.spawn(_run_rank, args=(world, str(tmp / "init"), str(tmp)),
             nprocs=world)
    with open(tmp / "results.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    runs = {}
    for world in (2, 4):
        runs.update(_spawn(world, tmp_path_factory.mktemp(f"world{world}")))
    return runs


def _stacked(label_or_knobs, shape=None, **loop_kw):
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train
    knobs = label_or_knobs
    rc = _rc(shape, knobs)
    model = build_model(rc.model, device="cpu")
    out = train(model, rc, _loop(**loop_kw), device="cpu")
    return out["history"], _leaves(out["state"])


def _compare(got, want, bitwise, compression):
    (hg, sg), (hw, sw) = got, want
    assert len(hg) == len(hw) == STEPS
    for a, b in zip(hg, hw):
        for key in ("applied_count", "local_count", "step"):
            assert a[key] == b[key], (key, a, b)
        for key in ("loss", "grad_norm"):
            if bitwise:
                assert a[key] == b[key], (key, a[key], b[key])
            else:
                assert math.isclose(a[key], b[key], rel_tol=1e-4), (key,)
    assert sorted(sg) == sorted(sw)
    for key in sw:
        # the bookkeeping (counts, head, tags, step) is exact either way
        exact = any(k in key for k in ("counts", "head", "due", "stale",
                                       "step"))
        if bitwise or exact:
            np.testing.assert_array_equal(sg[key], sw[key], err_msg=key)
    if not bitwise:
        w_got, w_want = sg[".params/w"], sw[".params/w"]
        tol = 1e-4 * float(np.abs(w_want).max())
        if compression == "int8":
            scales = [v for k, v in sw.items() if "scales" in k]
            counts = [h["applied_count"] for h in hw if h["applied_count"]]
            tol += max(float(s.max()) for s in scales) / min(counts)
        assert float(np.abs(w_got - w_want).max()) <= tol


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_multirank_run_matches_stacked(ranks, case):
    label, _, shape, knobs = case
    _compare((ranks[label]["history"], ranks[label]["state"]),
             _stacked(knobs, shape), label in BITWISE,
             knobs.get("compression", "none"))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_multirank_census_is_the_wire_model(ranks, case):
    """Rank 0's "pod_pop" bytes over the run: the ported wire model of
    the pod exchange at its rows, times the steps (a pop every step:
    the fixed ring's slot, the v3 ring's folded rows, or under tau = 0
    the fresh gradients' sum), on the pod axis."""
    from repro_torch.core.arena import make_layout
    from repro_torch.launch.wire_model import (master_pod_exchange_bytes,
                                               variable_pod_exchange_bytes)
    from repro_torch.models.api import build_model
    label, _, shape, knobs = case
    rows = make_layout(build_model(get_smoke_config("amb-linreg"),
                                   device="cpu").param_shapes()).rows
    rows //= shape[1]                     # the rank's rows
    if knobs.get("delay"):
        one = variable_pod_exchange_bytes(rows, shape[0])
    else:
        one = master_pod_exchange_bytes(rows, shape[0],
                                        knobs.get("compression", "none"))
    pod_pop = {}
    for (axis, dtype, tag), n in ranks[label]["census"].items():
        if tag == "pod_pop":
            assert axis == "pod", axis
            pod_pop[dtype] = n
    assert pod_pop == {dt: STEPS * b for dt, b in one.items()}


@pytest.mark.parametrize("case", LM_CASES, ids=[c[0] for c in LM_CASES])
def test_multirank_lm_matches_stacked(ranks, case):
    """An LM on the mesh against the stacked run: every leaf of the
    joined checkpoint and each step's loss and counts within
    LM_GAP_MULT times the gap between two stacked runs (see the module's
    docstring), the stacked runs made at the ranks' one thread."""
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train
    label, shape, arch, compression = case
    rc = _lm_rc(arch, shape, compression)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for _ in range(2):
            out = train(build_model(rc.model, device="cpu"), rc,
                        _loop(n_steps=LM_STEPS, spw=LM_SPW), device="cpu")
            runs.append((out["history"], _leaves(out["state"])))
    finally:
        torch.set_num_threads(threads)
    (h0, s0), (h1, s1) = runs
    got = ranks[label]
    assert len(got["history"]) == len(h0) == LM_STEPS
    for a, b, c in zip(got["history"], h0, h1):
        for key in ("applied_count", "local_count", "step"):
            assert a[key] == b[key], (key, a, b)
        gap = abs(b["loss"] - c["loss"])
        assert abs(a["loss"] - b["loss"]) <= LM_GAP_MULT * gap, (a, b, c)
    assert sorted(got["state"]) == sorted(s0)
    for key in s0:
        gap = np.abs(s1[key].astype(np.float64) - s0[key]).max()
        err = np.abs(got["state"][key].astype(np.float64) - s0[key]).max()
        assert err <= LM_GAP_MULT * gap, (key, err, gap)


def test_multirank_restart_resumes_exactly(ranks):
    """2 steps on 2x1x1, a checkpoint (the ranks' shards joined on rank
    0's host), a restart on the same directory to step 4 (each rank's
    pod cut from the file): its step-4 checkpoint is the stacked 4-step
    run's state."""
    _check_restart(ranks, 2)


def test_multirank_restart_cuts_rows_exactly(ranks):
    """The same on 2x2x1, where the restart cuts each rank's rows of z
    and of the arena from the file as well as its pod."""
    _check_restart(ranks, 4)


def _check_restart(ranks, world):
    label, shape = RESTARTS[world]
    got = ranks[label]
    want = _stacked({"compression": "int8"}, shape)
    assert sorted(got["state"]) == sorted(want[1])
    for key in want[1]:
        np.testing.assert_array_equal(got["state"][key], want[1][key],
                                      err_msg=key)
    assert [h["loss"] for h in got["history"]] == \
        [h["loss"] for h in want[0][2:]]


@pytest.mark.parametrize("what, exc, text", [
    ("world", "ValueError", "needs 4 ranks; the world has 2"),
    ("sgd", "NotImplementedError", "A.11 part 2"),
    ("pytree", "NotImplementedError", "A.11 part 2"),
    ("v1", "ValueError", "v1"),
])
def test_multirank_mesh_refuses(ranks, what, exc, text):
    msg = ranks["errors"][what]
    assert msg is not None and msg.startswith(exc) and text in msg, msg


def test_make_mesh_refuses_model_axis_and_a_missing_world():
    """A mesh over more than one rank needs a world, a model axis as
    any other (tensor parallelism over 'model' is ported; JAX's TPU pod
    mesh stays refused)."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(MeshConfig(1, 2, 2), "cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(MeshConfig(2, 1, 1), "cpu")
    with pytest.raises(NotImplementedError, match="256 chips"):
        make_production_mesh()


def test_active_mesh_without_a_process_group_raises():
    """A multi-rank profile with no DeviceMesh or process group behind
    it: the arena's rotation and the step refuse; neither drops back to
    the stacked route."""
    from repro_torch import api
    from repro_torch.core import arena as arena_mod
    from repro_torch.dist.context import sharding_profile
    from repro_torch.models.api import build_model
    rc = _rc((2, 1, 1), {})
    model = build_model(rc.model, device="cpu")
    layout = arena_mod.make_layout(model.param_shapes())
    ar = arena_mod.init_arena(layout, 2, 2, device="cpu")
    grads = {"w": torch.zeros((2, rc.model.linreg_dim))}
    with sharding_profile(rc.mesh):
        with pytest.raises(RuntimeError, match="DeviceMesh"):
            arena_mod.push_pop(layout, ar, grads, torch.ones(2))
        with pytest.raises(RuntimeError, match="DeviceMesh"):
            api.build(model, rc, device="cpu")
        # the gossip does not compose with a pod mesh (nor does JAX's)
        with pytest.raises(NotImplementedError,
                           match="does not compose with a pod mesh"):
            api.build(model, rc.replace(strategy="decentralized"),
                      device="cpu")


def test_train_cli_under_torch_distributed_run(tmp_path):
    """``python -m torch.distributed.run`` drives the train CLI on a
    2x1x1 mesh over gloo: rank 0 alone prints, its log lines carry the
    metrics of the stacked run (``run_config(parse_args(argv))``
    through ``train(..., mesh=None)``) bit for bit, and its step-50
    checkpoint (the default period) equals that run's, leaf for leaf."""
    from repro_torch.launch.train import parse_args, run_config
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    argv = ["--arch", "amb-linreg", "--smoke", "--device", "cpu",
            "--mesh", "2x1x1", "--steps", "50", "--n-workers", "4",
            "--samples-per-worker", "4", "--tau", "2", "--pod-compression",
            "int8"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node=2",
         "--rdzv-backend=c10d", "--rdzv-endpoint=localhost:0", "-m",
         "repro_torch.launch.train"] + argv
        + ["--ckpt-dir", str(tmp_path / "mesh")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("done:") for ln in lines) == 1, out.stdout
    logged = [json.loads(ln) for ln in lines if ln.startswith("{")]
    rc = run_config(parse_args(argv))
    want = train(build_model(rc.model, device="cpu"), rc,
                 LoopConfig(n_steps=50, ckpt_dir=str(tmp_path / "stacked"),
                            n_workers=4, samples_per_worker=4),
                 device="cpu")
    assert len(logged) == len(want["history"]) == 5
    for a, b in zip(logged, want["history"]):
        for key in ("step", "loss", "grad_norm", "applied_count"):
            assert a[key] == b[key], (key, a, b)
    a, b = _ckpt_leaves(tmp_path / "mesh"), _ckpt_leaves(tmp_path / "stacked")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
