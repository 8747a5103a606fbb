"""Tensor parallelism over the mesh's ``model`` axis for the dense
transformers (``dist.tensor_parallel``), with ``seq_parallel`` and the
arena's rows over ``data x model``, on gloo CPU ranks.

The ranks are spawned once per world size (2 and 4); each runs every
case of its size and saves what it got, and the cases are parametrised
over those results. The parent process computes the references once:
JAX's unsharded ``lm_loss`` and its gradient on JAX's init (converted,
the ranks cut their blocks from it) and the port's ``1x1x1`` runs.

World 2, ``1x1x2``, f32 SMOKE, qwen1.5-0.5b (MHA, tied head), qwen3-1.7b
(GQA 4/2, tied, qk_norm) and yi-6b (untied head):
  * loss and each gradient leaf equal JAX's within rtol 1e-5 (of the
    leaf's largest element); a model-cut leaf's gradient is its block of
    JAX's and of the port's unsharded gradient; each whole leaf's
    gradient is the same on both ranks, bit for bit;
  * ``seq_parallel`` on against off: rtol 1e-5;
  * three AMB-DG steps (tau 1, pod compression none and int8) against
    the port's 1x1x1 run: loss rtol 1e-5, params within 1e-5 of the
    leaf's largest element plus one int8 step of the leaf (its largest
    row scale over the applied count), counts exact; the int8 ring's
    scales have the whole tree's rows (shape and the row -> leaf
    segments of the 1x1x1 run, values within 5 %);
  * the ``model`` census of each run equals ``wire_model.
    model_axis_bytes`` times the steps;
  * a 1x1x2 checkpoint restores on 1x1x1, and a 1x1x1 one on 1x1x2;
  * the refusals: ``n_heads % model``, ``S % model`` under
    ``seq_parallel``, a layout the axis does not carry (Mamba2's
    grouped B/C columns, zamba2 with n_groups = 2); decoding and
    serving, once refused, now run there.
World 4: chatglm3-6b on ``1x1x4`` (2 kv heads: the whole-kv route),
qwen1.5-0.5b on ``1x2x2`` (the rows over data x model), each against
JAX and the 1x1x1 run as above, and the three sharded wrappers on
``1x2x2``, bit for bit the off-mesh route.
"""
import dataclasses
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (AmbdgConfig, MeshConfig, RunConfig,
                                      TRAIN_4K)

W2_ARCHS = ("qwen1.5-0.5b", "qwen3-1.7b", "yi-6b")
# (label, arch, mesh) of the world-4 model cases
W4_CASES = [("chatglm-1x1x4", "chatglm3-6b", (1, 1, 4)),
            ("qwen-1x2x2", "qwen1.5-0.5b", (1, 2, 2))]
GRAD_CASES = ([(f"{a}-1x1x2", a, (1, 1, 2)) for a in W2_ARCHS]
              + W4_CASES)
TRAIN_CASES = ([(f"{a}-1x1x2-{c}", a, (1, 1, 2), c, False)
                for a in W2_ARCHS for c in ("none", "int8")]
               + [("qwen1.5-0.5b-1x1x2-int8-sp", "qwen1.5-0.5b", (1, 1, 2),
                   "int8", True)]
               + [(f"{label}-int8", a, shape, "int8", False)
                  for label, a, shape in W4_CASES])
GRAD_B, SEQ = 4, 16
STEPS, WORKERS, SPW, N_MB = 3, 4, 2, 2
RTOL = 1e-5
RESTART_ARCH = "qwen1.5-0.5b"
ROWS = 512


def _cfg(arch, sp=False):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", seq_parallel=sp)


def _rc(arch, shape, compression, sp=False) -> RunConfig:
    return RunConfig(
        model=_cfg(arch, sp),
        shape=dataclasses.replace(TRAIN_4K, seq_len=SEQ,
                                  global_batch=WORKERS * SPW),
        mesh=MeshConfig(*shape),
        ambdg=AmbdgConfig(tau=1, n_microbatches=N_MB,
                          b_bar=float(WORKERS * SPW), smoothness_L=8.0,
                          pod_compression=compression))


def _loop(ckpt_dir=None, n_steps=STEPS):
    from repro_torch.train.loop import LoopConfig
    return LoopConfig(n_steps=n_steps, n_workers=WORKERS,
                      samples_per_worker=SPW, log_every=1,
                      ckpt_dir=ckpt_dir, ckpt_every=n_steps)


def _batch(cfg):
    from repro_torch.data.synthetic import TokenStream
    b = TokenStream(cfg, seed=3).next_batch(GRAD_B, SEQ)
    b["weights"] = np.array([1.0, 0.5, 0.25, 1.0], np.float32)
    return b


def _ckpt_leaves(ckpt_dir):
    path = max(Path(ckpt_dir).glob("step_*"))
    with np.load(path / "state.npz") as f:
        return {k: f[k] for k in f.files}


def _model_dims(arch, shape):
    from repro_torch.core.arena import make_layout
    from repro_torch.dist.tensor_parallel import model_dims
    from repro_torch.models.api import build_model
    model = build_model(_cfg(arch), device="cpu")
    layout = make_layout(model.param_shapes())
    return layout, model_dims(model.cfg, layout, model.param_axes(),
                              MeshConfig(*shape))


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
def _grad_case(arch, shape, sp, whole_np, batch_np):
    """This rank's loss and gradient on its blocks of ``whole_np``."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.dist.collectives import wire_census
    from repro_torch.dist.tensor_parallel import cut_params, model_axis
    from repro_torch.models.api import build_model
    model = build_model(_cfg(arch, sp), device="cpu")
    _, dims = _model_dims(arch, shape)
    leaves, treedef = tree_flatten(whole_np)
    whole = tree_unflatten(treedef, [torch.from_numpy(x) for x in leaves])
    leaves, treedef = tree_flatten(cut_params(whole, dims, model_axis()))
    leaves = [x.requires_grad_(True) for x in leaves]
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with wire_census() as census:
        loss, _ = model.loss(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return {"loss": float(loss), "grads": [g.numpy() for g in grads],
            "census": dict(census.bytes)}


def _train_case(rank, arch, shape, compression, sp, ckpt_dir):
    from repro_torch.dist.collectives import wire_census
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train
    rc = _rc(arch, shape, compression, sp)
    mesh = make_mesh(rc.mesh, "cpu")
    with wire_census() as census:
        out = train(build_model(rc.model, device="cpu"), rc,
                    _loop(ckpt_dir), device="cpu", mesh=mesh)
    return {"history": out["history"], "census": dict(census.bytes),
            "state": _ckpt_leaves(ckpt_dir) if rank == 0 else None}


# the train CLI on the mesh (its own default compute dtype, bf16)
CLI_ARGV = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
            "--steps", "2", "--seq-len", "16", "--n-workers", "2",
            "--samples-per-worker", "2", "--pod-compression", "int8"]
# bf16 compute: the limits of test_torch_transformer's bf16 cases
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 2e-3, 5e-2


def _bf16_loss(sp, inputs):
    """qwen1.5-0.5b SMOKE in bf16 on this rank's blocks of JAX's init:
    the loss and the gradient of its whole leaves (the bf16 sequence
    gathers under ``seq_parallel`` cross as raw bytes)."""
    arch = "qwen1.5-0.5b"
    cfg = dataclasses.replace(_cfg(arch, sp), compute_dtype="bfloat16")
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.dist.collectives import wire_census
    from repro_torch.dist.tensor_parallel import cut_params, model_axis
    from repro_torch.models.api import build_model
    model = build_model(cfg, device="cpu")
    _, dims = _model_dims(arch, (1, 1, 2))
    leaves, treedef = tree_flatten(inputs["params"][arch])
    whole = tree_unflatten(treedef, [torch.from_numpy(x) for x in leaves])
    leaves, treedef = tree_flatten(cut_params(whole, dims, model_axis()))
    leaves = [x.requires_grad_(True) for x in leaves]
    batch = {k: torch.from_numpy(v)
             for k, v in inputs["batch"][arch].items()}
    with wire_census() as census:
        loss, _ = model.loss(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return {"loss": float(loss.detach()),
            "grads": [g.numpy() for g, d in zip(grads, dims) if d is None],
            "census": dict(census.bytes)}


def _refusals():
    """The messages of what the ``model`` axis refuses, under 1x1x2."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    errors = {}

    def catch(name, fn):
        try:
            fn()
            errors[name] = None
        except Exception as e:  # noqa: BLE001 - the message is the result
            errors[name] = f"{type(e).__name__}: {e}"

    rc = _rc("qwen1.5-0.5b", (1, 1, 2), "none")
    mesh = make_mesh(rc.mesh, "cpu")
    odd = dataclasses.replace(_cfg("qwen1.5-0.5b"), n_heads=3, n_kv_heads=3,
                              head_dim=16)
    model = build_model(_cfg("qwen1.5-0.5b", sp=True), device="cpu")
    zamba = get_smoke_config("zamba2-2.7b")
    grouped = build_model(dataclasses.replace(
        zamba, ssm=dataclasses.replace(zamba.ssm, n_groups=2)), device="cpu")
    with mesh:
        catch("heads", lambda: build_model(odd, device="cpu").init())
        params = model.init()
        catch("seq", lambda: model.loss(params, model.dummy_batch(
            2, 15, torch.Generator().manual_seed(0))))
        catch("family", lambda: grouped.init())
        catch("decode", lambda: _decode_once(model, params))
        catch("serve", lambda: _serve_twice(model, rc))
    return errors


def _decode_once(model, params):
    """One decode step on the rank's blocks (decoding at ``model > 1``,
    once refused here): its logits must be the rank's vocab block."""
    cache, _ = model.init_decode_state(2, 8)
    logits, _ = model.decode_step(params, cache,
                                  torch.zeros((2, 1), dtype=torch.int64),
                                  torch.zeros((2,), dtype=torch.int64))
    assert logits.shape == (2, 1, model.cfg.padded_vocab_size // 2)


def _serve_twice(model, rc):
    """``api.serve`` on the mesh (once refused here), two engine
    steps."""
    from repro_torch import api
    engine, queue = api.serve(model, rc, device="cpu")
    engine.serve(queue, 2)


def _wrappers(mesh_shape):
    """The three sharded wrappers on this rank's rows of ROWS (one pod):
    the outputs and the rank's coordinates."""
    from repro_torch.dist.sharding import (arena_ring_specs,
                                           arena_slot_specs, local_shard)
    from repro_torch.kernels.delay_ring.ops import (
        ring_slot_rotate_int8_sharded, ring_variable_pop_sharded)
    from repro_torch.kernels.dual_update.ops import \
        dual_update_arena_sharded
    from repro_torch.launch.mesh import make_mesh
    cfg = MeshConfig(*mesh_shape)
    mesh = make_mesh(cfg, "cpu")
    x = _wrapper_inputs()
    slot_spec, scales_spec, row_spec = arena_slot_specs(cfg, ROWS)
    ring_spec, rscales_spec, _ = arena_ring_specs(cfg, ROWS)

    def cut(name, spec):
        return local_shard(torch.from_numpy(x[name]), spec, cfg,
                           mesh.coords).clone()
    out = {"coords": mesh.coords}
    with mesh:
        z, w = dual_update_arena_sharded(
            cut("z", row_spec), cut("g", row_spec),
            torch.tensor(x["count"]), torch.tensor(x["alpha"]))
        out["dual_update"] = (z.numpy(), w.numpy())
        g, slot, sc, res = ring_slot_rotate_int8_sharded(
            cut("slot_pop", slot_spec), cut("scales_pop", scales_spec),
            cut("slot_push", slot_spec), cut("scales_push", scales_spec),
            cut("fed", slot_spec), cut("scale_new", scales_spec))
        out["slot_rotate"] = (g.numpy(), slot.numpy(), sc.numpy(),
                              res.numpy())
        mask = torch.from_numpy(x["mask"])
        cs = torch.from_numpy(x["counts_stale"])
        for kind in ("f32", "int8"):
            g, meta = ring_variable_pop_sharded(
                cut(f"ring_{kind}", ring_spec), mask,
                scales=(cut("ring_scales", rscales_spec) if kind == "int8"
                        else None), counts_stale=cs)
            out[f"variable_pop_{kind}"] = (g.numpy(), meta.numpy())
    return out


def _wrapper_inputs():
    rng = np.random.default_rng(27)
    f32 = np.float32
    out = {
        "z": rng.standard_normal((ROWS, 128)).astype(f32),
        "g": (rng.standard_normal((ROWS, 128)) * 300).astype(f32),
        "count": f32(1500.0), "alpha": f32(0.0123),
        "slot_pop": rng.integers(-127, 128, (1, ROWS, 128), dtype=np.int8),
        "slot_push": rng.integers(-127, 128, (1, ROWS, 128), dtype=np.int8),
        "scales_pop": rng.uniform(1e-3, 2e-2, (1, ROWS)).astype(f32),
        "scales_push": rng.uniform(1e-3, 2e-2, (1, ROWS)).astype(f32),
        "fed": rng.standard_normal((1, ROWS, 128)).astype(f32),
        "ring_f32": rng.standard_normal((5, 1, ROWS, 128)).astype(f32),
        "ring_int8": rng.integers(-127, 128, (5, 1, ROWS, 128),
                                  dtype=np.int8),
        "ring_scales": rng.uniform(1e-3, 2e-2, (5, 1, ROWS)).astype(f32),
        "mask": np.array([True, False, True, True, False]),
        "counts_stale": np.stack([rng.integers(0, 50, 5),
                                  rng.integers(0, 4, 5)]).astype(f32),
    }
    amax = np.abs(out["fed"]).max(-1)
    out["scale_new"] = (np.maximum(amax, f32(1e-12)) / f32(127)).astype(f32)
    return out


def _run_rank(rank, world, tmp):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=world)
    with open(f"{tmp}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    res = {"grad": {}, "train": {}}
    try:
        for label, arch, shape in GRAD_CASES:
            if shape[0] * shape[1] * shape[2] != world:
                continue
            mesh = make_mesh(MeshConfig(*shape), "cpu")
            with mesh:
                for sp in ((False, True) if world == 2 else (False,)):
                    res["grad"][(label, sp)] = dict(
                        _grad_case(arch, shape, sp, inputs["params"][arch],
                                   inputs["batch"][arch]),
                        coords=mesh.coords)
        for label, arch, shape, comp, sp in TRAIN_CASES:
            if shape[0] * shape[1] * shape[2] != world:
                continue
            res["train"][label] = _train_case(rank, arch, shape, comp, sp,
                                              f"{tmp}/{label}")
        if world == 2:
            # a 1x1x1 checkpoint (step 3) restored on 1x1x2, to step 4
            ck = f"{tmp}/restart-1x1x2"
            rc = _rc(RESTART_ARCH, (1, 1, 2), "int8")
            out = train(build_model(rc.model, device="cpu"), rc,
                        _loop(ck, n_steps=STEPS + 1), device="cpu",
                        mesh=make_mesh(rc.mesh, "cpu"))
            res["restart"] = {"history": out["history"],
                              "state": _ckpt_leaves(ck) if rank == 0
                              else None}
            res["errors"] = _refusals()
            from repro_torch.launch.train import main
            res["cli"] = main(CLI_ARGV + ["--mesh", "1x1x2"])["history"]
            res["bf16"] = {}
            with make_mesh(MeshConfig(1, 1, 2), "cpu"):
                for sp in (False, True):
                    res["bf16"][sp] = _bf16_loss(sp, inputs)
        else:
            res["wrappers"] = _wrappers((1, 2, 2))
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The references and the spawns
# ---------------------------------------------------------------------------
def _jax_reference(arch):
    """(JAX's init as numpy, the batch, JAX's loss, its gradient leaves
    in sorted-key order)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import transformer as jtf
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               compute_dtype="float32")
    jparams, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    batch = _batch(_cfg(arch))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jbatch), has_aux=True)(jparams)
    return (jax.tree.map(np.asarray, jax.device_get(jparams)), batch,
            float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port_grads(arch, params_np, batch_np):
    """The port's unsharded loss and gradient on the same parameters."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.models.api import build_model
    model = build_model(_cfg(arch), device="cpu")
    leaves, treedef = tree_flatten(params_np)
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, leaves),
                         {k: torch.from_numpy(v)
                          for k, v in batch_np.items()})
    return float(loss.detach()), [g.numpy() for g in
                         torch.autograd.grad(loss, leaves)]


def _port_bf16(arch, params_np, batch_np):
    """The port's unsharded bf16 loss and its whole leaves' gradient."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(_cfg(arch), compute_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    _, dims = _model_dims(arch, (1, 1, 2))
    leaves, treedef = tree_flatten(params_np)
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True)
              for x in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, leaves),
                         {k: torch.from_numpy(v)
                          for k, v in batch_np.items()})
    grads = torch.autograd.grad(loss, leaves)
    return {"loss": float(loss.detach()),
            "grads": [g.numpy() for g, d in zip(grads, dims) if d is None]}


def _stacked(arch, compression, ckpt_dir=None, n_steps=STEPS):
    from repro_torch.models.api import build_model
    from repro_torch.train.checkpoint import _flatten_with_paths
    from repro_torch.train.loop import train
    rc = _rc(arch, (1, 1, 1), compression)
    out = train(build_model(rc.model, device="cpu"), rc,
                _loop(ckpt_dir, n_steps), device="cpu")
    return {"history": out["history"],
            "state": {k: v.numpy() for k, v in
                      _flatten_with_paths(out["state"])}}


def _spawn(world, tmp, inputs):
    import torch.multiprocessing as mp
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(_run_rank, args=(world, str(tmp)), nprocs=world)
    runs = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The references (parent) and every rank's results (spawned)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {"jax": {}, "port": {}, "stacked": {}}
        for arch in W2_ARCHS + ("chatglm3-6b",):
            params, batch, loss, grads = _jax_reference(arch)
            out["jax"][arch] = (params, batch, loss, grads)
            out["port"][arch] = _port_grads(arch, params, batch)
        for _, arch, _, comp, _ in TRAIN_CASES:
            if (arch, comp) not in out["stacked"]:
                out["stacked"][(arch, comp)] = _stacked(arch, comp)
        tmp2 = tmp_path_factory.mktemp("world2")
        # the 1x1x1 run to step 3 whose checkpoint 1x1x2 restores, and the
        # 4-step run both restarts are held against
        _stacked(RESTART_ARCH, "int8", str(tmp2 / "restart-1x1x2"))
        out["stacked4"] = _stacked(RESTART_ARCH, "int8", n_steps=STEPS + 1)
        inputs = {"params": {a: v[0] for a, v in out["jax"].items()},
                  "batch": {a: v[1] for a, v in out["jax"].items()}}
        out["w2"] = _spawn(2, tmp2, inputs)
        out["w4"] = _spawn(4, tmp_path_factory.mktemp("world4"), inputs)
        # the 1x1x2 checkpoint of step 3 restored on 1x1x1, to step 4
        ck = tmp_path_factory.mktemp("restart-1x1x1") / "ck"
        shutil.copytree(tmp2 / f"{RESTART_ARCH}-1x1x2-int8", ck)
        out["restart-1x1x1"] = _stacked(RESTART_ARCH, "int8", str(ck),
                                        n_steps=STEPS + 1)
        from repro_torch.launch.train import main
        out["cli"] = main(CLI_ARGV)["history"]
        out["bf16"] = _port_bf16("qwen1.5-0.5b", *out["jax"]["qwen1.5-0.5b"]
                                 [:2])
        return out
    finally:
        torch.set_num_threads(threads)


def _ranks(ref, shape):
    return ref["w2"] if shape[0] * shape[1] * shape[2] == 2 else ref["w4"]


def _block(x, dim, shape, coords):
    if dim is None:
        return x
    n = x.shape[dim] // shape[2]
    return np.take(x, range(coords["model"] * n, (coords["model"] + 1) * n),
                   axis=dim)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_loss_and_gradient_match_jax_unsharded(ref, case):
    """Each rank's loss equals JAX's; each leaf's gradient is its block
    of JAX's and of the port's unsharded gradient (rtol 1e-5 of the
    leaf's largest element); a whole leaf's is the same on every rank,
    bit for bit."""
    label, arch, shape = case
    _, _, jloss, jgrads = ref["jax"][arch]
    ploss, pgrads = ref["port"][arch]
    _, dims = _model_dims(arch, shape)
    runs = [r["grad"][(label, False)] for r in _ranks(ref, shape)]
    for got in runs:
        assert abs(got["loss"] - jloss) <= RTOL * abs(jloss)
        assert abs(got["loss"] - ploss) <= RTOL * abs(ploss)
        assert len(got["grads"]) == len(jgrads)
        for i, (g, jg, pg, dim) in enumerate(zip(got["grads"], jgrads,
                                                 pgrads, dims)):
            jb = _block(jg, dim, shape, got["coords"])
            assert g.shape == jb.shape, (i, g.shape, jb.shape)
            assert float(np.abs(g - jb).max()) <= \
                RTOL * float(np.abs(jg).max()), i
            pb = _block(pg, dim, shape, got["coords"])
            assert float(np.abs(g - pb).max()) <= \
                RTOL * float(np.abs(pg).max()), i
    for i, dim in enumerate(dims):
        if dim is None:
            for got in runs[1:]:
                np.testing.assert_array_equal(got["grads"][i],
                                              runs[0]["grads"][i])
    assert any(d is None for d in dims) and any(d is not None for d in dims)


@pytest.mark.parametrize("arch", W2_ARCHS)
def test_seq_parallel_matches_off(ref, arch):
    """``seq_parallel`` on 1x1x2: the loss and every gradient leaf of
    the rank within rtol 1e-5 of the run without it; the sequence's
    gathers and scatters replace the activations' all-reduces."""
    for r in ref["w2"]:
        off = r["grad"][(f"{arch}-1x1x2", False)]
        on = r["grad"][(f"{arch}-1x1x2", True)]
        assert abs(on["loss"] - off["loss"]) <= RTOL * abs(off["loss"])
        for a, b in zip(on["grads"], off["grads"]):
            assert float(np.abs(a - b).max()) <= \
                RTOL * float(np.abs(b).max())
        tags = {t for (_, _, t) in on["census"]}
        assert "tp_seq" in tags and "tp_act" not in tags, tags
        assert "tp_act" in {t for (_, _, t) in off["census"]}


def test_seq_parallel_is_the_identity_without_a_model_axis():
    """At model = 1 (no mesh) ``seq_parallel`` changes nothing, bit for
    bit, as JAX's ``_sp``."""
    from repro_torch.models.api import build_model
    out = []
    for sp in (False, True):
        model = build_model(_cfg("qwen3-1.7b", sp), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(model.cfg).items()}
        out.append(float(model.loss(params, batch)[0]))
    assert out[0] == out[1]


def _leaf_of(key):
    return key.split("/")[-1]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_ambdg_on_the_model_axis_matches_one_device(ref, case):
    """Three AMB-DG steps on the mesh against the port's 1x1x1 run: the
    joined checkpoint has the 1x1x1 keys and shapes, each step's loss
    within rtol 1e-5, counts exact, each parameter leaf within 1e-5 of
    its largest element plus one int8 step (the leaf's largest row scale
    in the ring over the smallest applied count), z likewise (any row's
    scale); under int8 the ring's
    scales lie on the whole tree's rows (the 1x1x1 run's shape and
    row -> leaf segments, values within 5 %)."""
    label, arch, shape, comp, _ = case
    want = ref["stacked"][(arch, comp)]
    got = _ranks(ref, shape)[0]["train"][label]
    hg, hw = got["history"], want["history"]
    assert len(hg) == len(hw) == STEPS
    for a, b in zip(hg, hw):
        for key in ("applied_count", "local_count", "step"):
            assert a[key] == b[key], (key, a, b)
        assert abs(a["loss"] - b["loss"]) <= RTOL * abs(b["loss"])
    sg, sw = got["state"], want["state"]
    assert sorted(sg) == sorted(sw)
    counts = [h["applied_count"] for h in hw if h["applied_count"]]
    scales = [v for k, v in sw.items() if ".scales" in k]
    from repro_torch.core.arena import make_layout
    from repro_torch.models.api import build_model
    layout = make_layout(build_model(_cfg(arch), device="cpu")
                         .param_shapes())
    from repro_torch.dist.tensor_parallel import _leaf_paths
    leaf_rows = {f".params/{p}": layout.row_to_leaf == i
                 for i, p in enumerate(_leaf_paths(layout.treedef))}
    for key in sw:
        assert sg[key].shape == sw[key].shape, key
        if not key.startswith((".params", ".opt_state/.z")):
            if any(k in key for k in ("counts", "head", "step")):
                np.testing.assert_array_equal(sg[key], sw[key], key)
            continue
        tol = RTOL * float(np.abs(sw[key]).max())
        if comp == "int8":
            # one int8 step: the leaf's largest row scale (z: any row's)
            rows = leaf_rows.get(key, slice(None))
            tol += max(float(s[0][rows].max()) for s in scales) / min(counts)
        assert float(np.abs(sg[key] - sw[key]).max()) <= tol, key
    if comp == "int8":
        r2l = layout.row_to_leaf
        for key in sw:
            if ".scales" in key:
                assert sg[key].shape == (1, layout.rows), key
                for leaf in range(layout.n_leaves):
                    seg = sg[key][0][r2l == leaf]
                    assert np.all(seg == seg[0]), (key, leaf)
                # a leaf's scale is max |g + residual| / 127: a quantized
                # element that rounds the other way moves the residual
                # (and the scale) by a step, a few per cent on the
                # smallest leaves
                np.testing.assert_allclose(sg[key], sw[key], rtol=0.05)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_model_census_is_the_count_from_the_shapes(ref, case):
    """Every rank's bytes on the ``model`` axis over the run, by tag and
    dtype: ``wire_model.model_axis_bytes`` times the steps, exactly."""
    from repro_torch.launch.wire_model import model_axis_bytes
    label, arch, shape, comp, sp = case
    layout, dims = _model_dims(arch, shape)
    n_data = shape[1]
    rank_batch = WORKERS * SPW // n_data
    one = model_axis_bytes(_cfg(arch, sp), layout, dims,
                           rank_batch // (N_MB // n_data), SEQ,
                           N_MB // n_data, shape[2], comp, n_data=n_data)
    want = {k: STEPS * v for k, v in one.items()}
    for r in _ranks(ref, shape):
        got = {(tag, dt): n for (axis, dt, tag), n in
               r["train"][label]["census"].items() if axis == "model"}
        assert got == want, (label, got, want)


@pytest.mark.parametrize("way", ["1x1x2-to-1x1x1", "1x1x1-to-1x1x2"])
def test_checkpoint_restores_across_the_model_axis(ref, way):
    """A checkpoint of step 3 restored on the other mesh and run to step
    4: the 1x1x1 4-step run's state within the limits of the AMB-DG
    test, its step-4 loss within rtol 1e-5."""
    want = ref["stacked4"]
    got = (ref["restart-1x1x1"] if way.endswith("1x1x1")
           else {"history": ref["w2"][0]["restart"]["history"],
                 "state": ref["w2"][0]["restart"]["state"]})
    assert abs(got["history"][-1]["loss"] - want["history"][-1]["loss"]) \
        <= RTOL * abs(want["history"][-1]["loss"])
    assert got["history"][-1]["step"] == STEPS + 1
    sg, sw = got["state"], want["state"]
    assert sorted(sg) == sorted(sw)
    scales = [v for k, v in sw.items() if ".scales" in k]
    counts = [h["applied_count"] for h in want["history"]
              if h["applied_count"]]
    for key in sw:
        if key.startswith((".params", ".opt_state/.z")):
            tol = RTOL * float(np.abs(sw[key]).max()) + \
                max(float(s.max()) for s in scales) / min(counts)
            assert float(np.abs(sg[key] - sw[key]).max()) <= tol, key


@pytest.mark.parametrize("what, exc, text", [
    ("heads", "ValueError", "whole heads"),
    ("seq", "ValueError", "seq_parallel"),
    ("family", "NotImplementedError", "A.11 part 2, item 6"),
    ("decode", "NotImplementedError", "A.11 part 2, item 6"),
    ("serve", "NotImplementedError", "A.11 part 2, item 6"),
])
def test_model_axis_refusals(ref, what, exc, text):
    """What the ``model`` axis refuses, under 1x1x2. "decode" and "serve"
    name the refusals of item 6 this test pinned until decoding and
    ``api.serve`` ran at ``model > 1``: they now run there, one decode
    step on the rank's blocks and two engine steps (their parity is
    ``test_torch_tp_serve``'s)."""
    msg = ref["w2"][0]["errors"][what]
    if what in ("decode", "serve"):
        assert msg is None, msg
        return
    assert msg is not None and msg.startswith(exc) and text in msg, msg


@pytest.mark.parametrize("sp", [False, True], ids=["plain", "seq_parallel"])
def test_bf16_on_the_model_axis_within_the_bf16_limits(ref, sp):
    """bf16 compute on 1x1x2 (the sequence's gathers of bf16 activations
    cross as raw bytes): the loss and each whole leaf's gradient within
    the bf16 limits of the unsharded port's (loss 2e-3, a gradient 5e-2
    of its largest element), the same on both ranks."""
    want = ref["bf16"]
    runs = [r["bf16"][sp] for r in ref["w2"]]
    for got in runs:
        assert abs(got["loss"] - want["loss"]) <= \
            BF16_LOSS_RTOL * abs(want["loss"])
        for g, w in zip(got["grads"], want["grads"]):
            assert float(np.abs(g - w).max()) <= \
                BF16_GRAD_RTOL * float(np.abs(w).max())
        for g, w in zip(got["grads"], runs[0]["grads"]):
            np.testing.assert_array_equal(g, w)
    if sp:
        dtypes = {dt for (_, dt, t) in runs[0]["census"] if t == "tp_seq"}
        assert dtypes == {"bf16", "f32"}, dtypes


def test_train_cli_on_the_model_axis(ref):
    """``python -m repro_torch.launch.train ... --mesh 1x1x2`` (its
    ``main`` in the ranks' world; bf16 compute, int8): two steps, the
    counts of the 1x1x1 CLI run and its last loss (the one it logs)
    within the bf16 limit."""
    got, want = ref["w2"][0]["cli"], ref["cli"]
    assert len(got) == len(want) == 1 and got[0]["step"] == 2
    for a, b in zip(got, want):
        for key in ("applied_count", "local_count", "step"):
            assert a[key] == b[key], (key, a, b)
        assert abs(a["loss"] - b["loss"]) <= BF16_LOSS_RTOL * abs(b["loss"])


@pytest.mark.parametrize("kind", ["dual_update", "slot_rotate",
                                  "variable_pop_f32", "variable_pop_int8"])
def test_sharded_wrappers_on_data_x_model_rows(ref, kind):
    """The three sharded wrappers on 1x2x2 (the rows of one pod over
    data x model): each rank's output is its block of the off-mesh
    route's, bit for bit."""
    from repro_torch.dist.sharding import arena_slot_specs, local_shard
    from repro_torch.kernels.delay_ring.ops import (ring_slot_rotate_int8,
                                                    ring_variable_pop)
    from repro_torch.kernels.dual_update.ops import dual_update_arena
    cfg = MeshConfig(1, 2, 2)
    t = {k: torch.from_numpy(np.array(v))
         for k, v in _wrapper_inputs().items()}
    slot_spec, scales_spec, row_spec = arena_slot_specs(cfg, ROWS)
    assert row_spec == (("data", "model"),)
    if kind == "dual_update":
        want = dual_update_arena(t["z"].clone(), t["g"], t["count"],
                                 t["alpha"])
        specs = (row_spec, row_spec)
    elif kind == "slot_rotate":
        popped, slot, sc, res = ring_slot_rotate_int8(
            t["slot_pop"], t["scales_pop"], t["slot_push"].clone(),
            t["scales_push"].clone(), t["fed"].clone(), t["scale_new"])
        want = (popped[0], slot, sc, res)
        specs = (row_spec, slot_spec, scales_spec, slot_spec)
    else:
        int8 = kind.endswith("int8")
        part, meta = ring_variable_pop(
            t["ring_int8"] if int8 else t["ring_f32"], t["mask"],
            scales=t["ring_scales"] if int8 else None,
            counts_stale=t["counts_stale"])
        want = (part[0], meta)
        specs = (row_spec, ())
    blocks = set()
    for r in ref["w4"]:
        out = r["wrappers"]
        for got, full, spec in zip(out[kind], want, specs):
            block = local_shard(full, spec, cfg, out["coords"]).numpy()
            np.testing.assert_array_equal(got, block)
        blocks.add((out["coords"]["data"], out["coords"]["model"]))
    assert blocks == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_mesh_rows_split_over_data_then_model():
    """The arena's row entry on 1x2x2 is ('data', 'model'): rank (d, m)
    holds block d * 2 + m (``dist.sharding.block``), as the product
    group ``make_mesh`` makes orders the ranks of a pod."""
    from repro_torch.dist.sharding import arena_slot_specs, block
    cfg = MeshConfig(1, 2, 2)
    entry = arena_slot_specs(cfg, ROWS)[2][0]
    assert [block(entry, cfg, {"data": d, "model": m})
            for d in range(2) for m in range(2)] == \
        [(4, 0), (4, 1), (4, 2), (4, 3)]
