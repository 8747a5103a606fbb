"""Tensor parallelism over the mesh's ``model`` axis for the mixtrals
(MOE) and zamba2 (HYBRID) (``dist.tensor_parallel``), with
``seq_parallel``, on gloo CPU ranks.

The ranks are spawned once per world size (2 and 4), both at once,
while the parent computes the references: JAX's unsharded ``lm_loss``
and its gradient (one computation an arch) on the port's whole init,
which the ranks cut their blocks from, and the port's ``1x1x1`` runs.
Each rank runs every case of its size and saves what it got; the cases
are parametrised over those results.

World 2, ``1x1x2``, f32 SMOKE: mixtral-8x7b with ``moe_impl`` "einsum"
and "gather", mixtral-8x22b (einsum) and zamba2 (the "xla" scan):
  * the loss and each gradient leaf equal JAX's and the port's
    unsharded ones within rtol 1e-5 (of the leaf's largest element),
    with and without ``seq_parallel``; against JAX, zamba2's decay
    leaves (``a_log``, ``dt_bias``) within ``test_torch_hybrid_slice``'s
    5e-5 (the port's unsharded ``a_log`` gradient is already 2.1e-5 from
    JAX's here: the two frameworks sum the running log-decay's terms in
    other orders); a model-cut leaf's gradient is its block of JAX's
    (the Mamba2 ``Segments`` leaves included); each whole leaf's
    gradient
    (``w_router``, ``a_log``, ``dt_bias``, ``d_skip``, the norms, the
    B / C columns of ``w_in``, ``w_conv`` and ``b_conv``) is the same on
    every rank, bit for bit;
  * the routing (each layer's top-k experts and kept assignments) is
    the same on every rank, bit for bit, and JAX's router's on the same
    input;
  * three AMB-DG steps (tau 1, none and int8) against the port's 1x1x1
    run, within the limits of ``test_torch_tensor_parallel``;
  * the ``model`` census of each run equals ``wire_model.
    model_axis_bytes`` times the steps;
  * a zamba2 1x1x2 checkpoint restores on 1x1x1, and a 1x1x1 one on
    1x1x2;
  * decoding and ``api.serve`` run at ``model > 1`` (once refused
    there);
  * the train CLI with ``--mesh 1x1x2`` on both families.
World 4: mixtral-8x7b on ``1x1x4`` (2 kv heads: the whole-kv route) and
zamba2 on ``1x2x2`` (the rows over data x model), each against JAX and
the 1x1x1 run as above. Every MoE case drops assignments at the
capacity.
"""
import dataclasses
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import (AmbdgConfig, MeshConfig, RunConfig,
                                      TRAIN_4K)

# label -> (arch, moe_impl)
MODELS = {"mixtral-8x7b-einsum": ("mixtral-8x7b", "einsum"),
          "mixtral-8x7b-gather": ("mixtral-8x7b", "gather"),
          "mixtral-8x22b-einsum": ("mixtral-8x22b", "einsum"),
          "zamba2": ("zamba2-2.7b", None)}
ARCHS = ("mixtral-8x7b", "mixtral-8x22b", "zamba2-2.7b")
# (label, model, mesh) of the gradient cases, each with and without
# seq_parallel
GRAD_CASES = ([(f"{m}-1x1x2", m, (1, 1, 2)) for m in MODELS]
              + [("mixtral-8x7b-1x1x4", "mixtral-8x7b-einsum", (1, 1, 4)),
                 ("zamba2-1x2x2", "zamba2", (1, 2, 2))])
# (label, model, mesh, pod compression, seq_parallel)
TRAIN_CASES = [
    ("mixtral-8x7b-einsum-1x1x2-none", "mixtral-8x7b-einsum", (1, 1, 2),
     "none", False),
    ("mixtral-8x7b-gather-1x1x2-int8", "mixtral-8x7b-gather", (1, 1, 2),
     "int8", False),
    ("mixtral-8x7b-gather-1x1x2-int8-sp", "mixtral-8x7b-gather", (1, 1, 2),
     "int8", True),
    ("mixtral-8x22b-einsum-1x1x2-int8", "mixtral-8x22b-einsum", (1, 1, 2),
     "int8", False),
    ("zamba2-1x1x2-none", "zamba2", (1, 1, 2), "none", False),
    ("zamba2-1x1x2-int8-sp", "zamba2", (1, 1, 2), "int8", True),
    ("mixtral-8x7b-1x1x4-int8", "mixtral-8x7b-einsum", (1, 1, 4), "int8",
     False),
    ("zamba2-1x2x2-int8", "zamba2", (1, 2, 2), "int8", False)]
# the train CLI on 1x1x2 (its own default compute dtype, bf16)
CLI_ARCHS = ("mixtral-8x7b", "zamba2-2.7b")
BF16_LOSS_RTOL = 2e-3     # test_torch_tensor_parallel's CLI limit
GRAD_B, SEQ = 4, 16
STEPS, WORKERS, SPW, N_MB = 3, 4, 2, 2
RTOL = 1e-5
# against JAX: the decay leaves' gradients (test_torch_hybrid_slice's)
DECAY_RTOL = {"a_log": 5e-5, "dt_bias": 5e-5}
RESTART = ("zamba2", "int8")


def _cfg(model, sp=False):
    arch, impl = MODELS[model]
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32", seq_parallel=sp)
    if impl is not None:
        cfg = dataclasses.replace(cfg, moe_impl=impl)
    return cfg


def _rc(model, shape, compression, sp=False) -> RunConfig:
    return RunConfig(
        model=_cfg(model, sp),
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


def _arch(model):
    return MODELS[model][0]


def _cli_argv(arch):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--seq-len", "16", "--n-workers", "2", "--samples-per-worker",
            "2", "--pod-compression", "int8"]


def _ckpt_leaves(ckpt_dir):
    path = max(Path(ckpt_dir).glob("step_*"))
    with np.load(path / "state.npz") as f:
        return {k: f[k] for k in f.files}


def _model_dims(model, shape):
    from repro_torch.core.arena import make_layout
    from repro_torch.dist.tensor_parallel import model_dims
    from repro_torch.models.api import build_model
    m = build_model(_cfg(model), device="cpu")
    layout = make_layout(m.param_shapes())
    return layout, model_dims(m.cfg, layout, m.param_axes(),
                              MeshConfig(*shape))


def _tensors(tree_np):
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(tree_np)
    return tree_unflatten(treedef, [torch.from_numpy(np.array(x))
                                    for x in leaves])


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
def _grad_case(model, shape, sp, whole_np, batch_np):
    """This rank's loss and gradient on its blocks of ``whole_np``, and
    every router call's (top-k experts, input)."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.dist.collectives import wire_census
    from repro_torch.dist.tensor_parallel import cut_params, model_axis
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.api import build_model
    m = build_model(_cfg(model, sp), device="cpu")
    _, dims = _model_dims(model, shape)
    leaves, treedef = tree_flatten(cut_params(_tensors(whole_np), dims,
                                              model_axis()))
    leaves = [x.requires_grad_(True) for x in leaves]
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    routes = []
    router = moe_mod._router

    def record(p, cfg, xg):
        out = router(p, cfg, xg)
        routes.append((out[1].numpy().copy(), xg.detach().numpy().copy()))
        return out
    moe_mod._router = record
    try:
        with wire_census() as census:
            loss, _ = m.loss(tree_unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        moe_mod._router = router
    return {"loss": float(loss.detach()), "grads": [g.numpy() for g in grads],
            "routes": routes, "census": dict(census.bytes)}


def _train_case(rank, model, shape, compression, sp, ckpt_dir):
    from repro_torch.dist.collectives import wire_census
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train
    rc = _rc(model, shape, compression, sp)
    mesh = make_mesh(rc.mesh, "cpu")
    with wire_census() as census:
        out = train(build_model(rc.model, device="cpu"), rc,
                    _loop(ckpt_dir), device="cpu", mesh=mesh)
    return {"history": out["history"], "census": dict(census.bytes),
            "state": _ckpt_leaves(ckpt_dir) if rank == 0 else None}


def _refusals():
    """Decoding and serving on 1x1x2 (each family), once refused there:
    None where they run (one decode step on the rank's blocks, its
    logits the rank's vocab block; two steps of ``api.serve``), else the
    message."""
    from repro_torch import api
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    errors = {}

    def decode(m):
        params = m.init()
        cache, _ = m.init_decode_state(2, 8)
        logits, _ = m.decode_step(params, cache,
                                  torch.zeros((2, 1), dtype=torch.int64),
                                  torch.zeros((2,), dtype=torch.int64))
        assert logits.shape == (2, 1, m.cfg.padded_vocab_size // 2)

    def serve(m, rc):
        engine, queue = api.serve(m, rc, device="cpu")
        engine.serve(queue, 2)

    for model in ("mixtral-8x7b-einsum", "zamba2"):
        rc = _rc(model, (1, 1, 2), "none")
        m = build_model(rc.model, device="cpu")
        with make_mesh(rc.mesh, "cpu"):
            for what, fn in (("decode", lambda: decode(m)),
                             ("serve", lambda: serve(m, rc))):
                try:
                    fn()
                    errors[(model, what)] = None
                except Exception as e:  # noqa: BLE001 - the message
                    errors[(model, what)] = f"{type(e).__name__}: {e}"
    return errors


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
        for label, model, shape in GRAD_CASES:
            if int(np.prod(shape)) != world:
                continue
            mesh = make_mesh(MeshConfig(*shape), "cpu")
            with mesh:
                for sp in (False, True):
                    res["grad"][(label, sp)] = dict(
                        _grad_case(model, shape, sp,
                                   inputs["params"][_arch(model)],
                                   inputs["batch"][_arch(model)]),
                        coords=mesh.coords)
        for label, model, shape, comp, sp in TRAIN_CASES:
            if int(np.prod(shape)) == world:
                res["train"][label] = _train_case(rank, model, shape, comp,
                                                  sp, f"{tmp}/{label}")
        if world == 2:
            # the 1x1x1 checkpoint of step 3 restored on 1x1x2, to step 4
            ck = f"{tmp}/restart-1x1x2"
            rc = _rc(*RESTART[:1], (1, 1, 2), RESTART[1])
            out = train(build_model(rc.model, device="cpu"), rc,
                        _loop(ck, n_steps=STEPS + 1), device="cpu",
                        mesh=make_mesh(rc.mesh, "cpu"))
            res["restart"] = {"history": out["history"],
                              "state": _ckpt_leaves(ck) if rank == 0
                              else None}
            res["errors"] = _refusals()
            from repro_torch.launch.train import main
            res["cli"] = {arch: main(_cli_argv(arch) + ["--mesh", "1x1x2"])
                          ["history"] for arch in CLI_ARCHS}
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The references and the spawns
# ---------------------------------------------------------------------------
def _inputs():
    """The port's whole init (seed 0) and the batch of each arch, as
    numpy."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.api import build_model
    params, batches = {}, {}
    for model in ("mixtral-8x7b-einsum", "mixtral-8x22b-einsum", "zamba2"):
        cfg = _cfg(model)
        p = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        leaves, treedef = tree_flatten(p)
        params[_arch(model)] = tree_unflatten(treedef,
                                              [x.numpy() for x in leaves])
        b = TokenStream(cfg, seed=3).next_batch(GRAD_B, SEQ)
        b["weights"] = np.array([1.0, 0.5, 0.25, 1.0], np.float32)
        batches[_arch(model)] = b
    return {"params": params, "batch": batches}


def _jax_cfg(model):
    from repro.configs import get_smoke_config as jax_smoke_config
    return dataclasses.replace(jax_smoke_config(_arch(model)),
                               compute_dtype="float32")


def _jax_reference(model, params_np, batch_np):
    """JAX's loss and gradient leaves (sorted-key order) on the port's
    init."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtf
    jcfg = _jax_cfg(model)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jbatch), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_grads(model, params_np, batch_np):
    """The port's unsharded loss and gradient on the same parameters."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.models.api import build_model
    leaves, treedef = tree_flatten(_tensors(params_np))
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, _ = build_model(_cfg(model), device="cpu").loss(
        tree_unflatten(treedef, leaves),
        {k: torch.from_numpy(v) for k, v in batch_np.items()})
    return float(loss.detach()), [g.numpy() for g in
                                  torch.autograd.grad(loss, leaves)]


def _stacked(model, compression, ckpt_dir=None, n_steps=STEPS):
    from repro_torch.models.api import build_model
    from repro_torch.train.checkpoint import _flatten_with_paths
    from repro_torch.train.loop import train
    rc = _rc(model, (1, 1, 1), compression)
    out = train(build_model(rc.model, device="cpu"), rc,
                _loop(ckpt_dir, n_steps), device="cpu")
    return {"history": out["history"],
            "state": {k: v.numpy() for k, v in
                      _flatten_with_paths(out["state"])}}


def _start(world, tmp, inputs):
    import torch.multiprocessing as mp
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return mp.spawn(_run_rank, args=(world, str(tmp)), nprocs=world,
                    join=False)


def _results(ctx, world, tmp):
    while not ctx.join():
        pass
    runs = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The references (parent, while the ranks run) and every rank's
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inputs = _inputs()
        tmp2 = tmp_path_factory.mktemp("world2")
        tmp4 = tmp_path_factory.mktemp("world4")
        # the 1x1x1 run to step 3 whose checkpoint 1x1x2 restores
        _stacked(*RESTART, str(tmp2 / "restart-1x1x2"))
        spawns = [(_start(2, tmp2, inputs), 2, tmp2),
                  (_start(4, tmp4, inputs), 4, tmp4)]
        out = {"inputs": inputs, "jax": {}, "port": {}, "stacked": {}}
        try:
            for model in MODELS:
                arch = _arch(model)
                args = (model, inputs["params"][arch], inputs["batch"][arch])
                if arch not in out["jax"]:
                    out["jax"][arch] = _jax_reference(*args)
                out["port"][model] = _port_grads(*args)
            for _, model, _, comp, _ in TRAIN_CASES:
                if (model, comp) not in out["stacked"]:
                    out["stacked"][(model, comp)] = _stacked(model, comp)
            # the 4-step run both restarts are held against
            out["stacked4"] = _stacked(*RESTART, n_steps=STEPS + 1)
            from repro_torch.launch.train import main
            out["cli"] = {arch: main(_cli_argv(arch))["history"]
                          for arch in CLI_ARCHS}
        finally:
            out["w2"], out["w4"] = (_results(*s) for s in spawns)
        # the 1x1x2 checkpoint of step 3 restored on 1x1x1, to step 4
        ck = tmp_path_factory.mktemp("restart-1x1x1") / "ck"
        shutil.copytree(tmp2 / "zamba2-1x1x2-int8-sp", ck)
        out["restart-1x1x1"] = _stacked(*RESTART, str(ck),
                                        n_steps=STEPS + 1)
        return out
    finally:
        torch.set_num_threads(threads)


def _ranks(ref, shape):
    return ref["w2"] if int(np.prod(shape)) == 2 else ref["w4"]


def _block(x, dim, n, m):
    """Rank ``m`` of ``n``'s block of the whole leaf ``x`` (numpy)."""
    from repro_torch.dist.tensor_parallel import cut_leaf, ModelAxis
    return cut_leaf(torch.from_numpy(np.array(x)), dim,
                    ModelAxis(None, n, m)).numpy()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sp", [False, True], ids=["plain", "seq_parallel"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_loss_and_gradient_match_jax_unsharded(ref, case, sp):
    """Each rank's loss equals JAX's and the port's unsharded one; each
    leaf's gradient is its block of theirs (rtol 1e-5 of the leaf's
    largest element; against JAX the decay leaves' ``DECAY_RTOL``); a
    whole leaf's gradient, and the whole columns of a ``Segments``
    leaf's, are the same on every rank, bit for bit."""
    from repro_torch.dist.tensor_parallel import Segments, _leaf_paths
    label, model, shape = case
    jloss, jgrads = ref["jax"][_arch(model)]
    ploss, pgrads = ref["port"][model]
    layout, dims = _model_dims(model, shape)
    names = _leaf_paths(layout.treedef)
    runs = [r["grad"][(label, sp)] for r in _ranks(ref, shape)]
    for got in runs:
        assert abs(got["loss"] - jloss) <= RTOL * abs(jloss)
        assert abs(got["loss"] - ploss) <= RTOL * abs(ploss)
        assert len(got["grads"]) == len(jgrads)
        for i, (g, jg, pg, dim) in enumerate(zip(got["grads"], jgrads,
                                                 pgrads, dims)):
            m = got["coords"]["model"]
            jb, pb = (_block(x, dim, shape[2], m) for x in (jg, pg))
            assert g.shape == jb.shape, (i, g.shape, jb.shape)
            rtol = DECAY_RTOL.get(names[i].rsplit("/", 1)[-1], RTOL)
            assert float(np.abs(g - jb).max()) <= \
                rtol * float(np.abs(jg).max()), names[i]
            assert float(np.abs(g - pb).max()) <= \
                RTOL * float(np.abs(pg).max()), names[i]
    whole = set()
    for i, dim in enumerate(dims):
        if isinstance(dim, Segments):
            cols = [c for ofs, width, split in dim.local_parts(shape[2])
                    if not split for c in range(ofs, ofs + width)]
            pick = lambda g: np.take(g, cols, axis=dim.dim)  # noqa: E731
        elif dim is None:
            pick = lambda g: g  # noqa: E731
        else:
            continue
        whole.add(names[i].rsplit("/", 1)[-1])
        for got in runs[1:]:
            np.testing.assert_array_equal(pick(got["grads"][i]),
                                          pick(runs[0]["grads"][i]))
    want = ({"w_router"} if model.startswith("mixtral") else
            {"a_log", "dt_bias", "d_skip", "w_in", "w_conv", "b_conv"})
    assert want <= whole, whole


MOE_CASES = [c for c in GRAD_CASES if c[1].startswith("mixtral")]


def _kept(idx, capacity):
    """(G, g, k) expert ids -> the kept mask: an assignment's rank
    within its expert, in the group's (token, k) order, below the
    capacity."""
    G, g, k = idx.shape
    flat = idx.reshape(G, g * k)
    onehot = flat[..., None] == np.arange(idx.max() + 1)
    rank = np.cumsum(onehot, axis=1) - 1
    return (np.take_along_axis(rank, flat[..., None], 2)[..., 0]
            < capacity).reshape(G, g, k)


@pytest.mark.parametrize("sp", [False, True], ids=["plain", "seq_parallel"])
@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_routing_is_every_ranks_and_jaxs(ref, case, sp):
    """Every rank routes every token alike: each router call's input,
    top-k experts and kept assignments are the same on every rank, bit
    for bit; each layer's experts are JAX's router's on that input."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    from repro_torch.models.moe import _capacity
    label, model, shape = case
    runs = [r["grad"][(label, sp)]["routes"] for r in _ranks(ref, shape)]
    cfg = _cfg(model)
    assert len(runs[0]) == 2 * cfg.n_layers     # forward and recomputed
    for routes in runs[1:]:
        for (idx, xg), (idx0, xg0) in zip(routes, runs[0]):
            np.testing.assert_array_equal(xg, xg0)
            np.testing.assert_array_equal(idx, idx0)
    jcfg = _jax_cfg(model)
    w = ref["inputs"]["params"][_arch(model)]["layers"]["moe"]["w_router"]
    dropped = 0
    for layer, (idx, xg) in enumerate(runs[0][:cfg.n_layers]):
        _, jidx, _ = jmoe._router({"w_router": jnp.asarray(w[layer])}, jcfg,
                                  jnp.asarray(xg))
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        cap = _capacity(cfg, xg.shape[1])
        kept = _kept(idx, cap)
        np.testing.assert_array_equal(kept, _kept(np.asarray(jidx), cap))
        dropped += int((~kept).sum())
    assert dropped > 0      # the capacity drops assignments


W2_GRAD = [c for c in GRAD_CASES if c[2] == (1, 1, 2)]


@pytest.mark.parametrize("case", W2_GRAD, ids=[c[0] for c in W2_GRAD])
def test_seq_parallel_matches_off(ref, case):
    """``seq_parallel`` on 1x1x2: the loss and every gradient leaf of
    the rank within rtol 1e-5 of the run without it; the sequence's
    gathers and scatters replace the activations' all-reduces."""
    label = case[0]
    for r in ref["w2"]:
        off, on = r["grad"][(label, False)], r["grad"][(label, True)]
        assert abs(on["loss"] - off["loss"]) <= RTOL * abs(off["loss"])
        for a, b in zip(on["grads"], off["grads"]):
            assert float(np.abs(a - b).max()) <= \
                RTOL * float(np.abs(b).max())
        tags = {t for (_, _, t) in on["census"]}
        assert "tp_seq" in tags and "tp_act" not in tags, tags
        assert "tp_act" in {t for (_, _, t) in off["census"]}


def _leaf_rows(model):
    from repro_torch.core.arena import make_layout
    from repro_torch.dist.tensor_parallel import _leaf_paths
    from repro_torch.models.api import build_model
    layout = make_layout(build_model(_cfg(model), device="cpu")
                         .param_shapes())
    return layout, {f".params/{p}": layout.row_to_leaf == i
                    for i, p in enumerate(_leaf_paths(layout.treedef))}


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_ambdg_on_the_model_axis_matches_one_device(ref, case):
    """Three AMB-DG steps on the mesh against the port's 1x1x1 run: the
    joined checkpoint has the 1x1x1 keys and shapes, each step's loss
    within rtol 1e-5, counts exact, each parameter leaf and z within
    1e-5 of the largest element plus one int8 step (the leaf's largest
    row scale in the ring over the smallest applied count; z: any
    row's); under int8 the ring's scales lie on the whole tree's rows
    (the 1x1x1 run's shape and row -> leaf segments, values within 5 %
    plus one step of the other slot's push: zamba2's blocks sit at w =
    0 after step 1, so step 3's gradient of their leaves is ~1e-4 of
    step 2's scale and their slot scale is that push's quantization
    residual)."""
    label, model, shape, comp, _ = case
    want = ref["stacked"][(model, comp)]
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
    layout, leaf_rows = _leaf_rows(model)
    for key in sw:
        assert sg[key].shape == sw[key].shape, key
        if not key.startswith((".params", ".opt_state/.z")):
            if any(k in key for k in ("counts", "head", "step")):
                np.testing.assert_array_equal(sg[key], sw[key], key)
            continue
        tol = RTOL * float(np.abs(sw[key]).max())
        if comp == "int8":
            rows = leaf_rows.get(key, slice(None))
            tol += max(float(s[0][rows].max()) for s in scales) / min(counts)
        assert float(np.abs(sg[key] - sw[key]).max()) <= tol, key
    if comp == "int8":
        r2l = layout.row_to_leaf
        slots = [k for k in sw if ".scales" in k]
        for key in slots:
            assert sg[key].shape == (1, layout.rows), key
            for leaf in range(layout.n_leaves):
                seg = sg[key][0][r2l == leaf]
                assert np.all(seg == seg[0]), (key, leaf)
            # a slot's scale is max |g + residual| / 127: the residual of
            # the other slot's push moves by one of its steps where an
            # element rounds the other way, which is all there is where
            # the gradient is far below that push's scale
            prev = np.max([sw[k] for k in slots if k != key], axis=0)
            tol = 0.05 * np.abs(sw[key]) + prev / 127
            assert np.all(np.abs(sg[key] - sw[key]) <= tol), key


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_model_census_is_the_count_from_the_shapes(ref, case):
    """Every rank's bytes on the ``model`` axis over the run, by tag and
    dtype: ``wire_model.model_axis_bytes`` times the steps, exactly."""
    from repro_torch.launch.wire_model import model_axis_bytes
    label, model, shape, comp, sp = case
    layout, dims = _model_dims(model, shape)
    n_data = shape[1]
    rank_batch = WORKERS * SPW // n_data
    one = model_axis_bytes(_cfg(model, sp), layout, dims,
                           rank_batch // (N_MB // n_data), SEQ,
                           N_MB // n_data, shape[2], comp, n_data=n_data)
    want = {k: STEPS * v for k, v in one.items()}
    tags = {"tp_router"} if model.startswith("mixtral") else {"tp_norm"}
    assert tags <= {t for t, _ in want}, want
    for r in _ranks(ref, shape):
        got = {(tag, dt): n for (axis, dt, tag), n in
               r["train"][label]["census"].items() if axis == "model"}
        assert got == want, (label, got, want)


@pytest.mark.parametrize("way", ["1x1x2-to-1x1x1", "1x1x1-to-1x1x2"])
def test_checkpoint_restores_across_the_model_axis(ref, way):
    """A zamba2 checkpoint of step 3 (the ``Segments`` leaves joined
    whole) restored on the other mesh and run to step 4: the 1x1x1
    4-step run's state within the limits of the AMB-DG test, its step-4
    loss within rtol 1e-5."""
    want = ref["stacked4"]
    got = (ref["restart-1x1x1"] if way.endswith("1x1x1")
           else ref["w2"][0]["restart"])
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


@pytest.mark.parametrize("what", ["decode", "serve"])
@pytest.mark.parametrize("model", ["mixtral-8x7b-einsum", "zamba2"])
def test_decoding_and_serving_refuse_the_model_axis(ref, model, what):
    """Decoding and ``api.serve`` at ``model > 1``, refused here until
    the serve profile's layout was ported (ROADMAP A.11 part 2, item 6),
    now run on 1x1x2: one decode step on the rank's blocks, two engine
    steps (their parity is ``test_torch_tp_serve``'s)."""
    msg = ref["w2"][0]["errors"][(model, what)]
    assert msg is None, msg


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_train_cli_on_the_model_axis(ref, arch):
    """``python -m repro_torch.launch.train --arch ... --smoke --mesh
    1x1x2`` (its ``main`` in the ranks' world; bf16 compute, int8): two
    steps, the counts of the 1x1x1 CLI run and its last loss (the one it
    logs) within the bf16 limit."""
    got, want = ref["w2"][0]["cli"][arch], ref["cli"][arch]
    assert len(got) == len(want) == 1 and got[0]["step"] == 2
    for a, b in zip(got, want):
        for key in ("applied_count", "local_count", "step"):
            assert a[key] == b[key], (key, a, b)
        assert abs(a["loss"] - b["loss"]) <= BF16_LOSS_RTOL * abs(b["loss"])


# the encoder-decoder, the VLM and the xLSTM, once refused here
LATER = ("xlstm-125m", "seamless-m4t-large-v2", "paligemma-3b")
# (arch, SMOKE or FULL, model, the exception or None)
AXIS_CASES = ([(a, full, n, None) for a in ARCHS for full in (True, False)
               for n in (2, 4) if full or n == 2 or a != "mixtral-8x22b"]
              + [("mixtral-8x22b", False, 4, ValueError)]
              + [(a, False, 2, None) for a in LATER]
              + [(a, True, n, None) for a in LATER for n in (2, 4)]
              + [("seamless-m4t-large-v2", False, 4, None),
                 ("paligemma-3b", False, 4, None),
                 ("xlstm-125m", False, 4, ValueError)])


@pytest.mark.parametrize("case", AXIS_CASES, ids=[
    f"{a}-{'full' if full else 'smoke'}-{n}" for a, full, n, _ in AXIS_CASES])
def test_check_model_axis_accepts_the_families(case):
    """``check_model_axis`` carries the mixtrals, zamba2, the xLSTM,
    seamless and paligemma at FULL widths on model 2 and 4 and SMOKE on
    2 (and 4 where the heads split); mixtral-8x22b SMOKE's 6 heads and
    the xLSTM SMOKE's 2 do not split over 4."""
    from repro_torch.dist.tensor_parallel import check_model_axis
    arch, full, n, exc = case
    cfg = (get_config if full else get_smoke_config)(arch)
    if exc is None:
        check_model_axis(cfg, n)
        return
    with pytest.raises(exc) as err:
        check_model_axis(cfg, n)
    if exc is NotImplementedError:
        assert "A.11 part 2, item 6" in str(err.value)


@pytest.mark.parametrize("n", [2, 4])
def test_segments_cut_and_join_zamba2_full(n):
    """zamba2 FULL's ``w_in`` (d_proj 10448): each rank's block is its
    heads' z, x and dt columns with B and C whole, and the blocks join
    back to the whole leaf."""
    from repro_torch.dist.tensor_parallel import Segments, leaf_spec
    from repro_torch.models.ssm import mamba2_dims
    cfg = get_config("zamba2-2.7b")
    d_in, nh = mamba2_dims(cfg)
    bc = 2 * cfg.ssm.d_state
    seg = leaf_spec(cfg, "w_in", (3, 2 * d_in + bc + nh), ("layers", "embed",
                                                          "mlp"),
                    MeshConfig(1, 1, n))
    assert isinstance(seg, Segments) and seg.dim == 1
    whole = torch.arange(3 * (2 * d_in + bc + nh)).reshape(3, -1)
    blocks = [seg.cut(whole, n, m) for m in range(n)]
    dl, hl = d_in // n, nh // n
    for m, b in enumerate(blocks):
        assert b.shape == (3, 2 * dl + bc + hl)
        cols = np.concatenate([np.arange(m * dl, (m + 1) * dl),
                               d_in + np.arange(m * dl, (m + 1) * dl),
                               2 * d_in + np.arange(bc),
                               2 * d_in + bc + np.arange(m * hl,
                                                         (m + 1) * hl)])
        np.testing.assert_array_equal(b[0].numpy(), cols)
    assert torch.equal(seg.join(blocks), whole)
