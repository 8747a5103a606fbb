"""Tensor parallelism over the mesh's ``model`` axis for the
encoder-decoder (seamless-m4t), the VLM (paligemma) and the xLSTM
(``dist.tensor_parallel``), on gloo CPU ranks.

The ranks are spawned once per world size (2 and 4), both at once,
while the parent computes the references: JAX's unsharded loss and its
gradient (``encdec.loss`` or ``transformer.lm_loss``) on the port's
whole init, which the ranks cut their blocks from, and the port's
``1x1x1`` runs. Each rank runs every case of its size and saves what it
got; the cases are parametrised over those results. f32 SMOKE; the
xLSTM's sLSTM ``w_h`` is rescaled to fan-in head_dim and its sequences
are 16 tokens (ROADMAP C.16: at the init's scale its f32 gradient is
chaotic).

World 2, ``1x1x2``: seamless on the "xla" and "flash" routes (the flash
kernels' plain version on CPU tensors) and paligemma, each with and
without ``seq_parallel``, and the xLSTM (``seq_parallel`` refused):
  * the loss and each gradient leaf equal JAX's and the port's
    unsharded ones within rtol 1e-5 (of the leaf's largest element); a
    model-cut leaf's gradient is its block of theirs (the xLSTM's
    ``Segments`` leaves included); each whole leaf's gradient is the
    same on every rank, bit for bit (seamless's ``frame_proj`` and
    ``ln_enc_final``, paligemma's stub and its one kv head, the xLSTM's
    ``b_i``, ``b_f``, ``w_h`` and sLSTM FFN);
  * seamless's gradient batch has 24 frames and 16 tokens: the two
    lengths split apart;
  * three AMB-DG steps (tau 1, none and int8) against the port's 1x1x1
    run, within the limits of ``test_torch_tensor_parallel``;
  * the ``model`` census of each run equals ``wire_model.
    model_axis_bytes`` times the steps;
  * an xLSTM 1x1x2 checkpoint restores on 1x1x1, and a 1x1x1 one on
    1x1x2;
  * decoding and ``api.serve`` run at ``model > 1`` for each family
    (once refused there; the xLSTM with ``seq_parallel``), the xLSTM's
    training forward under ``seq_parallel`` raises, and so does a
    seamless source length that does not split;
  * the train CLI with ``--mesh 1x1x2`` on each family.
World 4: paligemma on ``1x1x4`` (its one kv head: the whole-kv route),
seamless and the xLSTM on ``1x2x2`` (the rows over data x model), each
against JAX and the 1x1x1 run as above; the VLM's ``seq_parallel``
length is the patches' and the text's together.
The gate: ``check_model_axis`` on every LM arch at FULL and SMOKE widths
on model 2 and 4.
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

# label -> (arch, attn_impl)
MODELS = {"seamless": ("seamless-m4t-large-v2", "xla"),
          "seamless-flash": ("seamless-m4t-large-v2", "flash"),
          "paligemma": ("paligemma-3b", "xla"),
          "xlstm": ("xlstm-125m", "xla")}
ARCHS = ("seamless-m4t-large-v2", "paligemma-3b", "xlstm-125m")
# (label, model, mesh, the seq_parallel settings) of the gradient cases
GRAD_CASES = [("seamless-1x1x2", "seamless", (1, 1, 2), (False, True)),
              ("seamless-flash-1x1x2", "seamless-flash", (1, 1, 2),
               (False, True)),
              ("paligemma-1x1x2", "paligemma", (1, 1, 2), (False, True)),
              ("xlstm-1x1x2", "xlstm", (1, 1, 2), (False,)),
              ("paligemma-1x1x4", "paligemma", (1, 1, 4), (False, True)),
              ("seamless-1x2x2", "seamless", (1, 2, 2), (False, True)),
              ("xlstm-1x2x2", "xlstm", (1, 2, 2), (False,))]
GRAD_PARAMS = [(label, model, shape, sp) for label, model, shape, sps
               in GRAD_CASES for sp in sps]
# (label, model, mesh, pod compression, seq_parallel)
TRAIN_CASES = [
    ("seamless-1x1x2-none", "seamless", (1, 1, 2), "none", False),
    ("seamless-flash-1x1x2-int8-sp", "seamless-flash", (1, 1, 2), "int8",
     True),
    ("paligemma-1x1x2-int8-sp", "paligemma", (1, 1, 2), "int8", True),
    ("xlstm-1x1x2-int8", "xlstm", (1, 1, 2), "int8", False),
    ("paligemma-1x1x4-int8", "paligemma", (1, 1, 4), "int8", False),
    ("seamless-1x2x2-int8", "seamless", (1, 2, 2), "int8", False),
    ("xlstm-1x2x2-none", "xlstm", (1, 2, 2), "none", False)]
GRAD_B = 4
# each arch's sequence: seamless's and the xLSTM's tokens, paligemma's
# 16 patches and 16 text tokens; seamless's gradient batch has 24 frames
SEQ = {"seamless-m4t-large-v2": 16, "paligemma-3b": 32, "xlstm-125m": 16}
SRC = 24
STEPS, WORKERS, SPW, N_MB = 3, 4, 2, 2
RTOL = 1e-5
BF16_LOSS_RTOL = 2e-3     # test_torch_tensor_parallel's CLI limit
RESTART = ("xlstm", "int8")
# the leaves whose gradient each rank holds whole, by family
WHOLE = {"seamless": {"frame_proj", "ln_enc_final", "tok_emb"},
         "paligemma": {"patch_proj", "patch_pos", "tok_emb", "wk", "wv"},
         "xlstm": {"b_i", "b_f", "w_h", "w_ff_gate", "w_ff_up", "w_ff_down",
                   "tok_emb"}}


def _arch(model):
    return MODELS[model][0]


def _family(model):
    return model.split("-")[0]


def _cfg(model, sp=False):
    arch, impl = MODELS[model]
    return dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                               attn_impl=impl, seq_parallel=sp)


def _build(cfg):
    """The model of ``cfg`` on the CPU; the xLSTM's init rescales the
    sLSTM's ``w_h`` to fan-in head_dim (whole on every rank)."""
    from repro_torch.models.api import build_model
    model = build_model(cfg, device="cpu")
    if cfg.xlstm is None:
        return model
    return dataclasses.replace(model, init_fn=lambda dev, gen: _rescale(
        model.init_fn(dev, gen), cfg))


def _rescale(params, cfg):
    from repro_torch.models.xlstm import slstm_dims
    nh, hd, _ = slstm_dims(cfg)
    w = params["slstm_layers"]["slstm"]["w_h"]
    if w.device.type != "meta":
        with torch.no_grad():
            w.mul_((nh / hd) ** 0.5)
    return params


def _rc(model, shape, compression, sp=False) -> RunConfig:
    return RunConfig(
        model=_cfg(model, sp),
        shape=dataclasses.replace(TRAIN_4K, seq_len=SEQ[_arch(model)],
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


def _cli_argv(arch):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--seq-len", str(SEQ[arch]), "--n-workers", "2",
            "--samples-per-worker", "2", "--pod-compression", "int8"]


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


def _catch(fn):
    """None, or the message of what ``fn()`` raised."""
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}"


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
def _grad_case(model, sp, whole_np, batch_np):
    """This rank's loss, gradient on its blocks of ``whole_np`` and
    ``model`` census."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.dist.collectives import wire_census
    from repro_torch.dist.tensor_parallel import (cut_params, model_axis,
                                                  model_dims)
    from repro_torch.core.arena import make_layout
    from repro_torch.dist.context import active_mesh
    m = _build(_cfg(model, sp))
    layout = make_layout(m.whole_param_shapes())
    dims = model_dims(m.cfg, layout, m.param_axes(), active_mesh())
    leaves, treedef = tree_flatten(cut_params(_tensors(whole_np), dims,
                                              model_axis()))
    leaves = [x.requires_grad_(True) for x in leaves]
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with wire_census() as census:
        loss, _ = m.loss(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return {"loss": float(loss.detach()), "grads": [g.numpy() for g in grads],
            "census": dict(census.bytes)}


def _train_case(rank, model, shape, compression, sp, ckpt_dir):
    from repro_torch.dist.collectives import wire_census
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import train
    rc = _rc(model, shape, compression, sp)
    mesh = make_mesh(rc.mesh, "cpu")
    with wire_census() as census:
        out = train(_build(rc.model), rc, _loop(ckpt_dir), device="cpu",
                    mesh=mesh)
    return {"history": out["history"], "census": dict(census.bytes),
            "state": _ckpt_leaves(ckpt_dir) if rank == 0 else None}


def _decode_once(m):
    """One decode step on the rank's blocks: its logits must be the
    rank's vocab block."""
    params = m.init()
    cache, _ = m.init_decode_state(2, 8)
    logits, _ = m.decode_step(params, cache,
                              torch.zeros((2, 1), dtype=torch.int64),
                              torch.zeros((2,), dtype=torch.int64))
    assert logits.shape == (2, 1, m.cfg.padded_vocab_size // 2)


def _serve_twice(m, rc):
    from repro_torch import api
    engine, queue = api.serve(m, rc, device="cpu")
    engine.serve(queue, 2)


def _refusals():
    """On 1x1x2: decoding and serving (each family, the xLSTM with
    ``seq_parallel``, which serves), once refused there; the xLSTM's
    training forward under ``seq_parallel``, seamless's source of 15
    frames under it."""
    from repro_torch.launch.mesh import make_mesh
    errors = {}
    with make_mesh(MeshConfig(1, 1, 2), "cpu"):
        for model in ("seamless", "paligemma", "xlstm"):
            rc = _rc(model, (1, 1, 2), "none", sp=model == "xlstm")
            m = _build(rc.model)
            errors[(model, "decode")] = _catch(lambda: _decode_once(m))
            errors[(model, "serve")] = _catch(lambda: _serve_twice(m, rc))
        m = _build(_cfg("xlstm", sp=True))
        batch = m.dummy_batch(2, 16, torch.Generator().manual_seed(0))
        errors["xlstm-sp"] = _catch(lambda: m.loss(m.init(), batch))
        m = _build(_cfg("seamless", sp=True))
        batch = m.dummy_batch(2, 16, torch.Generator().manual_seed(0))
        batch["frames"] = batch["frames"][:, :15]
        errors["seamless-src"] = _catch(lambda: m.loss(m.init(), batch))
    return errors


def _vlm_lengths():
    """On 1x1x4, paligemma SMOKE with 6 patches and ``seq_parallel``:
    {text length: None or the message}; the split covers the patches and
    the text together (10 + 6 = 16 splits over 4 where 10 alone does
    not; 12 + 6 = 18 does not where 12 alone does)."""
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(_cfg("paligemma", sp=True), n_frontend_tokens=6)
    out = {}
    with make_mesh(MeshConfig(1, 1, 4), "cpu"):
        m = _build(cfg)
        params = m.init()
        for text in (10, 12):
            batch = m.dummy_batch(2, 6 + text,
                                  torch.Generator().manual_seed(0))
            out[text] = _catch(lambda: m.loss(params, batch))
    return out


def _run_rank(rank, world, tmp):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=world)
    with open(f"{tmp}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    res = {"grad": {}, "train": {}}
    try:
        for label, model, shape, sps in GRAD_CASES:
            if int(np.prod(shape)) != world:
                continue
            mesh = make_mesh(MeshConfig(*shape), "cpu")
            with mesh:
                for sp in sps:
                    res["grad"][(label, sp)] = dict(
                        _grad_case(model, sp, inputs["params"][_arch(model)],
                                   inputs["batch"][_arch(model)]),
                        coords=mesh.coords)
        for label, model, shape, comp, sp in TRAIN_CASES:
            if int(np.prod(shape)) == world:
                res["train"][label] = _train_case(rank, model, shape, comp,
                                                  sp, f"{tmp}/{label}")
        if world == 4:
            res["vlm_lengths"] = _vlm_lengths()
        if world == 2:
            # the 1x1x1 checkpoint of step 3 restored on 1x1x2, to step 4
            ck = f"{tmp}/restart-1x1x2"
            rc = _rc(RESTART[0], (1, 1, 2), RESTART[1])
            out = train(_build(rc.model), rc, _loop(ck, n_steps=STEPS + 1),
                        device="cpu", mesh=make_mesh(rc.mesh, "cpu"))
            res["restart"] = {"history": out["history"],
                              "state": _ckpt_leaves(ck) if rank == 0
                              else None}
            res["errors"] = _refusals()
            from repro_torch.launch.train import main
            res["cli"] = {arch: main(_cli_argv(arch) + ["--mesh", "1x1x2"])
                          ["history"] for arch in ARCHS}
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The references and the spawns
# ---------------------------------------------------------------------------
def _inputs():
    """The port's whole init (seed 0; the xLSTM's ``w_h`` rescaled) and
    the gradient batch of each arch, as numpy."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.data.synthetic import TokenStream
    params, batches = {}, {}
    for model in ("seamless", "paligemma", "xlstm"):
        cfg = _cfg(model)
        p = _build(cfg).init(torch.Generator().manual_seed(0))
        leaves, treedef = tree_flatten(p)
        params[_arch(model)] = tree_unflatten(treedef,
                                              [x.numpy() for x in leaves])
        b = TokenStream(cfg, seed=3).next_batch(GRAD_B, SEQ[_arch(model)])
        if "frames" in b:
            b["frames"] = np.random.default_rng(4).standard_normal(
                (GRAD_B, SRC, cfg.d_model)).astype(np.float32)
        b["weights"] = np.array([1.0, 0.5, 0.25, 1.0], np.float32)
        batches[_arch(model)] = b
    return {"params": params, "batch": batches}


def _jax_reference(model, params_np, batch_np):
    """JAX's loss and gradient leaves (sorted-key order) on the port's
    init."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import encdec as jed
    from repro.models import transformer as jtf
    jcfg = dataclasses.replace(jax_smoke_config(_arch(model)),
                               compute_dtype="float32")
    loss_fn = jed.loss if _family(model) == "seamless" else jtf.lm_loss
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: loss_fn(p, jcfg, jbatch), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_grads(model, params_np, batch_np):
    """The port's unsharded loss and gradient on the same parameters."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(_tensors(params_np))
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, _ = _build(_cfg(model)).loss(
        tree_unflatten(treedef, leaves),
        {k: torch.from_numpy(v) for k, v in batch_np.items()})
    return float(loss.detach()), [g.numpy() for g in
                                  torch.autograd.grad(loss, leaves)]


def _stacked(model, compression, ckpt_dir=None, n_steps=STEPS):
    from repro_torch.train.checkpoint import _flatten_with_paths
    from repro_torch.train.loop import train
    rc = _rc(model, (1, 1, 1), compression)
    out = train(_build(rc.model), rc, _loop(ckpt_dir, n_steps),
                device="cpu")
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
                          for arch in ARCHS}
        finally:
            out["w2"], out["w4"] = (_results(*s) for s in spawns)
        # the 1x1x2 checkpoint of step 3 restored on 1x1x1, to step 4
        ck = tmp_path_factory.mktemp("restart-1x1x1") / "ck"
        shutil.copytree(tmp2 / "xlstm-1x1x2-int8", ck)
        out["restart-1x1x1"] = _stacked(*RESTART, str(ck),
                                        n_steps=STEPS + 1)
        return out
    finally:
        torch.set_num_threads(threads)


def _ranks(ref, shape):
    return ref["w2"] if int(np.prod(shape)) == 2 else ref["w4"]


def _block(x, dim, n, m):
    """Rank ``m`` of ``n``'s block of the whole leaf ``x`` (numpy)."""
    from repro_torch.dist.tensor_parallel import ModelAxis, cut_leaf
    return cut_leaf(torch.from_numpy(np.array(x)), dim,
                    ModelAxis(None, n, m)).numpy()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", GRAD_PARAMS, ids=[
    f"{c[0]}-{'seq_parallel' if c[3] else 'plain'}" for c in GRAD_PARAMS])
def test_loss_and_gradient_match_jax_unsharded(ref, case):
    """Each rank's loss equals JAX's and the port's unsharded one; each
    leaf's gradient is its block of theirs (rtol 1e-5 of the leaf's
    largest element); a whole leaf's gradient is the same on every rank,
    bit for bit."""
    from repro_torch.dist.tensor_parallel import _leaf_paths
    label, model, shape, sp = case
    jloss, jgrads = ref["jax"][_arch(model)]
    ploss, pgrads = ref["port"][model]
    layout, dims = _model_dims(model, shape)
    names = _leaf_paths(layout.treedef)
    runs = [r["grad"][(label, sp)] for r in _ranks(ref, shape)]
    for got in runs:
        assert abs(got["loss"] - jloss) <= RTOL * abs(jloss)
        assert abs(got["loss"] - ploss) <= RTOL * abs(ploss)
        assert len(got["grads"]) == len(jgrads)
        m = got["coords"]["model"]
        for i, (g, jg, pg, dim) in enumerate(zip(got["grads"], jgrads,
                                                 pgrads, dims)):
            jb, pb = (_block(x, dim, shape[2], m) for x in (jg, pg))
            assert g.shape == jb.shape, (i, g.shape, jb.shape)
            assert float(np.abs(g - jb).max()) <= \
                RTOL * float(np.abs(jg).max()), names[i]
            assert float(np.abs(g - pb).max()) <= \
                RTOL * float(np.abs(pg).max()), names[i]
    whole = set()
    for i, dim in enumerate(dims):
        if dim is None:
            whole.add(names[i].rsplit("/", 1)[-1])
            for got in runs[1:]:
                np.testing.assert_array_equal(got["grads"][i],
                                              runs[0]["grads"][i])
    assert WHOLE[_family(model)] <= whole, whole


W2_SP = [c for c in GRAD_CASES if c[2] == (1, 1, 2) and True in c[3]]


@pytest.mark.parametrize("case", W2_SP, ids=[c[0] for c in W2_SP])
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
    plus one step of the other slot's push)."""
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
            prev = np.max([sw[k] for k in slots if k != key], axis=0)
            tol = 0.05 * np.abs(sw[key]) + prev / 127
            assert np.all(np.abs(sg[key] - sw[key]) <= tol), key


# the tags each family's census must hold beyond the blocks' own
FAMILY_TAGS = {"seamless": {"grad_leaves"},
               "paligemma": {"tp_param", "grad_leaves"},
               "xlstm": {"tp_norm", "tp_feat", "tp_param"}}


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
                           rank_batch // (N_MB // n_data), SEQ[_arch(model)],
                           N_MB // n_data, shape[2], comp, n_data=n_data)
    want = {k: STEPS * v for k, v in one.items()}
    assert FAMILY_TAGS[_family(model)] <= {t for t, _ in want}, want
    for r in _ranks(ref, shape):
        got = {(tag, dt): n for (axis, dt, tag), n in
               r["train"][label]["census"].items() if axis == "model"}
        assert got == want, (label, got, want)


@pytest.mark.parametrize("case", GRAD_PARAMS, ids=[
    f"{c[0]}-{'seq_parallel' if c[3] else 'plain'}" for c in GRAD_PARAMS])
def test_gradient_census_is_the_count_from_the_shapes(ref, case):
    """One forward and backward's ``model`` bytes (the blocks' tags, no
    step's bridges): ``model_axis_bytes`` of one microbatch of the
    gradient batch, the encoder-decoder with its two lengths."""
    from repro_torch.launch.wire_model import model_axis_bytes
    label, model, shape, sp = case
    layout, dims = _model_dims(model, shape)
    arch = _arch(model)
    src = SRC if _family(model) == "seamless" else None
    want = {k: v for k, v in model_axis_bytes(
        _cfg(model, sp), layout, dims, GRAD_B, SEQ[arch], 1, shape[2],
        src_seq=src).items() if k[0].startswith("tp_")}
    for r in _ranks(ref, shape):
        got = {(tag, dt): n for (axis, dt, tag), n in
               r["grad"][(label, sp)]["census"].items() if axis == "model"}
        assert got == want, (label, got, want)


@pytest.mark.parametrize("way", ["1x1x2-to-1x1x1", "1x1x1-to-1x1x2"])
def test_checkpoint_restores_across_the_model_axis(ref, way):
    """An xLSTM checkpoint of step 3 (the ``Segments`` leaves joined
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
@pytest.mark.parametrize("model", ["seamless", "paligemma", "xlstm"])
def test_decoding_and_serving_refuse_the_model_axis(ref, model, what):
    """Decoding and ``api.serve`` at ``model > 1``, refused here until
    the serve profile's layout was ported (ROADMAP A.11 part 2, item 6),
    now run on 1x1x2 (the xLSTM with ``seq_parallel=True``): one decode
    step on the rank's blocks, two engine steps (their parity is
    ``test_torch_tp_serve``'s)."""
    msg = ref["w2"][0]["errors"][(model, what)]
    assert msg is None, msg


@pytest.mark.parametrize("what, exc, text", [
    ("xlstm-sp", "NotImplementedError", "strict recurrence"),
    ("seamless-src", "ValueError", "15 tokens"),
])
def test_sequence_parallel_refusals(ref, what, exc, text):
    """The xLSTM's training forward refuses ``seq_parallel`` at ``model
    > 1`` (JAX places no boundary in its forward; building and init
    accept it, so the config serves); seamless's source must split as
    its target must."""
    msg = ref["w2"][0]["errors"][what]
    assert msg is not None and msg.startswith(exc) and text in msg, msg


def test_vlm_seq_parallel_splits_patches_and_text(ref):
    """paligemma with 6 patches on 1x1x4 under ``seq_parallel``: 10 text
    tokens run (16 positions split), 12 raise naming the 18 positions."""
    for r in ref["w4"]:
        got = r["vlm_lengths"]
        assert got[10] is None, got[10]
        assert got[12] is not None and got[12].startswith("ValueError") \
            and "18 tokens" in got[12], got[12]


@pytest.mark.parametrize("arch", ARCHS)
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


LM_ARCHS = ("qwen1.5-0.5b", "qwen3-1.7b", "yi-6b", "chatglm3-6b",
            "mixtral-8x7b", "mixtral-8x22b", "zamba2-2.7b",
            "seamless-m4t-large-v2", "paligemma-3b", "xlstm-125m")
# SMOKE widths that do not split over 4: mixtral-8x22b's 6 heads, the
# xLSTM's 2
SMOKE_4_REFUSED = ("mixtral-8x22b", "xlstm-125m")
GATE_CASES = [(a, full, n) for a in LM_ARCHS for full in (True, False)
              for n in (2, 4)]


@pytest.mark.parametrize("case", GATE_CASES, ids=[
    f"{a}-{'full' if full else 'smoke'}-{n}" for a, full, n in GATE_CASES])
def test_model_axis_gate_matrix(case):
    """``check_model_axis`` on every LM arch at FULL and SMOKE widths on
    model 2 and 4: accepted, but for SMOKE widths whose heads do not
    split over 4 (a ``ValueError``); under ``seq_parallel`` the xLSTM is
    refused (``NotImplementedError``) and every other arch accepted."""
    from repro_torch.dist.tensor_parallel import check_model_axis
    arch, full, n = case
    cfg = (get_config if full else get_smoke_config)(arch)
    if not full and n == 4 and arch in SMOKE_4_REFUSED:
        with pytest.raises(ValueError, match="whole heads"):
            check_model_axis(cfg, n)
        return
    check_model_axis(cfg, n)
    sp = dataclasses.replace(cfg, seq_parallel=True)
    if arch == "xlstm-125m":
        with pytest.raises(NotImplementedError, match="strict recurrence"):
            check_model_axis(sp, n)
    else:
        check_model_axis(sp, n)
    check_model_axis(sp, 1)


@pytest.mark.parametrize("full, n", [(True, 2), (True, 4), (False, 2)],
                         ids=["full-2", "full-4", "smoke-2"])
def test_xlstm_cut_against_jax_resolver(full, n):
    """The xLSTM's cut on model ``n``: the sLSTM FFN's odd width (1023 at
    FULL, 85 at SMOKE) leaves ``w_ff_gate``, ``w_ff_up`` and
    ``w_ff_down`` whole, as JAX's resolver leaves them; ``w_up`` and
    ``w_x`` are ``Segments`` of the rank's heads in every part; ``w_q``
    and the gate leaves cut their head columns; ``norm_scale`` and
    ``w_down`` keep JAX's block."""
    from repro.dist.sharding import spec_for as jax_spec_for
    from repro_torch.configs.base import MeshConfig as Mesh
    from repro_torch.dist.tensor_parallel import Segments, leaf_spec
    from repro_torch.models.api import build_model
    from repro_torch.models.xlstm import mlstm_dims
    cfg = (get_config if full else get_smoke_config)("xlstm-125m")
    m = build_model(cfg, device="cpu")
    shapes, axes = m.param_shapes(), m.param_axes()
    mesh = Mesh(1, 1, n)
    from repro.configs.base import MeshConfig as JMesh
    jmesh = JMesh(1, 1, n)
    d_ff = int(cfg.xlstm.proj_factor_slstm * cfg.d_model)
    assert d_ff % 2 == 1
    sl, ml = shapes["slstm_layers"]["slstm"], shapes["mlstm_layers"]["mlstm"]
    sla, mla = axes["slstm_layers"]["slstm"], axes["mlstm_layers"]["mlstm"]
    for name in ("w_ff_gate", "w_ff_up", "w_ff_down"):
        spec = leaf_spec(cfg, name, sl[name].shape, sla[name], mesh)
        assert tuple(spec) == ()
        jspec = jax_spec_for(sla[name], tuple(sl[name].shape), jmesh)
        assert "model" not in tuple(jspec), jspec
    d_in = mlstm_dims(cfg)[0]
    seg = leaf_spec(cfg, "w_up", ml["w_up"].shape, mla["w_up"], mesh)
    assert isinstance(seg, Segments) and [w for _, w, s in seg.local_parts(
        n)] == [d_in // n] * 2
    seg = leaf_spec(cfg, "w_x", sl["w_x"].shape, sla["w_x"], mesh)
    assert isinstance(seg, Segments) and [w for _, w, s in seg.local_parts(
        n)] == [cfg.d_model // n] * 4
    for name in ("w_q", "w_i", "w_f"):
        spec = leaf_spec(cfg, name, ml[name].shape, mla[name], mesh)
        assert tuple(spec) == (None, None, "model"), (name, spec)
    for name in ("norm_scale", "w_down"):
        spec = leaf_spec(cfg, name, ml[name].shape, mla[name], mesh)
        jspec = jax_spec_for(mla[name], tuple(ml[name].shape), jmesh)
        assert tuple(spec) == (None, "model") and jspec[1] == "model", name
