"""The hybrid slice against the JAX package: zamba2 (Mamba2 layers with
one shared attention + MLP block after every ``shared_attn_every``
layers) on its SMOKE config, the model alone and AMB-DG training
through both packages' ``api.build``.

The JAX weights are carried across with ``convert.params_from_jax`` and
both sides see the same numpy-seeded tokens, 45 a sequence (the SMOKE
chunk is 32: the Mamba2 layers pad 19 steps). The port runs both scan
routes: ``scan_impl="xla"`` (``ssd_chunked``, what the JAX model
computes) and ``"kernel"`` (on CPU tensors the plain recurrence through
``LinearScanTrain``).

Tolerances, relative to the largest magnitude of the tensor compared:
  * f32 compute: loss 1e-5; gradient leaves 1e-5, those of the decay
    parameters (a_log, dt_bias: sums over every step through the running
    log-decay, in another order in each framework) 5e-5;
  * bf16 compute: each gradient leaf within 0.15 of the JAX f32
    gradient (JAX's own bf16 gradient reads up to 0.14 from it on this
    input: bf16 keeps 8 bits and both frameworks round at other places)
    and the loss within 2e-3.
Training runs in f32 as in ``test_torch_lm_slice.py``: counts exact,
loss and grad norm to rtol 1e-5, w and z to 1e-5 of their largest
element plus one int8 quantization step where int8 is on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import base as jbase
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import arena as jarena
from repro.data.pipeline import AnytimePipeline as JaxPipeline
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro_torch import api, convert
from repro_torch.configs import base, get_config, get_smoke_config
from repro_torch.core import arena
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model
from repro_torch.train.loop import LoopConfig, train

ARCH = "zamba2-2.7b"
SEQ = 45
DECAY_LEAVES = ("['layers']['mamba']['a_log']",
                "['layers']['mamba']['dt_bias']")


def _rel(got, want):
    got = np.asarray(got.detach().to(torch.float32).numpy()
                     if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _batch():
    rng = np.random.default_rng(3)
    return {"tokens": rng.integers(0, 256, (2, SEQ)).astype(np.int32),
            "weights": np.array([1.0, 0.5], np.float32)}


def _jax_value_and_grad(jparams, dtype, jbatch):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), compute_dtype=dtype)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jbatch), has_aux=True)(jparams)
    return float(loss), float(aux["count"]), grads


@pytest.mark.parametrize("scan_impl", ["xla", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype, scan_impl):
    jparams, _ = jtf.init(jax.random.PRNGKey(0), jax_smoke_config(ARCH))
    params = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dtype,
                              scan_impl=scan_impl)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the f32 JAX gradient is the reference of both compute dtypes
    jloss, jcount, jgrads = _jax_value_and_grad(jparams, "float32", jbatch)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    leaves, treedef = tree_flatten(params)
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, aux = tf.lm_loss(tree_unflatten(treedef, leaves), cfg,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert aux["count"].item() == jcount == 1.5 * (SEQ - 1)
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == len(names) == 21
    if dtype == "float32":
        assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
        for name, g, jg in zip(names, grads, jax.tree.leaves(jgrads)):
            assert g.dtype == torch.float32 and g.shape == jg.shape, name
            tol = 5e-5 if name in DECAY_LEAVES else 1e-5
            assert _rel(g, jg) <= tol, (name, _rel(g, jg))
        return
    jloss16, _, _ = _jax_value_and_grad(jparams, "bfloat16", jbatch)
    assert abs(loss.item() - jloss16) <= 2e-3 * abs(jloss16)
    for name, g, jg in zip(names, grads, jax.tree.leaves(jgrads)):
        assert torch.isfinite(g).all(), name
        assert _rel(g, jg) <= 0.15, (name, _rel(g, jg))


def test_init_tree_and_arena_layout_match_jax():
    """JAX's leaf names, shapes and dtypes (the stacked Mamba2 layers and
    the nested shared block), ``make_layout`` from the meta device giving
    JAX's row offsets, ones and zeros where JAX has them."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jparams, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    shapes = model.param_shapes()
    jl = jax.tree_util.tree_flatten_with_path(jparams)[0]
    leaves, metas = tree_flatten(params)[0], tree_flatten(shapes)[0]
    assert len(leaves) == len(metas) == len(jl) == 21
    for (path, j), p, m in zip(jl, leaves, metas):
        name = jax.tree_util.keystr(path)
        assert tuple(p.shape) == tuple(m.shape) == j.shape, name
        assert p.dtype == m.dtype == torch.float32, name
        assert m.device.type == "meta"
        j = np.asarray(j)
        if np.all(j == 1.0) or np.all(j == 0.0):
            np.testing.assert_array_equal(p.numpy(), j, err_msg=name)
    jlay, lay = jarena.make_layout(jparams), arena.make_layout(shapes)
    assert lay.row_offsets == tuple(jlay.row_offsets)
    assert lay.rows == jlay.rows and lay.shapes == tuple(jlay.shapes)


def test_convert_carries_the_hybrid_tree_exactly():
    """``params_from_jax`` on the HYBRID tree: the same nested keys (the
    shared block a child of its own), every leaf bit for bit."""
    jparams, _ = jtf.init(jax.random.PRNGKey(1), jax_smoke_config(ARCH))
    host = jax.device_get(jparams)
    params = convert.params_from_jax(host, device="cpu")
    assert sorted(params["shared_attn"]) == ["attn", "ln1", "ln2", "mlp"]
    assert sorted(params["layers"]["mamba"]) == sorted(host["layers"]["mamba"])
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(host)[0],
                            tree_flatten(params)[0]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("n_layers", [None, 36, 6])
def test_n_params_and_full_width_layout_match_jax(n_layers):
    """FULL (2,422,520,768 parameters), the 36-layer cut the card trains
    and one group of 6: the port's analytic count is JAX's, and the
    meta-device tree sums to it plus the conv and dt biases, which the
    analytic count leaves out (in both packages)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    assert cfg.n_params() == jcfg.n_params()
    if n_layers is None:
        assert cfg.n_params() == 2_422_520_768
    shapes = build_model(cfg, device="cpu").param_shapes()
    leaves, _ = tree_flatten(shapes)
    assert all(x.device.type == "meta" for x in leaves)
    s = cfg.ssm
    biases = cfg.n_layers * (s.expand * cfg.d_model + 2 * s.d_state
                             + s.expand * cfg.d_model // s.head_dim)
    # one ln per layer where the count has two
    assert (sum(x.numel() for x in leaves)
            == cfg.n_params() + biases - cfg.n_layers * cfg.d_model)


N_STEPS, N_WORKERS, SPW = 6, 4, 2


def _rc(cfgs, model_cfg, compression):
    return cfgs.RunConfig(
        model=model_cfg,
        shape=dataclasses.replace(cfgs.TRAIN_4K, seq_len=SEQ,
                                  global_batch=N_WORKERS * SPW),
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(tau=2, n_microbatches=2, b_bar=8.0,
                               smoothness_L=8.0,
                               pod_compression=compression))


@pytest.mark.parametrize("compression,scan_impl", [
    ("none", "xla"), ("int8", "kernel")])
def test_hybrid_slice_matches_jax(compression, scan_impl):
    """AMB-DG, tau 2, two microbatches, f32, from JAX's init: per step
    the counts exactly, loss and grad norm to rtol 1e-5; the final z
    and w leaf by leaf. The first, empty pop sets w = 0, where the
    gradient is 0; the init's gradient lands at step 2, and step 5
    applies the gradient taken at step 3's weights."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(ARCH),
                              compute_dtype="float32", scan_impl=scan_impl)
    js = japi.build(jax_build_model(jcfg), _rc(jbase, jcfg, compression))
    ps = api.build(build_model(cfg, device="cpu"),
                   _rc(base, cfg, compression), device="cpu")
    jstate = js.init_state(jax.random.PRNGKey(0))
    pstate = ps.init_state(torch.Generator().manual_seed(0))
    pstate = pstate._replace(params=convert.params_from_jax(
        jax.device_get(jstate.params), device="cpu"))
    jpipe = JaxPipeline(jcfg, N_WORKERS, SPW, seq_len=SEQ, seed=0)
    pipe = AnytimePipeline(cfg, N_WORKERS, SPW, seq_len=SEQ, seed=0)
    q_step = 0.0
    for t in range(N_STEPS):
        batch, jbatch = pipe.next_global_batch(), jpipe.next_global_batch()
        for k in batch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
        jstate, jm = js.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        pstate, pm = ps.train_step(pstate, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        assert pm["applied_count"].item() == float(jm["applied_count"])
        assert (pm["applied_count"].item() == 0.0) == (t < 2)
        assert pm["local_count"].item() == float(jm["local_count"])
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        count, q_now = pm["applied_count"].item(), 0.0
        if compression == "int8" and count:
            q_now = max(float(s.max()) for s in pstate.arena.scales) / count
            q_step = max(q_step, q_now)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   atol=q_now)
    assert float(jm["grad_norm"]) > 0.0
    jz = np.asarray(jstate.opt_state.z)
    z_tol = 1e-5 * np.abs(jz).max() + q_step
    np.testing.assert_allclose(pstate.opt_state.z.numpy(), jz, rtol=0,
                               atol=z_tol)
    for w, jw in zip(tree_flatten(pstate.params)[0],
                     jax.tree.leaves(jstate.params)):
        jw = np.asarray(jw)
        assert np.all(np.isfinite(w.numpy()))
        np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max() + z_tol)


def test_train_loop_runs_the_hybrid_on_both_routes():
    """``train`` of zamba2 SMOKE (bf16 compute, int8, tau 2) on the CPU
    with each scan route: the same counts, finite losses that agree at
    the bf16 level, and w inside the l2 ball."""
    out = {}
    for scan_impl in ("xla", "kernel"):
        cfg = dataclasses.replace(get_smoke_config(ARCH), scan_impl=scan_impl)
        rc = _rc(base, cfg, "int8")
        rc = rc.replace(ambdg=dataclasses.replace(
            rc.ambdg, proximal="l2_ball", radius_C=10.0))
        out[scan_impl] = train(build_model(cfg, device="cpu"), rc,
                               LoopConfig(n_steps=3, log_every=1,
                                          n_workers=N_WORKERS,
                                          samples_per_worker=SPW),
                               device="cpu")
    for a, b in zip(out["xla"]["history"], out["kernel"]["history"]):
        assert a["applied_count"] == b["applied_count"]
        assert a["local_count"] == b["local_count"] == 8 * (SEQ - 1)
        assert np.isfinite(a["loss"]) and np.isfinite(b["loss"])
        assert abs(a["loss"] - b["loss"]) <= 2e-3 * abs(a["loss"])
    for run in out.values():
        norm = float(torch.sqrt(sum(torch.sum(x.double() ** 2) for x in
                                    tree_flatten(run["state"].params)[0])))
        assert norm <= 10.0 * (1 + 1e-5)
