"""The LM slice against the JAX package: AMB-DG training of the DENSE
transformers (qwen1.5-0.5b SMOKE: MHA with QKV bias; qwen3-1.7b SMOKE:
GQA with qk-norm), tau = 2, two microbatches, pod compression none and
int8, through both packages' ``api.build``.

Both strategies start from the JAX init (carried across with
``convert.params_from_jax``) and step on the same ``AnytimePipeline``
batches (``TokenStream`` bytes equal). JAX's step runs eagerly, as in
the slice-2 tests: under ``jax.jit`` XLA:CPU moves some int8 row scales
by one ulp (ROADMAP C.4). Compute is float32 in both (the algorithm):
per step ``applied_count`` and ``local_count`` agree exactly, loss and
grad norm to rtol 1e-5 (f32 summation order); the final w and z to 1e-5
of their largest element, plus, under int8, one quantization step
(alpha * scale / count) per element, where a last-bit gradient
difference can flip one rounding (the grad norm likewise gets one
quantization step). Six steps: the first tau pushes land
at steps 3 and 4 (the gradient at the init, then at w = 0, which is
exactly 0), and step 5 applies the gradient taken at step 3's weights.

Also here: the port's ``train`` loop on an LM (it feeds ``seq_len``
from ``rc.shape``) equals the strategy driven by hand bit for bit, and
the two repairs of this slice leave the linear-regression path
unchanged bit for bit: ``accumulate_scan`` over nested trees and the
arena layout built from shapes on the meta device.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import base as jbase
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import AnytimePipeline as JaxPipeline
from repro.models.api import build_model as jax_build_model
from repro_torch import api, convert
from repro_torch.configs import base, get_smoke_config
from repro_torch.core import anytime, arena
from repro_torch.core.arena import tree_flatten
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.data.timing import ShiftedExponential
from repro_torch.models.api import build_model
from repro_torch.train.loop import LoopConfig, train

N_STEPS, N_WORKERS, SPW, SEQ = 6, 4, 2, 32


def _rc(cfgs, model_cfg, compression):
    return cfgs.RunConfig(
        model=model_cfg,
        shape=dataclasses.replace(cfgs.TRAIN_4K, seq_len=SEQ,
                                  global_batch=N_WORKERS * SPW),
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(tau=2, n_microbatches=2, b_bar=8.0,
                               smoothness_L=8.0,
                               pod_compression=compression))


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-1.7b"])
def test_lm_slice_matches_jax(arch, compression):
    jcfg = _f32(jax_smoke_config(arch))
    cfg = _f32(get_smoke_config(arch))
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
        for k in batch:   # the same TokenStream bytes and anytime weights
            np.testing.assert_array_equal(batch[k], jbatch[k])
        assert batch["tokens"].shape == (N_WORKERS * SPW, SEQ)
        jstate, jm = js.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        pstate, pm = ps.train_step(pstate, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        assert pm["applied_count"].item() == float(jm["applied_count"])
        assert (pm["applied_count"].item() == 0.0) == (t < 2)
        assert pm["local_count"].item() == float(jm["local_count"])
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        count = pm["applied_count"].item()
        q_now = 0.0
        if compression == "int8" and count:
            s_max = max(float(s.max()) for s in pstate.arena.scales)
            q_now = s_max / count
            q_step = max(q_step, q_now)
        # under int8 a flipped rounding moves the applied g, and so its
        # norm, by up to one quantization step
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   atol=q_now)
    # the step applied at t = 5 is a real gradient (taken at w != 0)
    assert float(jm["grad_norm"]) > 0.0
    jz = np.asarray(jstate.opt_state.z)
    z = pstate.opt_state.z.numpy()
    z_tol = 1e-5 * np.abs(jz).max() + (q_step if compression == "int8"
                                       else 0.0)
    np.testing.assert_allclose(z, jz, rtol=0, atol=z_tol)
    for w, jw in zip(tree_flatten(pstate.params)[0],
                     jax.tree.leaves(jstate.params)):
        jw = np.asarray(jw)
        assert np.all(np.isfinite(w.numpy()))
        # w = -alpha z with alpha < 1
        np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max() + z_tol)


def test_train_loop_on_an_lm_equals_the_strategy_driven_by_hand():
    """``train`` of qwen3-1.7b SMOKE (bf16 compute, int8, tau 2) gives
    the same metrics and final state, bit for bit, as the strategy
    stepped by hand on the pipeline's batches (seq_len from rc.shape)."""
    cfg = get_smoke_config("qwen3-1.7b")
    rc = _rc(base, cfg, "int8")
    loop = LoopConfig(n_steps=4, log_every=1, n_workers=N_WORKERS,
                      samples_per_worker=SPW)
    out = train(build_model(cfg, device="cpu"), rc, loop, device="cpu")
    s = api.build(build_model(cfg, device="cpu"), rc, device="cpu")
    state = s.init_state(torch.Generator().manual_seed(rc.seed))
    pipe = AnytimePipeline(cfg, N_WORKERS, SPW, seq_len=SEQ, seed=rc.seed,
                           timing=ShiftedExponential(), t_p=rc.ambdg.t_p)
    for t in range(loop.n_steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in pipe.next_global_batch().items()}
        state, m = s.train_step(state, batch)
        for k in ("loss", "applied_count", "local_count", "grad_norm"):
            assert out["history"][t][k] == float(m[k]), (t, k)
    for a, b in zip(tree_flatten(out["state"].params)[0],
                    tree_flatten(state.params)[0]):
        assert torch.equal(a, b)
    assert torch.equal(out["state"].opt_state.z, state.opt_state.z)


def _old_accumulate_scan(loss_fn, params, batch, n_mb):
    """``accumulate_scan`` as it stood before nested trees: flat names,
    a fresh sum per microbatch."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    at = dict(zip(names, leaves))

    def grads_of(mb):
        loss_sum, aux = loss_fn(at, mb)
        g = torch.autograd.grad(loss_sum, leaves)
        return ([x.to(torch.float32) for x in g], aux["count"].detach(),
                aux["loss_sum"].detach())

    if n_mb == 1:
        g, count, loss_sum = grads_of(batch)
        return dict(zip(names, g)), count, {"loss_sum": loss_sum}
    gsum = [torch.zeros(p.shape, dtype=torch.float32) for p in leaves]
    csum = torch.zeros((), dtype=torch.float32)
    lsum = torch.zeros((), dtype=torch.float32)
    for mb in anytime._split_batch(batch, n_mb):
        g, count, loss_sum = grads_of(mb)
        gsum = [a + b for a, b in zip(gsum, g)]
        csum = csum + count
        lsum = lsum + loss_sum
    return dict(zip(names, gsum)), csum, {"loss_sum": lsum}


@pytest.mark.parametrize("n_mb", [1, 4])
def test_accumulate_scan_on_linreg_unchanged_bitwise(n_mb):
    from repro_torch.data.synthetic import LinRegStream
    cfg = get_smoke_config("amb-linreg")
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(
        rng.standard_normal(cfg.linreg_dim).astype(np.float32))}
    batch = {k: torch.from_numpy(v) for k, v in
             LinRegStream(cfg.linreg_dim, seed=2).next_batch(64).items()}
    batch["weights"][::3] = 0.0
    got = anytime.accumulate_scan(model.loss, params, batch, n_mb)
    want = _old_accumulate_scan(model.loss, params, batch, n_mb)
    assert list(got[0]) == list(want[0]) == ["w"]
    assert torch.equal(got[0]["w"], want[0]["w"])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2]["loss_sum"], want[2]["loss_sum"])


def test_layout_from_meta_shapes_on_linreg_unchanged():
    """The step factory builds the arena layout from the meta device;
    on the linear regression it is the layout of the real parameters,
    and the strategy's run equals one on a layout built from them."""
    cfg = get_smoke_config("amb-linreg")
    model = build_model(cfg, device="cpu")
    meta, real = model.param_shapes(), model.init(None)
    assert meta["w"].device.type == "meta"
    a, b = arena.make_layout(meta), arena.make_layout(real)
    for f in ("shapes", "dtypes", "sizes", "row_counts", "row_offsets",
              "rows", "n_leaves"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.row_to_leaf, b.row_to_leaf)
    rc = base.RunConfig(
        model=cfg, shape=base.TRAIN_4K, mesh=base.MeshConfig(1, 1, 1),
        ambdg=base.AmbdgConfig(tau=2, b_bar=800.0, proximal="l2_ball",
                               radius_C=1.05 * math.sqrt(cfg.linreg_dim),
                               pod_compression="int8"))
    loop = LoopConfig(n_steps=5, log_every=1, n_workers=4,
                      samples_per_worker=8)
    out = train(model, rc, loop, device="cpu")
    # the same run with the layout taken from the real parameters
    real_model = dataclasses.replace(model, init_fn=lambda dev, g=None:
                                     model.init_fn(torch.device("cpu"), g))
    ref = train(real_model, rc, loop, device="cpu")
    for h, r in zip(out["history"], ref["history"]):
        for k in ("loss", "applied_count", "grad_norm"):
            assert h[k] == r[k]
    assert torch.equal(out["state"].params["w"], ref["state"].params["w"])


def test_convert_carries_the_lm_state_bitwise():
    """``convert`` needs nothing new for the LM: JAX runs three steps of
    qwen1.5-0.5b SMOKE (its 14-leaf tree), the whole state is carried
    across, the port's layout equals JAX's row for row, the carried
    params flatten to JAX's arena bit for bit, and one master update
    each from the same pod-stacked gradients (int8, l2 prox) gives the
    same master state bit for bit."""
    from repro.core import ambdg as jambdg
    from repro.core import arena as jarena
    from repro.optim import make_arena_optimizer as jax_arena_optimizer
    from repro_torch.core import ambdg
    from repro_torch.optim import make_arena_optimizer
    jcfg = jax_smoke_config("qwen1.5-0.5b")
    cfg = get_smoke_config("qwen1.5-0.5b")
    jrc, rc = _rc(jbase, jcfg, "int8"), _rc(base, cfg, "int8")
    js = japi.build(jax_build_model(jcfg), jrc)
    jstate = js.init_state(jax.random.PRNGKey(0))
    jpipe = JaxPipeline(jcfg, N_WORKERS, SPW, seq_len=SEQ, seed=0)
    for _ in range(3):
        jstate, _ = js.train_step(jstate, {
            k: jnp.asarray(v) for k, v in jpipe.next_global_batch().items()})
    jstate = jax.device_get(jstate)
    pstate = convert.train_state_from_jax(jstate, device="cpu")
    leaves, _ = tree_flatten(pstate.params)
    assert len(leaves) == 14
    jlayout = jarena.make_layout(jstate.params)
    layout = arena.make_layout(build_model(cfg, device="cpu").param_shapes())
    assert layout.row_offsets == tuple(jlayout.row_offsets)
    assert layout.rows == jlayout.rows
    np.testing.assert_array_equal(
        arena.flatten_tree(layout, pstate.params).numpy(),
        np.asarray(jarena.flatten_tree(jlayout, jax.tree.map(
            jnp.asarray, jstate.params))))
    rng = np.random.default_rng(5)
    grads = [(rng.standard_normal((1,) + tuple(x.shape)) * 3).astype(
        np.float32) for x in leaves]
    counts = np.array([93.0], np.float32)
    jgrads = jax.tree.unflatten(jax.tree.structure(jstate.params),
                                [jnp.asarray(g) for g in grads])
    pgrads = arena.tree_unflatten(tree_flatten(pstate.params)[1],
                                  [torch.from_numpy(g) for g in grads])
    jrc_l2 = jrc.replace(ambdg=dataclasses.replace(jrc.ambdg, proximal="l2"))
    rc_l2 = rc.replace(ambdg=dataclasses.replace(rc.ambdg, proximal="l2"))
    jstate = jax.tree.map(jnp.asarray, jstate)
    jout = jambdg.arena_master_update(
        jlayout, jax_arena_optimizer(jrc_l2, jlayout), jstate.params,
        jstate.opt_state, jstate.arena, jgrads, jnp.asarray(counts), "int8")
    pout = ambdg.arena_master_update(
        layout, make_arena_optimizer(rc_l2, layout, torch.device("cpu")),
        pstate.params, pstate.opt_state, pstate.arena, pgrads,
        torch.from_numpy(counts), "int8")
    (jp, jo, ja, jg, jc), (pp, po, pa, pg, pc) = jout, pout
    eq = np.testing.assert_array_equal
    for a, b in zip(tree_flatten(pp)[0], jax.tree.leaves(jp)):
        eq(a.numpy(), np.asarray(b))
    eq(po.z.numpy(), np.asarray(jo.z))
    eq(pg.numpy(), np.asarray(jg))
    assert pc.item() == float(jc)
    for a, b in zip(pa.ring, ja.ring):
        eq(a.numpy(), np.asarray(b))
    eq(pa.residual.numpy(), np.asarray(ja.residual))
