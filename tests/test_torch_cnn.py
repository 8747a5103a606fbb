"""The paper's CNN (Sec. VI-B, Fig. 5) in the port against the JAX
package, on the CPU, with JAX's parameters carried across by
``convert.params_from_jax``.

Tolerances (f32): the logits to 1e-5 of their largest element and the
loss to rtol 1e-5; each gradient leaf to 2e-5 of that leaf's largest
element (read: at most 2e-6 on SMOKE: XLA's and PyTorch's convolutions
sum in different orders). ``acc_sum`` and ``count`` are exact. A 2x2
max-pool window with a tie may route its gradient to a different element
in each framework; after the ReLU a tie at 0 carries a zero gradient in
both, and the seeded normal inputs give no positive tie, so the limit
above holds for the pooled layers too. The training step and the
simulator are held at the same limits as the linear regression's
(``tests/test_torch_slice.py``, ``tests/test_torch_sim.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.sim as jsim
from repro.configs import base as jbase
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import synthetic as jsynth
from repro.data.timing import ShiftedExponential as JaxTiming
from repro.models import cnn as jcnn
from repro.models.api import build_model as jax_build_model
from repro_torch import api, convert, sim
from repro_torch.configs import base, get_config, get_smoke_config
from repro_torch.data import synthetic
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.data.timing import ShiftedExponential
from repro_torch.models import cnn
from repro_torch.models.api import build_model
from repro_torch.train.loop import LoopConfig, train

GRAD_TOL = 2e-5


def _jax_params(cfg, seed=0):
    params, _ = jcnn.init(jax.random.PRNGKey(seed), cfg)
    return params


def _batch(n, seed=1, cursor=0, masked=3):
    stream = jsynth.ImageClassStream(16, 10, seed=seed)
    for _ in range(cursor + 1):
        b = stream.next_batch(n)
    b["weights"][n - masked:] = 0.0
    return b


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
def test_param_counts_pin_jax(which):
    """``n_params`` is JAX's analytic count ("6 conv + 3 fc": 3,310,026
    at FULL, 1,737,162 at SMOKE), which is not the net both packages
    build: 9 convs and 5 fc, 6,805,642 leaves at FULL (ROADMAP C.10).
    The port's leaves have JAX's names, shapes and total."""
    get, jget = ((get_config, jax_config) if which == "FULL"
                 else (get_smoke_config, jax_smoke_config))
    cfg, jcfg = get("amb-cnn"), jget("amb-cnn")
    want = {"FULL": 3_310_026, "SMOKE": 1_737_162}[which]
    assert cfg.n_params() == jcfg.n_params() == want
    shapes = build_model(cfg, device="cpu").param_shapes()
    jshapes = jax.eval_shape(lambda k: jcnn.init(k, jcfg)[0],
                             jax.random.PRNGKey(0))
    assert sorted(shapes) == sorted(jshapes)
    for k, v in shapes.items():
        assert tuple(v.shape) == tuple(jshapes[k].shape), k
        assert v.dtype == torch.float32
    total = sum(v.numel() for v in shapes.values())
    assert total == sum(int(np.prod(v.shape)) for v in jshapes.values())
    if which == "FULL":
        assert total == 6_805_642
        assert sum(v.numel() for k, v in shapes.items()
                   if k.startswith("conv")) == 1_920_000


def test_init_draws_he_and_fan_in_scales():
    """The port draws its own weights (a CPU generator, as every model
    of the port) with JAX's distributions: He-scaled convs, 1/sqrt(fan
    in) fc, zero biases; the same on a second build from one seed."""
    cfg = get_smoke_config("amb-cnn")
    model = build_model(cfg, device="cpu")
    p = model.init(torch.Generator().manual_seed(3))
    q = model.init(torch.Generator().manual_seed(3))
    for k in p:
        assert torch.equal(p[k], q[k]), k
        if k.endswith("_b"):
            assert not p[k].any(), k
    std = float(p["conv3_w"].std())
    assert abs(std - math.sqrt(2.0 / (9 * 64))) < 0.05 * std
    std = float(p["fc1_w"].std())
    assert abs(std - 1 / math.sqrt(1024)) < 0.05 * std


@pytest.mark.parametrize("seed,n", [(0, 4), (5, 33)])
def test_image_stream_is_jax_bitwise(seed, n):
    port = synthetic.ImageClassStream(16, 10, seed=seed, sample_seed=seed + 7)
    ref = jsynth.ImageClassStream(16, 10, seed=seed, sample_seed=seed + 7)
    np.testing.assert_array_equal(port.prototypes, ref.prototypes)
    for _ in range(3):
        a, b = port.next_batch(n), ref.next_batch(n)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    state = port.state_dict()
    again = synthetic.ImageClassStream(16, 10, seed=seed,
                                       sample_seed=seed + 7)
    again.load_state_dict(state)
    a, b = again.next_batch(n), ref.next_batch(n)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    cfg = get_smoke_config("amb-cnn")
    assert isinstance(synthetic.make_stream(cfg, seed),
                      synthetic.ImageClassStream)


def test_pipeline_emits_jax_image_batches():
    from repro.data.pipeline import AnytimePipeline as JaxPipeline
    cfg, jcfg = get_smoke_config("amb-cnn"), jax_smoke_config("amb-cnn")
    port = AnytimePipeline(cfg, 3, 8, seed=2, timing=ShiftedExponential(b=6))
    ref = JaxPipeline(jcfg, 3, 8, seed=2, timing=JaxTiming(b=6))
    for _ in range(3):
        a, b = port.next_global_batch(), ref.next_global_batch()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    state = port.state_dict()
    fresh = AnytimePipeline(cfg, 3, 8, seed=2, timing=ShiftedExponential(b=6))
    fresh.load_state_dict(state)
    a, b = fresh.next_global_batch(), ref.next_global_batch()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_forward_loss_and_gradient_match_jax():
    cfg, jcfg = get_smoke_config("amb-cnn"), jax_smoke_config("amb-cnn")
    jp = _jax_params(jcfg)
    pp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    b = _batch(16)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    lj = np.asarray(jcnn.forward(jp, jcfg, bj["images"]))
    lp = cnn.forward(pp, cfg, bt["images"]).numpy()
    assert lp.shape == (16, 10)
    np.testing.assert_allclose(lp, lj, rtol=0, atol=1e-5 * np.abs(lj).max())
    (sj, auxj), gj = jax.value_and_grad(
        lambda p: jcnn.loss(p, jcfg, bj), has_aux=True)(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    sp, auxp = cnn.loss(leaves, cfg, bt)
    gp = dict(zip(leaves, torch.autograd.grad(sp, list(leaves.values()))))
    sp = sp.detach()
    assert math.isclose(float(sp), float(sj), rel_tol=1e-5)
    assert float(auxp["count"]) == float(auxj["count"]) == 13.0
    assert float(auxp["acc_sum"]) == float(auxj["acc_sum"])
    assert float(auxp["loss_sum"].detach()) == float(sp)
    for k, g in gp.items():
        want = np.asarray(gj[k])
        assert g.shape == want.shape, k
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=k)


def test_dummy_batch_and_default_weights():
    cfg = get_smoke_config("amb-cnn")
    model = build_model(cfg, device="cpu")
    b = model.dummy_batch(6, 0, torch.Generator().manual_seed(0))
    assert b["images"].shape == (6, 16, 16, 3)
    assert b["labels"].dtype == torch.int32 and int(b["labels"].max()) < 10
    params = model.init()
    full, aux = model.loss(params, b)
    b.pop("weights")
    again, aux2 = model.loss(params, b)
    assert float(full) == float(again) and float(aux2["count"]) == 6.0


def _rc(cfgs, model_cfg, strategy, compression="none", n_mb=2):
    return cfgs.RunConfig(
        model=model_cfg, shape=cfgs.TRAIN_4K,
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(t_p=10.0, t_c=10.0, tau=1, smoothness_L=4.0,
                               b_bar=240.0, n_microbatches=n_mb,
                               pod_compression=compression),
        strategy=strategy)


@pytest.mark.parametrize("strategy,compression", [
    ("amb", "none"), ("ambdg", "int8")])
def test_train_step_matches_jax(strategy, compression):
    """The AMB-DG (tau 1, int8) and AMB steps on SMOKE from JAX's state
    carried across, 3 steps of 2 workers x 8 images, JAX run eagerly:
    applied counts exact; loss and grad norm to rtol 1e-4, every weight
    to 1e-4 of its leaf's largest element plus one int8 quantization
    step (``tests/test_torch_slice.py``'s limits)."""
    cfg, jcfg = get_smoke_config("amb-cnn"), jax_smoke_config("amb-cnn")
    jrc, prc = (_rc(jbase, jcfg, strategy, compression),
                _rc(base, cfg, strategy, compression))
    js = japi.build(jax_build_model(jcfg), jrc)
    ps = api.build(build_model(cfg, device="cpu"), prc, device="cpu")
    jstate = js.init_state(jax.random.PRNGKey(0))
    pstate = convert.train_state_from_jax(jax.device_get(jstate),
                                          device="cpu")
    pipe = AnytimePipeline(cfg, 2, 8, seed=4, timing=ShiftedExponential(b=6))
    for t in range(3):
        b = pipe.next_global_batch()
        jstate, jm = js.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        pstate, pm = ps.train_step(pstate, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        assert pm["applied_count"].item() == float(jm["applied_count"]), t
        for k in ("loss", "grad_norm"):
            assert math.isclose(pm[k].item(), float(jm[k]), rel_tol=1e-4), \
                (t, k)
    step = 0.0
    if compression == "int8":
        step = max(float(s.max()) for s in pstate.arena.scales) / 8.0
    for k, w in pstate.params.items():
        want = np.asarray(jstate.params[k])
        np.testing.assert_allclose(w.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + step,
                                   err_msg=k)


def test_train_runs_full_width_on_the_cpu():
    """``train`` of amb-cnn FULL (32x32x3, 6,805,642 parameters): 2 steps
    of 2 workers x 2 images, finite, the second applies the first's
    samples (tau 1)."""
    cfg = get_config("amb-cnn")
    out = train(build_model(cfg, device="cpu"),
                _rc(base, cfg, "ambdg", n_mb=1),
                LoopConfig(n_steps=2, n_workers=2, samples_per_worker=2,
                           log_every=1, use_timing_model=False),
                device="cpu")
    h = out["history"]
    assert [x["applied_count"] for x in h] == [0.0, 4.0]
    assert all(math.isfinite(x["loss"]) for x in h)
    assert math.isclose(h[0]["loss"], math.log(10), rel_tol=0.5)


@pytest.mark.parametrize("scheme", ["ambdg", "kbatch"])
def test_simulator_runs_the_cnn_as_jax(scheme):
    """Fig. 5's two schemes on SMOKE (2 workers, b_max 8, 60 simulated
    s, JAX's init carried across): the bookkeeping equals JAX's exactly,
    ``final_params`` to 1e-4 of each leaf's largest element, and the
    error column is NaN (the CNN has no Err(t))."""
    cfg, jcfg = get_smoke_config("amb-cnn"), jax_smoke_config("amb-cnn")
    opt = dict(t_p=10.0, t_c=10.0, tau=1, smoothness_L=4.0, b_bar=16.0)
    kw = dict(t_c=10.0, total_time=60.0, rng_seed=1)
    if scheme == "ambdg":
        kw["t_p"] = 10.0
    else:
        kw.update(b_per_msg=4, K=2)
    jp = jsim.SimProblem(jcfg, 2, seed=0, b_max=8)
    pp = sim.SimProblem(cfg, 2, seed=0, b_max=8, device="cpu")
    pp.params0 = convert.params_from_jax(jax.device_get(jp.params0),
                                         device="cpu")
    jt = japi.simulate(scheme, jp, timing=JaxTiming(lam=2 / 3, xi=4.0, b=2),
                       opt_cfg=jbase.AmbdgConfig(**opt), **kw)
    pt = api.simulate(scheme, pp, timing=ShiftedExponential(lam=2 / 3,
                                                            xi=4.0, b=2),
                      opt_cfg=base.AmbdgConfig(**opt), **kw)
    assert len(pt.times) == len(jt.times) > 1
    assert pt.times == jt.times and pt.staleness == jt.staleness
    assert pt.minibatches == jt.minibatches and pt.clamps == jt.clamps
    assert all(math.isnan(e) for e in pt.errors)
    for k, w in pt.final_params.items():
        want = np.asarray(jt.final_params[k])
        np.testing.assert_allclose(w.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
