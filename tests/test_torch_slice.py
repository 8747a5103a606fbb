"""The whole slice against the JAX package: AMB-DG (tau = 2) and
synchronous AMB training of ``amb-linreg`` SMOKE (d = 128), compression
none and int8, fed the same numpy-seeded ``AnytimePipeline`` batches.

Per step ``applied_count`` agrees exactly. ``loss``, ``grad_norm`` and
the final ``w`` agree within tolerances stated below: the two
frameworks' matmuls sum in different orders, so the gradients differ in
their last bits, and none of these can be bitwise. Under int8 such a
difference can flip one element's rounding, moving it by one
quantization step.

The ``convert`` round trip is bitwise: JAX runs k steps, its state is
carried into the port, and one master update each from the same
pod-stacked gradients gives the same master state bit for bit. The same
holds on the delay-tolerant ring (layout v3, a stochastic delay).

A stochastic delay (jitter, heavy_tail, bursty) runs through both
packages' ``train`` from one ``RunConfig``: per step ``applied_count``
and ``tau_applied`` agree exactly (the delay sequences are equal and
the counts are sums of small integers), loss, grad norm and w within
the tolerances above.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import base as jbase
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import ambdg as jambdg
from repro.data.pipeline import AnytimePipeline as JaxPipeline
from repro.data.timing import ShiftedExponential as JaxTiming
from repro.models.api import build_model as jax_build_model
from repro.optim import make_arena_optimizer as jax_arena_optimizer
from repro.train.loop import LoopConfig as JaxLoopConfig
from repro.train.loop import train as jax_train
from repro_torch import api, convert
from repro_torch.configs import base
from repro_torch.configs import get_smoke_config
from repro_torch.core import ambdg
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.data.timing import ShiftedExponential
from repro_torch.models.api import build_model
from repro_torch.optim import make_arena_optimizer
from repro_torch.train.loop import LoopConfig, train

N_STEPS, N_WORKERS, SPW = 8, 8, 16


def _rc(cfgs, model_cfg, strategy, compression, proximal="l2_ball",
        delay=None):
    d = model_cfg.linreg_dim
    extra = {} if delay is None else {"delay": cfgs.DelayConfig(**delay)}
    return cfgs.RunConfig(
        model=model_cfg, shape=cfgs.TRAIN_4K,
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(t_p=2.5, t_c=10.0, tau=2, smoothness_L=1.0,
                               b_bar=800.0, proximal=proximal,
                               radius_C=1.05 * math.sqrt(d),
                               pod_compression=compression),
        strategy=strategy, **extra)


def _pipelines(seed=0):
    port = AnytimePipeline(get_smoke_config("amb-linreg"), N_WORKERS, SPW,
                           seed=seed, timing=ShiftedExponential())
    ref = JaxPipeline(jax_smoke_config("amb-linreg"), N_WORKERS, SPW,
                      seed=seed, timing=JaxTiming())
    return port, ref


def _batches(n):
    port, ref = _pipelines()
    out = []
    for _ in range(n):
        b, bj = port.next_global_batch(), ref.next_global_batch()
        for k in b:   # the port's data stream is byte-identical
            np.testing.assert_array_equal(b[k], bj[k])
        out.append(b)
    return out


def _jax_strategy(strategy, compression, proximal="l2_ball", delay=None):
    rc = _rc(jbase, jax_smoke_config("amb-linreg"), strategy, compression,
             proximal, delay)
    s = japi.build(jax_build_model(rc.model), rc)
    return s, rc


def _port_strategy(strategy, compression, proximal="l2_ball", delay=None):
    rc = _rc(base, get_smoke_config("amb-linreg"), strategy, compression,
             proximal, delay)
    return api.build(build_model(rc.model, device="cpu"), rc,
                     device="cpu"), rc


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("strategy", ["ambdg", "amb"])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_slice_matches_jax(strategy, compression):
    js, _ = _jax_strategy(strategy, compression)
    ps, rc = _port_strategy(strategy, compression)
    jstep = jax.jit(js.train_step, donate_argnums=(0,))
    jstate = js.init_state(jax.random.PRNGKey(0))
    pstate = ps.init_state()
    tau = 2 if strategy == "ambdg" else 0
    q_step = 0.0   # largest quantization step of an applied g = g_sum/count
    for t, batch in enumerate(_batches(N_STEPS)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        pstate, pm = ps.train_step(pstate, _to_torch(batch))
        assert pm["applied_count"].item() == float(jm["applied_count"])
        if t < tau:
            assert pm["applied_count"].item() == 0.0
        assert pm["local_count"].item() == float(jm["local_count"])
        assert int(pm["step"]) == int(jm["step"]) == t + 1
        # loss: the same data at parameters that agree to float32
        # rounding (see w below)
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
        count = pm["applied_count"].item()
        if compression == "int8" and pstate.arena is not None and count:
            s_max = max(float(s.max()) for s in pstate.arena.scales)
            q_step = max(q_step, s_max / count)
    w_port = pstate.params["w"].numpy()
    w_jax = np.asarray(jstate.params["w"])
    assert np.all(np.isfinite(w_port))
    # without compression the gradients differ by float32 summation
    # order only: a few ulps of |w|
    tol = 1e-5 * np.max(np.abs(w_jax))
    if compression == "int8":
        # plus one quantization step per element: a rounding flipped by
        # a last-bit gradient difference moves g by scale / count, and
        # w = -alpha z by alpha times that
        alpha = 1.0 / (1.0 + math.sqrt((N_STEPS + 1 + tau) / 800.0))
        tol += alpha * q_step
    np.testing.assert_allclose(w_port, w_jax, rtol=0, atol=tol)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_convert_round_trip_bitwise(compression):
    """JAX runs k steps, the state is carried across with ``convert``,
    then one master update each from the same pod-stacked gradients:
    the master state (z, t, ring slots, scales, residual, counts, head)
    and the parameters agree bit for bit (proximal l2)."""
    js, jrc = _jax_strategy("ambdg", compression, proximal="l2")
    ps, rc = _port_strategy("ambdg", compression, proximal="l2")
    jstep = jax.jit(js.train_step, donate_argnums=(0,))
    jstate = js.init_state(jax.random.PRNGKey(0))
    for batch in _batches(3):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    jstate = jax.device_get(jstate)            # numpy leaves
    pstate = convert.train_state_from_jax(jstate, device="cpu")
    jstate = jax.tree.map(jnp.asarray, jstate)
    assert pstate.arena.phase == jstate.arena.phase == 3 % 3

    from repro.core import arena as jarena
    from repro_torch.core import arena
    jlayout = jarena.make_layout(jstate.params)
    layout = arena.make_layout(pstate.params)
    rng = np.random.default_rng(5)
    pod_grads = {"w": (rng.standard_normal((1, 128)) * 40).astype(np.float32)}
    pod_counts = np.array([93.0], np.float32)
    jout = jambdg.arena_master_update(
        jlayout, jax_arena_optimizer(jrc, jlayout), jstate.params,
        jstate.opt_state, jstate.arena,
        {"w": jnp.asarray(pod_grads["w"])}, jnp.asarray(pod_counts),
        compression)
    pout = ambdg.arena_master_update(
        layout, make_arena_optimizer(rc, layout, torch.device("cpu")),
        pstate.params, pstate.opt_state, pstate.arena,
        _to_torch(pod_grads), torch.from_numpy(pod_counts), compression)
    (jp, jo, ja, jg, jc), (pp, po, pa, pg, pc) = jout, pout
    eq = np.testing.assert_array_equal
    eq(pp["w"].numpy(), np.asarray(jp["w"]))
    eq(po.z.numpy(), np.asarray(jo.z))
    assert int(po.t) == int(jo.t)
    eq(pg.numpy(), np.asarray(jg))
    assert pc.item() == float(jc)
    for a, b in zip(pa.ring, ja.ring):
        eq(a.numpy(), np.asarray(b))
    if compression == "int8":
        for a, b in zip(pa.scales, ja.scales):
            eq(a.numpy(), np.asarray(b))
        eq(pa.residual.numpy(), np.asarray(ja.residual))
    eq(pa.counts.numpy(), np.asarray(ja.counts))
    assert pa.phase == ja.phase and int(pa.head) == int(ja.head)


DELAY = dict(tau_max=4, seed=7)


@pytest.mark.parametrize("process,compression,adaptive", [
    ("heavy_tail", "none", True), ("heavy_tail", "int8", True),
    ("jitter", "none", True), ("bursty", "int8", True),
    ("bursty", "none", False)])
def test_stochastic_delay_train_matches_jax(process, compression, adaptive):
    delay = dict(DELAY, process=process, jitter=2, p_burst=0.3,
                 adaptive_alpha=adaptive)
    jrc = _rc(jbase, jax_smoke_config("amb-linreg"), "ambdg", compression,
              delay=delay)
    rc = _rc(base, get_smoke_config("amb-linreg"), "ambdg", compression,
             delay=delay)
    n_steps = 12
    loop = dict(n_steps=n_steps, log_every=1, n_workers=N_WORKERS,
                samples_per_worker=SPW)
    jout = jax_train(jax_build_model(jrc.model), jrc, JaxLoopConfig(**loop))
    pout = train(build_model(rc.model, device="cpu"), rc, LoopConfig(**loop),
                 device="cpu")
    from repro_torch.core.delay_process import make_delay_process
    from repro_torch.core.staleness import delivery_schedule
    delays = make_delay_process(rc.delay, rc.ambdg.tau).sequence(n_steps)
    sched = delivery_schedule(delays.tolist())
    q_step = 0.0
    empty = 0
    for t, (pm, jm) in enumerate(zip(pout["history"], jout["history"])):
        assert pm["applied_count"] == jm["applied_count"], t
        assert pm["tau_applied"] == jm["tau_applied"], t
        if t + 1 not in sched:         # no arrival: count 0, the cap
            empty += 1
            assert pm["applied_count"] == 0.0
            assert pm["tau_applied"] == DELAY["tau_max"]
        else:
            assert pm["applied_count"] > 0.0
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"],
                                   rtol=1e-5)
        if compression == "int8" and pm["applied_count"]:
            s_max = float(pout["state"].arena.scales.max())
            q_step = max(q_step, s_max / pm["applied_count"])
    assert empty > 0
    w_port = pout["state"].params["w"].numpy()
    w_jax = np.asarray(jout["state"].params["w"])
    tol = 1e-5 * np.max(np.abs(w_jax))
    if compression == "int8":
        tol += q_step          # alpha < 1 times one quantization step
    np.testing.assert_allclose(w_port, w_jax, rtol=0, atol=tol)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_convert_round_trip_variable_ring_bitwise(compression):
    """The v3 ring carried across: after k stochastic-delay steps in
    JAX, one more step each from the same gradients and delay gives the
    same grad_sum, count, tau_obs and ring state bit for bit (the JAX
    side runs eagerly, as in tests/test_torch_variable_ring.py)."""
    delay = dict(DELAY, process="heavy_tail")
    js, _ = _jax_strategy("ambdg", compression, proximal="l2", delay=delay)
    jstep = jax.jit(js.train_step, donate_argnums=(0,))
    jstate = js.init_state(jax.random.PRNGKey(0))
    for t, batch in enumerate(_batches(4)):
        batch["delay"] = np.int32([4, 2, 1, 3][t])   # step 4 pops one
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    jstate = jax.device_get(jstate)
    pstate = convert.train_state_from_jax(jstate, device="cpu")
    assert pstate.arena.phase == jstate.arena.phase == 4
    assert int(pstate.arena.head) == 4
    np.testing.assert_array_equal(pstate.arena.due.numpy(),
                                  np.asarray(jstate.arena.due))

    from repro.core import arena as jarena
    from repro_torch.core import arena
    jlayout = jarena.make_layout(jstate.params)
    layout = arena.make_layout(pstate.params)
    rng = np.random.default_rng(5)
    g = {"w": (rng.standard_normal((1, 128)) * 40).astype(np.float32)}
    c = np.array([93.0], np.float32)
    jout = jarena.push_pop_variable(
        jlayout, jax.tree.map(jnp.asarray, jstate.arena),
        {"w": jnp.asarray(g["w"])}, jnp.asarray(c), jnp.int32(1),
        compression)
    pout = arena.push_pop_variable(layout, pstate.arena, _to_torch(g),
                                   torch.from_numpy(c), 1, compression)
    eq = np.testing.assert_array_equal
    eq(pout[0].numpy(), np.asarray(jout[0]))
    assert pout[1].item() == float(jout[1]) > 0
    assert pout[2].item() == float(jout[2])
    pa, ja = pout[3], jout[3]
    for f in ("ring", "counts", "due", "stale") + (
            ("scales", "residual") if compression == "int8" else ()):
        eq(getattr(pa, f).numpy(), np.asarray(getattr(ja, f)))
    assert int(pa.head) == int(ja.head) == 5 and pa.phase == ja.phase
