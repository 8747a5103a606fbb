"""The training scenarios of the port against the JAX package, on the
CPU: the adaptive batch schedules, the elastic worker processes, the
health tracker, checkpoint/restart, the adaptive-b K-batch master, and
the simulator and the training loop under each.

Exact where the JAX side is host numpy (every schedule's targets and
feedback, every process's draws, the health traces, the weight folds,
the simulator's bookkeeping columns, the loop's targets, applied counts
and re-mesh events) or where the port is held against itself (a
restart from a checkpoint equals the uninterrupted run bit for bit). The
simulator's errors go through f32 tensor arithmetic and are held at
``tests/test_sim_golden.py``'s rtol 1e-4, atol 1e-7; a loop's weights
and losses, whose products sum in another order in each framework, at
the tolerances of ``tests/test_torch_slice.py`` (stated where used).
"""
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.sim as jsim
from repro.configs import base as jbase
from repro.core import batch_schedule as jbs
from repro.core import kbatch as jkbatch
from repro.core import worker_process as jwp
from repro.data import pipeline as jpipe
from repro.data import timing as jtiming
from repro.models.api import build_model as jax_build_model
from repro.train import checkpoint as jckpt
from repro.train import fault as jfault
from repro.train import loop as jloop
from repro_torch import api, convert, sim
from repro_torch.configs import base
from repro_torch.core import arena as arena_mod
from repro_torch.core import batch_schedule as bs
from repro_torch.core import kbatch
from repro_torch.core import worker_process as wp
from repro_torch.data import pipeline, timing
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import loop as tloop

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "batch_schedule_trace.json")
SCHEDULES = {
    "fixed": dict(schedule="fixed", b0=20),
    "linear": dict(schedule="linear", b0=16, b_cap=128, growth_rate=2.5,
                   seed=5),
    "adadamp": dict(schedule="adadamp", b0=12, b_cap=96, growth_factor=1.5,
                    ema=0.3, seed=5),
    "delay_aware": dict(schedule="delay_aware", b0=12, b_cap=96, ema=0.4,
                        seed=1),
}
PROCESSES = {
    "static": dict(process="static"),
    "heterogeneous": dict(process="heterogeneous", speed_sigma=0.6,
                          speed_min=0.1, seed=3),
    "churn": dict(process="churn", p_fail=0.2, p_recover=0.4, seed=2),
    "crash_restart": dict(process="crash_restart", mttf=6.0, mttr=3.0,
                          seed=7),
}


def _feedback(n, seed=0):
    rng = np.random.default_rng(seed)
    loss = np.exp(-0.2 * np.arange(n)) * (1 + 0.1 * rng.random(n))
    return loss.tolist(), rng.integers(0, 7, n).astype(float).tolist()


# -- batch schedules ----------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_with_feedback_and_restart(name):
    """``sequence`` (no feedback), ``target`` after each ``observe`` of a
    seeded loss / staleness sequence, and a ``state_dict`` round trip
    into a fresh controller: the same integers as JAX's controller."""
    mk = lambda m, cfgs: m.make_batch_schedule(
        cfgs.BatchScheduleConfig(**SCHEDULES[name]), 180.0, 4)
    p, j = mk(bs, base), mk(jbs, jbase)
    assert p.sequence(9).tolist() == j.sequence(9).tolist()
    losses, taus = _feedback(30)
    got, want = [], []
    for i, (loss, tau) in enumerate(zip(losses, taus)):
        for s, out in ((p, got), (j, want)):
            s.observe(loss=loss, tau_obs=tau)
            out.append(s.target())
        if i == 14:        # restart p from its state, through JSON
            state = json.loads(json.dumps(p.state_dict()))
            assert state == json.loads(json.dumps(j.state_dict()))
            p = mk(bs, base)
            p.load_state_dict(state)
    assert got == want
    if name in ("linear", "adadamp", "delay_aware"):
        assert len(set(got)) > 1, got
    assert repr(p) == repr(j)


@pytest.mark.parametrize("kw", [
    dict(schedule="nope"), dict(b0=0, b_min=0), dict(b0=8, b_cap=4),
    dict(schedule="linear", growth_rate=-1.0),
    dict(schedule="adadamp", growth_factor=1.0), dict(ema=0.0)])
def test_schedule_validation_matches_jax(kw):
    for m, cfgs in ((bs, base), (jbs, jbase)):
        with pytest.raises(ValueError):
            m.resolve_targets(cfgs.BatchScheduleConfig(**kw), 180.0)


def test_apply_batch_target_bitwise():
    """The weights capped at a target equal JAX's for anytime masks,
    targets above and below the drawn total, and remainders."""
    rng = np.random.default_rng(4)
    for n, spw in ((4, 8), (3, 16), (8, 5)):
        for target in (0, 1, 7, n * spw // 2, n * spw, 3 * n * spw):
            b = rng.integers(0, spw + 1, n)
            w = (np.arange(spw)[None, :] < b[:, None]).astype(
                np.float32).reshape(-1)
            got = pipeline.apply_batch_target(w, target, n, spw)
            want = jpipe.apply_batch_target(w, target, n, spw)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


# -- worker processes and health ------------------------------------------------
@pytest.mark.parametrize("name", sorted(PROCESSES))
def test_worker_process_matches_jax_and_restarts(name):
    mk = lambda m, cfgs: m.make_worker_process(
        cfgs.ElasticConfig(**PROCESSES[name]), 6)
    p, j = mk(wp, base), mk(jwp, jbase)
    for a, b in zip(p.sequence(25), j.sequence(25)):
        np.testing.assert_array_equal(a, b)
    state = json.loads(json.dumps(p.state_dict()))
    assert state == json.loads(json.dumps(j.state_dict()))
    p = mk(wp, base)
    p.load_state_dict(state)
    a, b = p.sequence(25), j.sequence(25)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if name in ("churn", "crash_restart"):
        assert not a[0].all(), name      # someone went down


@pytest.mark.parametrize("kw", [
    dict(process="nope"), dict(p_fail=1.5), dict(process="churn",
                                                 p_recover=0.0),
    dict(mttf=0.0), dict(speed_sigma=-1.0), dict(speed_min=0.0)])
def test_elastic_validation_matches_jax(kw):
    for m, cfgs in ((wp, base), (jwp, jbase)):
        with pytest.raises(ValueError):
            m.validate_elastic(cfgs.ElasticConfig(**kw))


def test_fold_anytime_weights_bitwise():
    rng = np.random.default_rng(2)
    for _ in range(20):
        n, spw = 5, 12
        b = rng.integers(0, spw + 1, n)
        w = (np.arange(spw)[None, :] < b[:, None]).astype(
            np.float32).reshape(-1)
        active = rng.random(n) < 0.7
        speeds = rng.uniform(0.05, 1.6, n)
        np.testing.assert_array_equal(
            fault.fold_anytime_weights(w, active, speeds, n, spw),
            jfault.fold_anytime_weights(w, active, speeds, n, spw))


def test_worker_health_traces_match_jax():
    """Both trackers driven by one crash/restart process on the virtual
    epoch clock, as the elastic loop drives them: every tick's newly
    failed list, the evictions, readmissions, ignored heartbeats, masks,
    re-mesh plans and state dicts agree."""
    proc = jwp.make_worker_process(jbase.ElasticConfig(
        process="crash_restart", mttf=4.0, mttr=3.0, seed=5), 6)
    hp = fault.WorkerHealth(6, heartbeat_timeout=0.5, eviction_misses=2,
                            t0=0.0)
    hj = jfault.WorkerHealth(6, heartbeat_timeout=0.5, eviction_misses=2,
                             t0=0.0)
    for step in range(40):
        active, _ = proc.step()
        at = float(step)
        for h in (hp, hj):
            for i in np.flatnonzero(active):
                if int(i) in h.evicted and step % 3:
                    h.readmit(int(i), at=at)
                h.heartbeat(int(i), at=at)
        assert hp.tick(at=at) == hj.tick(at=at)
        b = np.arange(6) + 1
        np.testing.assert_array_equal(hp.anytime_mask(b, at=at),
                                      hj.anytime_mask(b, at=at))
        assert hp.rescale_plan() == hj.rescale_plan()
        assert hp.needs_rescale == hj.needs_rescale
        assert hp.state_dict() == hj.state_dict()
    assert hp.ignored_heartbeats > 0 and hp.evicted != set(range(6))
    restored = fault.WorkerHealth(6, t0=0.0)
    restored.load_state_dict(json.loads(json.dumps(hp.state_dict())))
    assert restored.state_dict() == hp.state_dict()


def test_wall_clock_health_deviation_is_pinned(monkeypatch):
    """ROADMAP C.2. JAX's ``WorkerHealth(n)`` on the wall clock masks
    every worker 31 s after it was built; its non-elastic loop ticks one
    that nothing feeds, so past 30 s of wall time every step applies
    count 0. The port's loop builds no tracker without an elastic
    process: with a clock that jumps 31 s a call, JAX's loop zeroes every
    applied count and the port's does not."""
    h = jfault.WorkerHealth(4)
    assert h.tick(at=h.last_seen[0] + 31.0) == [0, 1, 2, 3]
    clock = iter(range(0, 10 ** 6, 31))
    monkeypatch.setattr(jfault, "time", types.SimpleNamespace(
        monotonic=lambda: float(next(clock))))

    def no_tracker(*a, **k):
        raise AssertionError("the non-elastic loop built a WorkerHealth")

    monkeypatch.setattr(tloop, "WorkerHealth", no_tracker)
    jrc, prc = _rc(jbase), _rc(base)
    loop = dict(n_steps=5, n_workers=4, samples_per_worker=8, log_every=1)
    jout = jloop.train(jax_build_model(jrc.model), jrc,
                       jloop.LoopConfig(**loop))
    pout = tloop.train(build_model(prc.model, device="cpu"), prc,
                       tloop.LoopConfig(**loop), device="cpu")
    assert [h["applied_count"] for h in jout["history"]] == [0.0] * 5
    assert [h["applied_count"] for h in pout["history"]][2:] == [32.0] * 3


# -- the adaptive-b K-batch master ----------------------------------------------
def test_kbatch_adaptive_b_matches_jax():
    """``KBatchMaster(adaptive_b=True)``: alpha from each triggering
    batch's total count. Same messages (counts vary), same staleness
    log, bit-identical params to JAX's master run eagerly."""
    rng = np.random.default_rng(1)
    cfg_p, cfg_j = base.AmbdgConfig(b_bar=50.0), jbase.AmbdgConfig(b_bar=50.0)
    mp = kbatch.KBatchMaster({"w": torch.zeros(16)}, cfg_p, 3,
                             adaptive_b=True)
    mj = jkbatch.KBatchMaster({"w": jnp.zeros(16)}, cfg_j, 3,
                              adaptive_b=True)
    fixed = kbatch.KBatchMaster({"w": torch.zeros(16)}, cfg_p, 3)
    for i in range(12):
        g = rng.standard_normal(16).astype(np.float32)
        c, ref = float(rng.integers(5, 40)), 1 + i // 4
        mp.receive(kbatch.Message({"w": torch.from_numpy(g)}, c, ref, i % 3))
        fixed.receive(kbatch.Message({"w": torch.from_numpy(g)}, c, ref,
                                     i % 3))
        mj.receive(jkbatch.Message({"w": jnp.asarray(g)}, c, ref, i % 3))
    assert mp.update_count == mj.update_count == 4
    assert mp.staleness_log == mj.staleness_log
    np.testing.assert_array_equal(mp.params["w"].numpy(),
                                  np.asarray(mj.params["w"]))
    assert not torch.equal(mp.params["w"], fixed.params["w"])


# -- the simulator ----------------------------------------------------------------
def _sim_columns(tr, kbatch_engine):
    cols = {"times": [round(t, 9) for t in tr.times],
            "targets": [int(b) for b in tr.targets],
            "staleness": [int(s) for s in tr.staleness],
            "clamps": [int(c) for c in tr.clamps],
            "errors": [float(e) for e in tr.errors]}
    if not kbatch_engine:
        cols.update(minibatches=[float(b) for b in tr.minibatches],
                    delays=[int(d) for d in tr.delays])
    return cols


def _schedule_traces(pkg_cfgs, pkg_sim, pkg_tm, delay_mod, sched_mod,
                     seed=7, rng_seed=11, sched_seed=5, device=None):
    """``tests/test_sim_golden.py``'s batch-schedule runs: AMB-DG under
    adadamp with the heavy-tailed delay, K-batch under the linear ramp."""
    cfg = pkg_cfgs.ModelConfig(name="linreg", family=pkg_cfgs.LINREG,
                               n_layers=0, d_model=0, n_heads=0, n_kv_heads=0,
                               d_ff=0, vocab_size=0, linreg_dim=64)
    tm = pkg_tm.ShiftedExponential(lam=2 / 3, xi=1.0, b=60)
    opt = pkg_cfgs.AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                               b_bar=180.0, proximal="l2_ball",
                               radius_C=float(1.05 * np.sqrt(64)))
    dcfg = pkg_cfgs.DelayConfig(process="heavy_tail", tau_max=6, seed=13)
    ada = pkg_cfgs.BatchScheduleConfig(schedule="adadamp", b0=12, b_cap=96,
                                       growth_factor=2.0, ema=0.3,
                                       seed=sched_seed)
    lin = pkg_cfgs.BatchScheduleConfig(schedule="linear", b0=16, b_cap=128,
                                       growth_rate=2.0, seed=sched_seed)
    kw = {} if device is None else {"device": device}
    problem = lambda: pkg_sim.SimProblem(cfg, n_workers=3, seed=seed,
                                         b_max=128, **kw)
    common = dict(t_c=10.0, total_time=60.0, timing=tm, opt_cfg=opt,
                  rng_seed=rng_seed)
    dg = pkg_sim.simulate_anytime(
        problem(), t_p=2.5, scheme="ambdg",
        delay_process=delay_mod.make_delay_process(dcfg, opt.staleness),
        batch_schedule=sched_mod.make_batch_schedule(ada, opt.b_bar,
                                                     opt.staleness), **common)
    kb = pkg_sim.simulate_kbatch(
        problem(), b_per_msg=32, K=3, t_p=2.5,
        batch_schedule=sched_mod.make_batch_schedule(lin, opt.b_bar,
                                                     opt.staleness), **common)
    return {"ambdg": _sim_columns(dg, False), "kbatch": _sim_columns(kb, True)}


def _check_trace(got, want, label):
    for k in want:
        if k == "errors":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                       err_msg=label)
        else:
            assert got[k] == want[k], (label, k)


def _port_traces(**kw):
    from repro_torch.core import delay_process
    return _schedule_traces(base, sim, timing, delay_process, bs,
                            device="cpu", **kw)


@pytest.mark.parametrize("scheme", ["ambdg", "kbatch"])
def test_batch_schedule_trace_matches_golden(scheme):
    """Both halves of ``tests/golden/batch_schedule_trace.json``: targets,
    times, staleness, clamps (and for AMB-DG minibatches and delays)
    exactly; errors at rtol 1e-4, atol 1e-7. No clamp; AMB-DG applies
    each target whole."""
    with open(GOLDEN) as f:
        want = json.load(f)[scheme]
    got = _port_traces()[scheme]
    assert len(got["times"]) == len(want["times"]) > 0
    _check_trace(got, want, scheme)
    assert all(c == 0 for c in got["clamps"])
    if scheme == "ambdg":
        assert got["minibatches"] == [float(b) for b in got["targets"]]


def test_batch_schedule_trace_matches_live_jax_on_a_second_seed():
    from repro.core import delay_process as jdelay
    kw = dict(seed=3, rng_seed=8, sched_seed=9)
    got = _port_traces(**kw)
    want = _schedule_traces(jbase, jsim, jtiming, jdelay, jbs, **kw)
    for scheme in ("ambdg", "kbatch"):
        assert len(want[scheme]["times"]) > 0
        _check_trace(got[scheme], want[scheme], scheme)


def _linreg_rc(cfgs, strategy="ambdg", dim=16, **kw):
    cfg = cfgs.ModelConfig(name="linreg", family=cfgs.LINREG, n_layers=0,
                           d_model=0, n_heads=0, n_kv_heads=0, d_ff=0,
                           vocab_size=0, linreg_dim=dim)
    return cfgs.RunConfig(model=cfg, shape=cfgs.TRAIN_4K, strategy=strategy,
                          ambdg=cfgs.AmbdgConfig(t_p=2.5, t_c=10.0, tau=4,
                                                 b_bar=60.0), **kw)


@pytest.mark.parametrize("name", ["ambdg", "kbatch"])
def test_simulate_wires_strategy_worker_process_and_schedule(name):
    """``api.simulate`` given a built strategy feeds its seeded worker
    process and batch schedule into the engine (K-batch gets ``t_p``
    from the config), as JAX's does: the same traces."""
    kw = dict(t_c=10.0, total_time=40.0, rng_seed=2)
    eng = dict(t_p=2.5) if name == "ambdg" else dict(b_per_msg=16, K=2)
    out = {}
    for pkg, cfgs, mk_model, mk_sim in (
            ("port", base, lambda c: build_model(c, device="cpu"), sim),
            ("jax", jbase, jax_build_model, jsim)):
        extra = dict(elastic=cfgs.ElasticConfig(process="churn", p_fail=0.3,
                                                p_recover=0.5, seed=1),
                     batch_schedule=cfgs.BatchScheduleConfig(
                         schedule="linear", b0=8, b_cap=40, seed=1))
        rc = _linreg_rc(cfgs, name, **extra)
        build = (lambda m, r: api.build(m, r, device="cpu")) \
            if pkg == "port" else japi.build
        simulate = api.simulate if pkg == "port" else japi.simulate
        s = build(mk_model(rc.model), rc)
        assert s.worker_process(3) is not None and \
            s.batch_schedule() is not None
        problem = mk_sim.SimProblem(rc.model, n_workers=3, seed=1, b_max=64,
                                    **({"device": "cpu"} if pkg == "port"
                                       else {}))
        tm = (timing if pkg == "port" else jtiming).ShiftedExponential()
        tr = simulate(s, problem, timing=tm, opt_cfg=rc.ambdg, **kw, **eng)
        out[pkg] = (tr.times, tr.active, tr.targets, tr.staleness)
    assert out["port"] == out["jax"]
    assert out["port"][1] and out["port"][2]


# -- the training loop ------------------------------------------------------------
def _rc(cfgs, dim=16, compression="none", delay=None, elastic=None,
        schedule=None, tau=2):
    extra = {}
    if delay is not None:
        extra["delay"] = cfgs.DelayConfig(**delay)
    if elastic is not None:
        extra["elastic"] = cfgs.ElasticConfig(**elastic)
    if schedule is not None:
        extra["batch_schedule"] = cfgs.BatchScheduleConfig(**schedule)
    cfg = cfgs.ModelConfig(name="linreg", family=cfgs.LINREG, n_layers=0,
                           d_model=0, n_heads=0, n_kv_heads=0, d_ff=0,
                           vocab_size=0, linreg_dim=dim)
    return cfgs.RunConfig(
        model=cfg, shape=cfgs.TRAIN_4K,
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(t_p=2.5, t_c=10.0, tau=tau, smoothness_L=1.0,
                               b_bar=60.0, proximal="l2_ball",
                               radius_C=1.05 * math.sqrt(dim),
                               pod_compression=compression), **extra)


SCENARIOS = {
    "adadamp": dict(schedule=dict(schedule="adadamp", b0=20, b_cap=64,
                                  growth_factor=1.5, seed=3)),
    "delay_aware": dict(schedule=dict(schedule="delay_aware", b0=16,
                                      b_cap=64, seed=2),
                        delay=dict(process="heavy_tail", tau_max=5, seed=4)),
    "linear": dict(schedule=dict(schedule="linear", b0=8, b_cap=64,
                                 growth_rate=3.0)),
    "churn": dict(elastic=dict(process="churn", p_fail=0.25, p_recover=0.3,
                               seed=1)),
    "crash_restart": dict(elastic=dict(process="crash_restart", mttf=4.0,
                                       mttr=3.0, seed=2)),
    "heterogeneous": dict(elastic=dict(process="heterogeneous",
                                       speed_sigma=0.8, seed=2)),
}


def _record_targets(monkeypatch, cls):
    seen = []
    orig = cls.target

    def target(self):
        seen.append(orig(self))
        return seen[-1]

    monkeypatch.setattr(cls, "target", target)
    return seen


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_loop_scenario_matches_jax(name, monkeypatch):
    """``train`` under a batch schedule or an elastic process against
    JAX's loop from one config (12 steps, 4 workers x 16, tau 2): the
    drawn targets, the applied counts, ``tau_applied``, the active
    workers and the re-mesh events are equal; losses and grad norms to
    rtol 1e-4 and w to 1e-4 of its largest element (the two frameworks'
    products sum in different orders; ``tests/test_torch_slice.py``)."""
    loop = dict(n_steps=12, n_workers=4, samples_per_worker=16, log_every=1,
                eviction_misses=2)
    jt = _record_targets(monkeypatch, jbs.BatchSchedule)
    pt = _record_targets(monkeypatch, bs.BatchSchedule)
    jrc, prc = _rc(jbase, **SCENARIOS[name]), _rc(base, **SCENARIOS[name])
    jout = jloop.train(jax_build_model(jrc.model), jrc,
                       jloop.LoopConfig(**loop))
    pout = tloop.train(build_model(prc.model, device="cpu"), prc,
                       tloop.LoopConfig(**loop), device="cpu")
    assert pt == jt
    if "schedule" in SCENARIOS[name]:
        assert [h["b_target"] for h in pout["history"]] == pt
    assert pout["remesh_events"] == jout["remesh_events"]
    for t, (a, b) in enumerate(zip(pout["history"], jout["history"])):
        for k in ("applied_count", "local_count", "tau_applied",
                  "active_workers"):
            assert a.get(k) == b.get(k), (t, k)
        for k in ("loss", "grad_norm"):
            assert math.isclose(a[k], b[k], rel_tol=1e-4, abs_tol=1e-30), \
                (t, k)
    w, wj = pout["state"].params["w"].numpy(), np.asarray(
        jout["state"].params["w"])
    np.testing.assert_allclose(w, wj, rtol=0, atol=1e-4 * np.abs(wj).max())
    if "schedule" in SCENARIOS[name]:
        assert len(set(pt)) > 1, pt
    if name in ("churn", "crash_restart"):
        assert any(e["event"] == "evict" for e in pout["remesh_events"])


def _state_leaves(state):
    return ckpt._flatten_with_paths(state)


def _assert_states_equal(a, b):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("name,compression", [
    ("churn", "int8"), ("crash_restart", "none"), ("adadamp", "int8"),
    ("delay_aware", "int8")])
def test_restart_equals_uninterrupted_run(name, compression, tmp_path):
    """A run stopped after 6 steps and restarted from its checkpoint ends
    where the uninterrupted 12-step run ends, bit for bit: every state
    leaf (params, z, ring, scales, residual, counts, head, step) and the
    host-side states in the step-12 checkpoint (pipeline, delay and
    worker processes, health, batch schedule)."""
    rc = _rc(base, compression=compression, **SCENARIOS[name])
    loop = dict(n_workers=4, samples_per_worker=16, log_every=1,
                ckpt_every=6, eviction_misses=2)

    def run(n, d):
        return tloop.train(build_model(rc.model, device="cpu"), rc,
                           tloop.LoopConfig(n_steps=n, ckpt_dir=str(d),
                                            **loop), device="cpu")

    whole = run(12, tmp_path / "whole")
    run(6, tmp_path / "split")
    rest = run(12, tmp_path / "split")
    assert len(rest["history"]) == 6
    _assert_states_equal(rest["state"], whole["state"])
    for a, b in zip(rest["history"], whole["history"][6:]):
        assert {k: v for k, v in a.items() if not k.endswith("_s")} == \
            {k: v for k, v in b.items() if not k.endswith("_s")}
    manifests = [json.load(open(tmp_path / d / "step_000000012" /
                                "manifest.json"))
                 for d in ("whole", "split")]
    assert manifests[0] == manifests[1]
    assert set(manifests[0]["extra"]) >= {"pipeline", "step"}
    if "elastic" in SCENARIOS[name]:
        assert {"elastic_process", "health"} <= set(manifests[0]["extra"])


def test_eviction_checkpoints_at_once_with_the_plan(tmp_path):
    """An eviction saves a checkpoint after its step, carrying the
    re-mesh plan, whatever ``ckpt_every`` says; ``keep`` retention holds
    the three latest."""
    rc = _rc(base, **SCENARIOS["crash_restart"])
    out = tloop.train(build_model(rc.model, device="cpu"), rc,
                      tloop.LoopConfig(n_steps=12, n_workers=4,
                                       samples_per_worker=16,
                                       ckpt_dir=str(tmp_path), ckpt_every=100,
                                       eviction_misses=2), device="cpu")
    evicts = [e for e in out["remesh_events"] if e["event"] == "evict"]
    assert evicts
    last = evicts[-1]
    step = ckpt.latest_step(str(tmp_path))
    assert step == last["step"] + 1
    with open(tmp_path / f"step_{step:09d}" / "manifest.json") as f:
        extra = json.load(f)["extra"]
    assert extra["remesh_plan"] == last["plan"]
    assert len(os.listdir(tmp_path)) <= 3


def _jax_state(compression, n_steps=3):
    """A JAX AMB-DG state (linreg d = 300, tau 2, one pod) after eager
    steps, and the batch of the next step."""
    rc = _rc(jbase, dim=300, compression=compression)
    s = japi.build(jax_build_model(rc.model), rc)
    state = s.init_state(jax.random.PRNGKey(0))
    pipe = jpipe.AnytimePipeline(rc.model, 4, 16, seed=1,
                                 timing=jtiming.ShiftedExponential())
    for _ in range(n_steps):
        state, _ = s.train_step(state, {k: jnp.asarray(v) for k, v in
                                        pipe.next_global_batch().items()})
    return state


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_checkpoints_cross_between_packages(compression, tmp_path):
    """One format: a JAX checkpoint restores into the port's state
    template bit for bit (the int8 ring as int8, the v2 phase from the
    head), and the port's checkpoint of that state restores in JAX to
    the same leaves."""
    jstate = _jax_state(compression)
    jckpt.save(str(tmp_path / "jax"), 3, jstate, extra={"step": 3})
    rc = _rc(base, dim=300, compression=compression)
    template = api.build(build_model(rc.model, device="cpu"), rc,
                         device="cpu").init_state()
    got, extra = ckpt.restore(str(tmp_path / "jax"), template)
    want = convert.train_state_from_jax(jax.device_get(jstate), device="cpu")
    _assert_states_equal(got, want)
    assert got.arena.phase == want.arena.phase == 3 % 3
    assert extra == {"step": 3}
    if compression == "int8":
        assert got.arena.ring[0].dtype == torch.int8
    ckpt.save(str(tmp_path / "port"), 3, got)
    back, _ = jckpt.restore(str(tmp_path / "port"),
                            jax.device_get(jstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert back.arena.phase == jstate.arena.phase


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_restore_migrates_the_older_rings(compression, tmp_path):
    """A checkpoint of the stacked v1 ring restores into a v2 template
    as ``convert_ring`` lays it out; one of the delay-tolerant ring saved
    as per-slot buffers restores into the stacked v3 template as it
    was."""
    layout = arena_mod.make_layout({"w": torch.zeros(300)})
    gen = torch.Generator().manual_seed(0)
    v1 = arena_mod.init_arena(layout, 3, 1, compression, device="cpu",
                              ring_version=1)
    for t in range(4):
        g = {"w": torch.randn((1, 300), generator=gen) * 10}
        _, _, v1 = arena_mod.push_pop(layout, v1, g,
                                      torch.full((1,), 10.0 + t),
                                      compression)
    ckpt.save(str(tmp_path / "v1"), 4, {"arena": v1})
    v2 = arena_mod.init_arena(layout, 3, 1, compression, device="cpu")
    got, _ = ckpt.restore(str(tmp_path / "v1"), {"arena": v2})
    want = arena_mod.convert_ring(v1, 2)
    for k in range(4):
        assert torch.equal(got["arena"].ring[k], want.ring[k]), k
    assert torch.equal(got["arena"].counts, want.counts)

    v3 = arena_mod.init_arena(layout, 4, 1, compression, device="cpu",
                              variable=True)
    for t in range(3):
        g = {"w": torch.randn((1, 300), generator=gen)}
        _, _, _, v3 = arena_mod.push_pop_variable(
            layout, v3, g, torch.full((1,), 5.0), torch.tensor(t % 3),
            compression)
    tuple_form = v3._replace(ring=tuple(v3.ring), scales=(
        None if v3.scales is None else tuple(v3.scales)))
    ckpt.save(str(tmp_path / "v3"), 3, {"arena": tuple_form})
    fresh = arena_mod.init_arena(layout, 4, 1, compression, device="cpu",
                                 variable=True)
    got, _ = ckpt.restore(str(tmp_path / "v3"), {"arena": fresh})
    _assert_states_equal(got, {"arena": v3})
    assert got["arena"].phase == v3.phase


def test_restore_rejects_a_mismatched_template(tmp_path):
    rc = _rc(base)
    s = api.build(build_model(rc.model, device="cpu"), rc, device="cpu")
    ckpt.save(str(tmp_path), 1, s.init_state())
    big = _rc(base, dim=32)
    t = api.build(build_model(big.model, device="cpu"), big, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), t.init_state())
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), t.init_state())
