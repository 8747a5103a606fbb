"""The port's cluster simulator (``repro_torch.sim``) against the
committed golden traces and the live JAX simulator, on the CPU.

The bookkeeping columns (times, epochs, minibatches, delays, staleness,
and against JAX the per-update count of clamped requests) are Python
floats and seeded numpy and must equal exactly; the error
columns go through f32 tensor arithmetic and are held at rtol 1e-4,
atol 1e-7 (``tests/test_sim_golden.py``'s tolerance):

  * ``tests/golden/sim_trace.json``: AMB-DG and AMB;
  * both halves of ``tests/golden/stochastic_trace.json``: AMB-DG under
    a heavy-tailed per-epoch delay and K-batch under per-message uplink
    jitter;
  * the same three engines against the live JAX simulator on a second
    seed (a persistent-speed fleet for K-batch);
  * twins of ``tests/test_strategy_api.py``'s timeline, K-batch and
    simulate-wiring tests and ``tests/test_elastic.py``'s
    ``PersistentWorkerSpeeds`` test; both engines under an elastic
    worker process and a batch schedule against JAX; the K-batch device
    step equals AMB's.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.sim as jsim
from repro.configs import base as jbase
from repro.core import batch_schedule as bs_jax
from repro.core import delay_process as jdelay
from repro.core import worker_process as wp_jax
from repro.data import timing as jtiming
from repro_torch import api
from repro_torch.configs import base, get_smoke_config
from repro_torch.core import batch_schedule, delay_process, worker_process
from repro_torch.data import timing
from repro_torch import sim

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# (port modules, JAX modules): (configs, sim, timing, delay_process)
PORT = (base, sim, timing, delay_process)
JAX = (jbase, jsim, jtiming, jdelay)


def _problem(pkg, dim=64, n_workers=3, seed=7, b_max=128):
    cfgs, simm = pkg[:2]
    cfg = cfgs.ModelConfig(name="linreg", family=cfgs.LINREG, n_layers=0,
                           d_model=0, n_heads=0, n_kv_heads=0, d_ff=0,
                           vocab_size=0, linreg_dim=dim)
    kw = {"device": "cpu"} if pkg is PORT else {}
    return simm.SimProblem(cfg, n_workers=n_workers, seed=seed,
                           b_max=b_max, **kw)


def _opt(cfgs, dim=64):
    return cfgs.AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                            b_bar=180.0, proximal="l2_ball",
                            radius_C=float(1.05 * np.sqrt(dim)))


def _columns(trace, *names):
    out = {"times": [round(t, 9) for t in trace.times],
           "epochs": list(trace.epochs),
           "errors": [float(e) for e in trace.errors],
           "minibatches": [float(b) for b in trace.minibatches],
           "staleness": [int(s) for s in trace.staleness],
           "delays": [int(d) for d in trace.delays],
           "clamps": [int(c) for c in trace.clamps]}
    return {k: out[k] for k in names}


def _run(pkg, which, seed=7, rng_seed=11, dcfg_seed=13):
    """One trace of ``tests/test_sim_golden.py``'s configurations:
    ``which`` in sim-ambdg, sim-amb, stochastic-ambdg, stochastic-kbatch,
    or persistent-kbatch (the persistent-speed fleet, fixed uplink)."""
    cfgs, simm, tm, dp = pkg
    opt = _opt(cfgs)
    timing_model = tm.ShiftedExponential(lam=2 / 3, xi=1.0, b=60)
    problem = _problem(pkg, seed=seed)
    common = dict(t_c=10.0, total_time=60.0, timing=timing_model,
                  opt_cfg=opt, rng_seed=rng_seed)
    kind, scheme = which.split("-")
    delay = None
    if kind == "stochastic":
        delay = dp.make_delay_process(cfgs.DelayConfig(
            process="heavy_tail", tau_max=6, seed=dcfg_seed), opt.staleness)
    if scheme == "kbatch":
        if kind == "persistent":
            common["timing"] = tm.PersistentWorkerSpeeds(timing_model, 3,
                                                         seed=seed)
        tr = simm.simulate_kbatch(problem, b_per_msg=32, K=3,
                                  delay_process=delay, t_p=2.5, **common)
        return _columns(tr, "times", "epochs", "delays", "staleness",
                        "clamps", "errors")
    tr = simm.simulate_anytime(problem, t_p=2.5, scheme=scheme,
                               delay_process=delay, **common)
    return _columns(tr, "times", "epochs", "delays", "staleness",
                    "minibatches", "clamps", "errors")


def _check(got, want, label):
    for k in want:
        if k == "errors":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-7, err_msg=label)
        else:
            assert got[k] == want[k], (label, k)


@pytest.mark.parametrize("golden,which", [
    ("sim_trace", "sim-ambdg"), ("sim_trace", "sim-amb"),
    ("stochastic_trace", "stochastic-ambdg"),
    ("stochastic_trace", "stochastic-kbatch")])
def test_trace_matches_golden(golden, which):
    with open(os.path.join(GOLDEN, golden + ".json")) as f:
        want = json.load(f)[which.split("-")[1]]
    got = _run(PORT, which)
    assert len(got["times"]) == len(want["times"]) > 0
    _check(got, want, which)
    if which == "stochastic-kbatch":
        assert len(want["staleness"]) == 3 * len(want["times"])


def test_fig2_contract_holds_in_the_port():
    """AMB-DG fits more than 3x AMB's updates into the same wall clock
    (the paper's Fig. 2), and both error curves end below their start."""
    dg, amb = _run(PORT, "sim-ambdg"), _run(PORT, "sim-amb")
    assert len(dg["times"]) > 3 * len(amb["times"])
    for tr in (dg, amb):
        assert np.all(np.isfinite(tr["errors"]))
        assert tr["errors"][-1] < tr["errors"][0]


@pytest.mark.parametrize("which", ["sim-ambdg", "sim-amb", "stochastic-ambdg",
                                   "stochastic-kbatch", "persistent-kbatch"])
def test_trace_matches_live_jax_on_a_second_seed(which):
    kw = dict(seed=3, rng_seed=5, dcfg_seed=2)
    got, want = _run(PORT, which, **kw), _run(JAX, which, **kw)
    assert len(want["times"]) > 0
    _check(got, want, which)
    if which.endswith("ambdg"):    # draws above b_max = 128 are clamped
        assert sum(got["clamps"]) > 0


def test_timeline_models_pin_paper_algebra():
    """The closed forms the golden sim trace pins (paper Fig. 1)."""
    dg = api.get_strategy("ambdg").timeline_model()
    amb = api.get_strategy("amb").timeline_model()
    kb = api.get_strategy("kbatch").timeline_model()
    t_p, t_c = 2.5, 10.0
    assert dg.update_time(4, t_p, t_c) == 4 * t_p + 0.5 * t_c
    assert dg.epoch_duration(t_p, t_c) == t_p
    assert amb.update_time(4, t_p, t_c) == 4 * t_p + 3.5 * t_c
    assert amb.epoch_duration(t_p, t_c) == t_p + t_c
    assert dg.n_updates(60.0, t_p, t_c) == 22
    assert amb.n_updates(60.0, t_p, t_c) == 5
    assert kb.event_driven and kb.update_time is None
    assert api.available_strategies() == ("amb", "ambdg", "decentralized",
                                          "kbatch")
    assert [api.get_strategy(s).sim_engine for s in (
        "ambdg", "amb", "kbatch", "decentralized")] == [
        "anytime", "anytime", "kbatch", None]


def _linreg_rc(strategy, dim=48, **kw):
    cfg = base.ModelConfig(name="linreg", family=base.LINREG, n_layers=0,
                           d_model=0, n_heads=0, n_kv_heads=0, d_ff=0,
                           vocab_size=0, linreg_dim=dim)
    return base.RunConfig(
        model=cfg,
        shape=dataclasses.replace(base.TRAIN_4K, seq_len=0, global_batch=16),
        mesh=base.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=base.AmbdgConfig(tau=2, n_microbatches=2, b_bar=16.0,
                               smoothness_L=1.0),
        strategy=strategy, **kw)


def _batches(n, dim=48):
    from repro_torch.data.pipeline import AnytimePipeline
    pipe = AnytimePipeline(_linreg_rc("ambdg", dim).model, 4, 4,
                           timing=timing.ShiftedExponential())
    return [{k: torch.from_numpy(v) for k, v in
             pipe.next_global_batch().items()} for _ in range(n)]


def _strategy(rc):
    from repro_torch.models.api import build_model
    return api.build(build_model(rc.model, device="cpu"), rc, device="cpu")


def test_kbatch_ref_epoch_in_state():
    s = _strategy(_linreg_rc("kbatch"))
    state = s.init_state()
    assert int(state.ref_epoch) == 1
    for b in _batches(3):
        state, m = s.train_step(state, b)
    assert int(state.ref_epoch) == 4
    # the synchronous on-device realization: staleness identically 0
    assert int(m["staleness"]) == 0
    assert s.staleness_schedule().kind == "random"


def test_kbatch_device_step_is_the_amb_step():
    """The K-batch device step is the tau = 0 master: its params equal
    the 'amb' strategy's bit for bit, step by step."""
    kb, amb = _strategy(_linreg_rc("kbatch")), _strategy(_linreg_rc("amb"))
    s_kb, s_amb = kb.init_state(), amb.init_state()
    for b in _batches(4):
        s_kb, m_kb = kb.train_step(s_kb, b)
        s_amb, m_amb = amb.train_step(s_amb, b)
        assert torch.equal(s_kb.base.params["w"], s_amb.params["w"])
        assert m_kb["applied_count"].item() == m_amb["applied_count"].item()


def test_kbatch_master_independent_of_arrival_order():
    """The K-triggering batch is processed in canonical (ref_epoch,
    worker) order: any arrival permutation of the same messages gives
    the identical staleness log and bit-identical parameters."""
    from repro_torch.core.kbatch import KBatchMaster, Message
    rng = np.random.default_rng(0)
    params = {"w": torch.zeros(8)}
    msgs = [Message(grad_sum={"w": torch.from_numpy(
                        rng.standard_normal(8).astype(np.float32))},
                    count=6.0, ref_epoch=1 + (i % 2), worker=i)
            for i in range(4)]
    logs, finals = [], []
    for order in ([0, 1, 2, 3], [3, 1, 0, 2], [2, 3, 1, 0]):
        master = KBatchMaster(params, base.AmbdgConfig(), K=4)
        for i in order:
            master.receive(msgs[i])
        logs.append(list(master.staleness_log))
        finals.append(master.params["w"])
    assert logs[0] == logs[1] == logs[2]
    assert torch.equal(finals[0], finals[1])
    assert torch.equal(finals[0], finals[2])


def test_simulate_wires_strategy_delay_process():
    """api.simulate given a built strategy feeds rc.delay's seeded
    process into the engine (per-message uplink jitter for kbatch, t_p
    from the config; per-epoch staleness for ambdg) and stays
    delay-free for fixed configs."""
    stoch = base.DelayConfig(process="heavy_tail", tau_max=6, seed=2)
    timing_model = timing.ShiftedExponential(lam=2 / 3, xi=1.0, b=60)
    common = dict(t_c=10.0, total_time=25.0, timing=timing_model)
    for name, kw in (("ambdg", dict(t_p=2.5)),
                     ("kbatch", dict(b_per_msg=16, K=2))):
        rc = _linreg_rc(name, dim=16, delay=stoch)
        s = _strategy(rc)
        tr = api.simulate(s, _problem(PORT, dim=16, n_workers=2, b_max=64),
                          opt_cfg=rc.ambdg, **common, **kw)
        assert len(tr.delays) > 0 and max(tr.delays) <= 6, name
        s0 = _strategy(rc.replace(delay=base.DelayConfig()))
        tr0 = api.simulate(s0, _problem(PORT, dim=16, n_workers=2, b_max=64),
                           opt_cfg=rc.ambdg, **common, **kw)
        assert tr0.delays == [], name


def test_simulate_by_name_equals_the_engine():
    """api.simulate("ambdg", ...) is simulate_anytime, bit for bit."""
    opt = _opt(base)
    kw = dict(t_p=2.5, t_c=10.0, total_time=30.0, opt_cfg=opt, rng_seed=1,
              timing=timing.ShiftedExponential())
    a = api.simulate("ambdg", _problem(PORT), **kw)
    b = sim.simulate_anytime(_problem(PORT), scheme="ambdg", **kw)
    assert a.times == b.times and a.errors == b.errors
    assert torch.equal(a.final_params["w"], b.final_params["w"])


def test_persistent_speeds_time_for_rejects_partial_fleet():
    """A partial fleet call would lose the worker identity and raises;
    per_worker_time is the per-worker path. The draws equal JAX's."""
    pw = timing.PersistentWorkerSpeeds(timing.ShiftedExponential(),
                                       n_workers=4, seed=0)
    jpw = jtiming.PersistentWorkerSpeeds(jtiming.ShiftedExponential(),
                                         n_workers=4, seed=0)
    rng = np.random.default_rng(0)
    full = pw.time_for(rng, 4, 60)
    assert full.shape == (4,)
    np.testing.assert_array_equal(full, jpw.time_for(rng, 4, 60))
    with pytest.raises(ValueError, match="per_worker_time"):
        pw.time_for(rng, 1, 60)
    for w in range(4):
        assert pw.per_worker_time(w, 60) == pytest.approx(full[w])
    assert pw.b == 60
    np.testing.assert_array_equal(pw.minibatch_in(rng, 4, 2.5),
                                  jpw.minibatch_in(rng, 4, 2.5))
    assert (timing.ShiftedExponential().mean_minibatch_rate ==
            jtiming.ShiftedExponential().mean_minibatch_rate)


def _engine_run(pkg, engine, arg):
    """One engine run driven by a churn worker process or an adaptive
    batch schedule (d = 64, 3 workers, 40 simulated s)."""
    cfgs, simm, tm, _ = pkg
    if arg == "worker_process":
        mod = wp_jax if pkg is JAX else worker_process
        extra = {arg: mod.make_worker_process(cfgs.ElasticConfig(
            process="churn", p_fail=0.3, p_recover=0.4, seed=4), 3)}
    else:
        mod = bs_jax if pkg is JAX else batch_schedule
        extra = {arg: mod.make_batch_schedule(cfgs.BatchScheduleConfig(
            schedule="adadamp", b0=10, b_cap=90, seed=2), 180.0, 4)}
    kw = dict(t_c=10.0, total_time=40.0, opt_cfg=_opt(cfgs), rng_seed=3,
              timing=tm.ShiftedExponential(lam=2 / 3, xi=1.0, b=60), **extra)
    if engine == "anytime":
        tr = simm.simulate_anytime(_problem(pkg), t_p=2.5, **kw)
        names = ("times", "epochs", "minibatches", "staleness", "clamps")
    else:
        tr = simm.simulate_kbatch(_problem(pkg), b_per_msg=24, K=3, t_p=2.5,
                                  **kw)
        names = ("times", "epochs", "staleness", "clamps")
    out = _columns(tr, *names, "errors")
    out.update(active=list(tr.active), targets=list(tr.targets))
    return out


@pytest.mark.parametrize("engine", ["anytime", "kbatch"])
@pytest.mark.parametrize("arg", ["worker_process", "batch_schedule"])
def test_engine_arguments_run_as_in_jax(engine, arg):
    """Both engines take an elastic worker process and a batch schedule:
    the bookkeeping (times, epochs, minibatches, staleness, clamps, alive
    workers, targets) equals the live JAX simulator's exactly, the
    errors to rtol 1e-4, atol 1e-7."""
    got, want = _engine_run(PORT, engine, arg), _engine_run(JAX, engine, arg)
    assert len(want["times"]) > 0
    _check(got, want, f"{engine}/{arg}")
    if arg == "worker_process":
        assert want["active"] and min(want["active"]) < 3
    else:
        assert want["targets"] and len(set(want["targets"])) > 1


def test_sim_problem_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    cfg = get_smoke_config("amb-linreg")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim.SimProblem(cfg, n_workers=2)
    assert sim.SimProblem(cfg, 2, device="cpu").params0["w"].device.type \
        == "cpu"
