"""The decentralized strategy of the port (the paper's Sec. V gossip
consensus, ``rc.strategy="decentralized"``) against the JAX package, on
the CPU.

Both strategies start from JAX's init state (carried across with
``convert.decentralized_state_from_jax``) and step on the same numpy
batches, in lockstep: each step of the port starts from JAX's state
before it. Per step: the pre-gossip messages m0 agree to 1e-5 of their
largest element (the gradients sum in another order in each framework);
JAX's own m0 and residual, folded by the port, give JAX's z bit for bit
wherever every product of the fold is exact (the ring's weights are
powers of two, and every int8 term is exact); applied counts are equal,
losses and grad norms agree to rtol 1e-5, and consensus errors to 1e-5
of themselves plus 1e-5 of the duals' norm (a consensus error is the
norm of a difference of nearly equal duals). The CNN holds 1e-4 (its
f32 convolution gradients differ between the frameworks at that level,
``tests/test_torch_cnn.py``). Under int8 a last-bit difference of the
messages can flip one rounding in the gossip, which moves an element
of z by one quantization step: z, the weights and the consensus error
allow one.

``tests/golden/decentralized_trace.json`` holds on the CPU when the
batches are drawn as the golden drew them: JAX's ``dummy_batch`` under
``jax.threefry_partitionable(False)`` (jax 0.9.0 defaults to the
partitionable threefry, which draws other bytes from the same keys:
ROADMAP C.1). Also here: the masked fold under churn, ``train`` with an
elastic process, checkpoints, and the refusals.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import base as jbase
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import consensus as jcons
from repro.core.worker_process import make_worker_process as jax_wp
from repro.models.api import build_model as jax_build_model
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro_torch import api, convert
from repro_torch.configs import base, get_smoke_config
from repro_torch.core import consensus
from repro_torch.core.arena import tree_flatten
from repro_torch.core.strategy import DecentralizedState
from repro_torch.core.worker_process import make_worker_process
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.data.timing import ShiftedExponential
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as tloop

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "decentralized_trace.json")
N = 4


def _linreg(cfgs, dim=16):
    return cfgs.ModelConfig(name="linreg", family=cfgs.LINREG, n_layers=0,
                            d_model=0, n_heads=0, n_kv_heads=0, d_ff=0,
                            vocab_size=0, linreg_dim=dim)


def _rc(cfgs, model_cfg, compression="none", topology="ring", seq=0,
        elastic=None, debug=False, rounds=3, **ambdg):
    kw = dict(t_p=2.5, t_c=10.0, tau=1, n_microbatches=2, b_bar=32.0,
              smoothness_L=1.0)
    kw.update(ambdg)
    extra = {} if elastic is None else {
        "elastic": cfgs.ElasticConfig(**elastic)}
    return cfgs.RunConfig(
        model=model_cfg,
        shape=dataclasses.replace(cfgs.TRAIN_4K, seq_len=seq,
                                  global_batch=32),
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(**kw), strategy="decentralized",
        consensus=cfgs.ConsensusConfig(
            topology=topology, n_workers=N, rounds=rounds,
            gossip_impl="dense", compression=compression,
            debug_messages=debug), **extra)


def _pair(arch, compression, topology="ring", **kw):
    """(JAX strategy, port strategy, the port's pipeline) for ``arch``:
    linreg d = 16 (4 workers x 8), amb-cnn SMOKE (4 x 4 images) or
    qwen1.5-0.5b SMOKE (4 x 2 sequences of 32), all in f32."""
    if arch == "linreg":
        jcfg, cfg, seq, spw = _linreg(jbase), _linreg(base), 0, 8
        timing = ShiftedExponential(b=6)
    else:
        name = {"cnn": "amb-cnn", "qwen": "qwen1.5-0.5b"}[arch]
        f32 = dict(compute_dtype="float32")
        jcfg = dataclasses.replace(jax_smoke_config(name), **f32)
        cfg = dataclasses.replace(get_smoke_config(name), **f32)
        seq, spw = (32, 2) if arch == "qwen" else (0, 4)
        timing = ShiftedExponential(b=3) if arch == "cnn" else None
    js = japi.build(jax_build_model(jcfg),
                    _rc(jbase, jcfg, compression, topology, seq, **kw))
    ps = api.build(build_model(cfg, device="cpu"),
                   _rc(base, cfg, compression, topology, seq, **kw),
                   device="cpu")
    pipe = AnytimePipeline(cfg, N, spw, seq_len=seq, seed=3, timing=timing)
    return js, ps, pipe


def _close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max(),
                               err_msg=what)


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("arch,topology", [
    ("linreg", "ring"), ("linreg", "torus"), ("linreg", "complete"),
    ("cnn", "ring"), ("qwen", "ring")])
def test_strategy_steps_match_jax(arch, topology, compression):
    """8 steps in lockstep (the CNN 4: its 4 x 3.7 M-parameter state
    makes each step's checks the costliest of the suite): each step of
    the port starts from JAX's state before that step (carried across
    exactly), on the same batch. The limits are the module docstring's;
    the new z and per-worker weights agree to 1e-5 of their largest
    element, plus under int8 one quantization step of the messages."""
    js, ps, pipe = _pair(arch, compression, topology, debug=True)
    assert ps.rounds == js.rounds == 3
    tol = 1e-4 if arch == "cnn" else 1e-5
    jstate = js.init_state(jax.random.PRNGKey(0))
    step = jax.jit(js.train_step)
    exact = compression == "int8" or topology == "ring"
    for t in range(4 if arch == "cnn" else 8):
        b = pipe.next_global_batch()
        pstate = convert.decentralized_state_from_jax(
            jax.device_get(jstate), device="cpu")
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = ps.train_step(pstate, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        jm0 = np.asarray(jm["gossip_m0"])
        _close(pm["gossip_m0"].numpy(), jm0, tol, f"m0 {t}")
        if exact:
            # JAX's messages through the port's fold: JAX's z exactly
            jz = torch.from_numpy(np.array(jm0))
            jr = torch.from_numpy(np.array(jm["gossip_r0"]))
            if compression == "int8":
                z, _ = consensus.run_consensus_fold_int8(jz, jr, topology,
                                                         ps.rounds)
            else:
                z = consensus.run_consensus_fold(jz, topology, ps.rounds)
            np.testing.assert_array_equal(z.numpy(), np.asarray(jstate.z))
        assert pm["applied_count"].item() == float(jm["applied_count"])
        assert pm["step"].item() == int(jm["step"]) == t + 1
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=tol,
                                       err_msg=f"{k} {t}")
        # one int8 rounding flipped by a last-bit difference of the
        # messages moves an element of z by one quantization step
        q = np.abs(jm0).max() / 127.0 * 1.01 if compression == "int8" else 0
        jz = np.asarray(jstate.z)
        np.testing.assert_allclose(pstate.z.numpy(), jz, rtol=0,
                                   atol=tol * np.abs(jz).max() + q,
                                   err_msg=f"z {t}")
        # the consensus error is the norm of a difference of nearly
        # equal duals: z's limit, ``tol`` of its norm, carries into it
        np.testing.assert_allclose(
            pm["consensus_error"].item(), float(jm["consensus_error"]),
            rtol=tol,
            atol=tol * np.linalg.norm(jz.reshape(N, -1), axis=1).max() + q,
            err_msg=f"consensus_error {t}")
        for w, jw in zip(tree_flatten(pstate.params)[0],
                         jax.tree.leaves(jstate.params)):
            jw = np.asarray(jw)
            assert w.shape == jw.shape and w.shape[0] == N
            np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                                       atol=tol * np.abs(jw).max() + q)
    assert float(jm["grad_norm"]) > 0.0


def _golden_batches():
    jm = jax_build_model(_linreg(jbase, 32))
    with jax.threefry_partitionable(False):
        return [{k: np.asarray(v) for k, v in jm.dummy_batch(
            32, key=jax.random.PRNGKey(1000 + t)).items()}
            for t in range(1, 9)]


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_decentralized_trace_matches_golden(compression):
    """``tests/test_sim_golden.py``'s run (4 workers, ring, r = 3, dense,
    8 steps, linreg d = 32) in the port on the golden's batches: rounds,
    times and steps exact; consensus errors and losses to the golden's
    rtol 1e-4, atol 1e-7."""
    with open(GOLDEN) as f:
        golden = json.load(f)[compression]
    rc = _rc(base, _linreg(base, 32), compression, n_microbatches=2)
    s = api.build(build_model(rc.model, device="cpu"), rc, device="cpu")
    tm = type(s).timeline_model()
    state = s.init_state()
    times, steps, errs, losses = [], [], [], []
    for t, b in enumerate(_golden_batches(), start=1):
        state, m = s.train_step(state, {k: torch.from_numpy(np.array(v))
                                        for k, v in b.items()})
        times.append(round(tm.update_time(t, 2.5, 10.0), 9))
        steps.append(int(m["step"]))
        errs.append(float(m["consensus_error"]))
        losses.append(float(m["loss"]))
    assert s.rounds == golden["rounds"]
    assert times == golden["times"]
    assert steps == golden["steps"]
    np.testing.assert_allclose(errs, golden["consensus_errors"], rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(losses, golden["losses"], rtol=1e-4,
                               atol=1e-7)


def test_schedules_and_timeline_equal_jax():
    js, ps, _ = _pair("linreg", "none", "torus", rounds=0)
    assert ps.rounds == js.rounds == jcons.min_rounds(
        0.05, N, 1.0, jcons.lambda2(jcons.gossip_matrix("torus", N)))
    assert tuple(ps.staleness_schedule()) == tuple(js.staleness_schedule())
    tm, jtm = type(ps).timeline_model(), type(js).timeline_model()
    assert (tm.scheme, tm.event_driven) == (jtm.scheme, jtm.event_driven)
    for t in range(1, 6):
        assert tm.update_time(t, 2.5, 10.0) == jtm.update_time(t, 2.5, 10.0)
    assert tm.epoch_duration(2.5, 10.0) == jtm.epoch_duration(2.5, 10.0)
    assert tm.n_updates(250.0, 2.5, 10.0) == jtm.n_updates(250.0, 2.5, 10.0)
    assert ps.sim_engine is None and not ps.consumes_active_mask
    assert "decentralized" in api.available_strategies()


def test_state_carried_from_jax_is_exact():
    js, ps, _ = _pair("cnn", "int8")
    jstate = jax.device_get(js.init_state(jax.random.PRNGKey(5)))
    jstate = jstate._replace(
        residual=np.full(jstate.residual.shape, 0.5, np.float32),
        t=np.int32(7), step=np.int32(9))
    p = convert.decentralized_state_from_jax(jstate, device="cpu")
    assert isinstance(p, DecentralizedState)
    for (k, x), y in zip(ckpt._flatten_with_paths(p), jax.tree.leaves(jstate)):
        assert x.dtype == torch.from_numpy(np.asarray(y)).dtype, k
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    fresh = ps.init_state(torch.Generator().manual_seed(0))
    assert [k for k, _ in ckpt._flatten_with_paths(fresh)] == \
        [k for k, _ in ckpt._flatten_with_paths(p)]


# -- elastic workers: the masked fold ------------------------------------------
CHURN = dict(process="churn", p_fail=0.3, p_recover=0.5, seed=4)


def test_masked_step_vs_dense_oracle():
    """The step's masked gossip equals the port's masked fold and JAX's
    (run op by op) on the captured messages, bit for bit on the alive
    rows; dead workers' z and params carry over bit for bit;
    ``active_workers`` is the drawn alive count."""
    _, ps, pipe = _pair("linreg", "none", elastic=CHURN, debug=True)
    assert ps.consumes_active_mask
    wp = make_worker_process(ps.rc.elastic, N)
    state = ps.init_state()
    saw_dead = False
    for t in range(6):
        b = {k: torch.from_numpy(v) for k, v in
             pipe.next_global_batch().items()}
        active, _ = wp.step()
        b["active"] = torch.from_numpy(active.astype(np.float32))
        prev_z = state.z.clone()
        prev_p = [x.clone() for x in tree_flatten(state.params)[0]]
        state, m = ps.train_step(state, b)
        live = torch.from_numpy(active)
        oz = consensus.run_consensus_fold_masked(
            m["gossip_m0"], "ring", ps.rounds, m["gossip_active"])
        with jax.disable_jit():
            jz = np.asarray(jcons.run_consensus_fold_masked(
                jnp.asarray(m["gossip_m0"].numpy()), "ring", ps.rounds,
                jnp.asarray(active.astype(np.float32))))
        assert torch.equal(state.z[live], oz[live]), t
        np.testing.assert_array_equal(state.z[live].numpy(), jz[active])
        assert torch.equal(state.z[~live], prev_z[~live]), t
        for old, new in zip(prev_p, tree_flatten(state.params)[0]):
            assert torch.equal(new[~live], old[~live]), t
        assert m["active_workers"].item() == float(active.sum())
        saw_dead = saw_dead or bool((~live).any())
    assert saw_dead


def test_all_alive_elastic_is_the_static_path_bitwise():
    _, s0, pipe = _pair("linreg", "none")
    _, s1, _ = _pair("linreg", "none", elastic=dict(process="churn", seed=3))
    st0, st1 = s0.init_state(), s1.init_state()
    for _ in range(4):
        b = {k: torch.from_numpy(v) for k, v in
             pipe.next_global_batch().items()}
        st0, _ = s0.train_step(st0, dict(b))
        st1, _ = s1.train_step(st1, dict(b, active=torch.ones(N)))
    for (k, a), (_, b_) in zip(ckpt._flatten_with_paths(st0),
                               ckpt._flatten_with_paths(st1)):
        assert torch.equal(a, b_), k


def test_elastic_refusals():
    with pytest.raises(ValueError, match="int8"):
        _pair("linreg", "int8", elastic=CHURN)
    _, ps, pipe = _pair("linreg", "none", elastic=CHURN)
    b = {k: torch.from_numpy(v) for k, v in pipe.next_global_batch().items()}
    with pytest.raises(ValueError, match="active"):
        ps.train_step(ps.init_state(), b)


LOOP = dict(n_workers=N, samples_per_worker=8, log_every=1,
            eviction_misses=2)


def test_train_under_churn_ships_the_mask_and_freezes_dead_workers(
        monkeypatch):
    """``train`` under churn against JAX's loop (8 steps): the mask
    reaches the step as ``batch["active"]``, the active counts, applied
    counts and re-mesh events are equal, losses to rtol 1e-5; each dead
    worker's z and params carry over bit for bit."""
    rc, jrc = _rc(base, _linreg(base), elastic=CHURN), _rc(
        jbase, _linreg(jbase), elastic=CHURN)
    seen = []
    build = api.build

    def spy_build(*a, **kw):
        s = build(*a, **kw)
        step = s.train_step

        def spy(state, batch):
            new, m = step(state, batch)
            seen.append((batch["active"].clone(), state, new))
            return new, m

        s.train_step = spy
        return s

    monkeypatch.setattr(api, "build", spy_build)
    out = tloop.train(build_model(rc.model, device="cpu"), rc,
                      tloop.LoopConfig(n_steps=8, **LOOP), device="cpu")
    jout = jloop.train(jax_build_model(jrc.model), jrc,
                       jloop.LoopConfig(n_steps=8, **LOOP))
    draws = jax_wp(jrc.elastic, N)
    assert out["remesh_events"] == jout["remesh_events"]
    for t, (a, b) in enumerate(zip(out["history"], jout["history"])):
        active, old, new = seen[t]
        assert active.dtype == torch.float32 and active.shape == (N,)
        np.testing.assert_array_equal(active.numpy() > 0, draws.step()[0])
        for k in ("applied_count", "local_count", "active_workers"):
            assert a[k] == b[k], (t, k)
        assert a["active_workers"] == float(active.sum())
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        dead = active == 0
        assert torch.equal(new.z[dead], old.z[dead])
        assert torch.equal(new.params["w"][dead], old.params["w"][dead])
    assert any((a == 0).any() for a, _, _ in seen)


def test_train_refuses_a_mask_of_another_fleet():
    rc = _rc(base, _linreg(base), elastic=CHURN)
    with pytest.raises(ValueError, match="n_workers"):
        tloop.train(build_model(rc.model, device="cpu"), rc,
                    tloop.LoopConfig(n_steps=1, **dict(LOOP, n_workers=8)),
                    device="cpu")


# -- checkpoints -------------------------------------------------------------------
def test_pre_residual_checkpoint_migrates(tmp_path):
    """A checkpoint saved before ``DecentralizedState`` held the gossip
    residual restores with a zero residual and continues bit for bit."""
    _, ps, pipe = _pair("linreg", "none")
    batches = [{k: torch.from_numpy(v) for k, v in
                pipe.next_global_batch().items()} for _ in range(4)]
    state = ps.init_state()
    for b in batches[:2]:
        state, _ = ps.train_step(state, b)
    ckpt.save(str(tmp_path), 2, state, extra={"step": 2})
    path = tmp_path / "step_000000002" / "state.npz"
    data = dict(np.load(path))
    assert ".residual" in data and ".params/w" in data
    np.savez(path, **{k: v for k, v in data.items() if k != ".residual"})
    restored, extra = ckpt.restore(str(tmp_path), ps.init_state())
    assert extra["step"] == 2
    assert torch.equal(restored.residual, torch.zeros_like(state.residual))
    for b in batches[2:]:
        state, _ = ps.train_step(state, b)
        restored, _ = ps.train_step(restored, b)
    for (k, a), (_, b) in zip(ckpt._flatten_with_paths(state),
                              ckpt._flatten_with_paths(restored)):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("compression,elastic", [("int8", None),
                                                 ("none", CHURN)])
def test_restart_equals_uninterrupted_run(compression, elastic, tmp_path):
    """``train`` stopped at step 6 and restarted from its checkpoint ends
    where the uninterrupted 12-step run ends, bit for bit (params, z,
    residual, t, step)."""
    rc = _rc(base, _linreg(base), compression, elastic=elastic)

    def run(n, d):
        return tloop.train(build_model(rc.model, device="cpu"), rc,
                           tloop.LoopConfig(n_steps=n, ckpt_dir=str(d),
                                            ckpt_every=6, **LOOP),
                           device="cpu")

    whole = run(12, tmp_path / "whole")
    run(6, tmp_path / "split")
    rest = run(12, tmp_path / "split")
    assert len(rest["history"]) == 6
    la, lb = (ckpt._flatten_with_paths(whole["state"]),
              ckpt._flatten_with_paths(rest["state"]))
    assert [k for k, _ in la] == [".params/w", ".z", ".residual", ".t",
                                  ".step"]
    for (k, a), (_, b) in zip(la, lb):
        assert torch.equal(a, b), k
    if compression == "int8":
        assert bool(whole["state"].residual.abs().max() > 0)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A decentralized checkpoint the JAX package writes restores in the
    port under the same keys, equal to the state carried across."""
    js, ps, pipe = _pair("linreg", "int8")
    state = js.init_state(jax.random.PRNGKey(0))
    for _ in range(2):
        state, _ = js.train_step(state, {k: jnp.asarray(v) for k, v in
                                         pipe.next_global_batch().items()})
    jckpt.save(str(tmp_path), 2, state, extra={"step": 2})
    restored, _ = ckpt.restore(str(tmp_path), ps.init_state())
    want = convert.decentralized_state_from_jax(jax.device_get(state),
                                                device="cpu")
    for (k, a), (_, b) in zip(ckpt._flatten_with_paths(restored),
                              ckpt._flatten_with_paths(want)):
        assert torch.equal(a, b), k


# -- refusals ------------------------------------------------------------------------
def test_simulate_refuses_the_decentralized_strategy():
    from repro_torch.sim import SimProblem
    problem = SimProblem(_linreg(base), n_workers=N, device="cpu")
    with pytest.raises(NotImplementedError, match="no simulator engine"):
        api.simulate("decentralized", problem)


@pytest.mark.parametrize("knob,value,error,match", [
    # one worker a rank needs a world of n_workers ranks: here none
    ("gossip_impl", "shard_map", RuntimeError,
     "4 workers need an initialised process group of 4 ranks"),
    ("gossip_impl", "ppermute", ValueError, "gossip_impl"),
    ("compression", "fp8", ValueError, "compression"),
    ("topology", "star", ValueError, "star"),
])
def test_unsupported_consensus_knobs_raise(knob, value, error, match):
    rc = _rc(base, _linreg(base))
    rc = rc.replace(consensus=dataclasses.replace(rc.consensus,
                                                  **{knob: value}))
    with pytest.raises(error, match=match):
        api.build(build_model(rc.model, device="cpu"), rc, device="cpu")


def test_other_refusals():
    model = build_model(_linreg(base), device="cpu")
    rc = _rc(base, _linreg(base))
    auto = rc.replace(consensus=dataclasses.replace(rc.consensus,
                                                    gossip_impl="auto"))
    assert api.build(model, auto, device="cpu").gossip_impl == "dense"
    with pytest.raises(ValueError, match="stochastic delay"):
        api.build(model, rc.replace(delay=base.DelayConfig(
            process="heavy_tail", tau_max=4)), device="cpu")
    with pytest.raises(ValueError, match="proximal"):
        api.build(model, rc.replace(ambdg=dataclasses.replace(
            rc.ambdg, proximal="l1")), device="cpu")
