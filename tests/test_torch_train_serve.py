"""Train-while-serve in the port against the JAX package, on the CPU:
the train loop's publish hook (``rc.serve.publish_period``), the
publisher in checkpoints, ``_served_params`` across the strategies' state
layouts, and an engine serving what ``train`` published.

The loop runs linear regression (d = 300: three arena rows) from one
config in both packages. Publish steps and counts are exact; the
published snapshots dequantize within one int8 step of JAX's (the
weights agree to 1e-4 of the largest, ``tests/test_torch_scenarios.py``,
and a last-bit difference can flip one rounding, as ROADMAP C.12 notes
for the int8 gossip). A restart from a checkpoint carries the publisher
bit for bit.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import base as jbase
from repro.models.api import build_model as jax_build_model
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro_torch import api
from repro_torch.configs import base
from repro_torch.configs import get_smoke_config
from repro_torch.core.arena import flatten_tree, tree_flatten
from repro_torch.models.api import build_model
from repro_torch.optim.compression import quantize_int8_rows
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as tloop

DIM = 300
LOOP = dict(n_workers=4, samples_per_worker=16, log_every=1)


def _rc(cfgs, compression="none", period=2, bound=4, strategy="ambdg"):
    cfg = cfgs.ModelConfig(name="linreg", family=cfgs.LINREG, n_layers=0,
                           d_model=0, n_heads=0, n_kv_heads=0, d_ff=0,
                           vocab_size=0, linreg_dim=DIM)
    return cfgs.RunConfig(
        model=cfg, shape=cfgs.TRAIN_4K, strategy=strategy,
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(t_p=2.5, t_c=10.0, tau=2, smoothness_L=1.0,
                               b_bar=60.0, proximal="l2_ball",
                               radius_C=1.05 * math.sqrt(DIM),
                               pod_compression=compression),
        consensus=cfgs.ConsensusConfig(n_workers=4, rounds=2),
        serve=cfgs.ServeConfig(publish_period=period, staleness_bound=bound))


def _train(rc, n_steps=10, **kw):
    return tloop.train(build_model(rc.model, device="cpu"), rc,
                       tloop.LoopConfig(n_steps=n_steps, **LOOP, **kw),
                       device="cpu")


def _dequantized(ring, scales):
    return np.asarray(ring, np.float32) * np.asarray(
        scales, np.float32)[..., None]


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_train_publishes_as_jax(compression):
    jrc, prc = _rc(jbase, compression), _rc(base, compression)
    jout = jloop.train(jax_build_model(jrc.model), jrc,
                       jloop.LoopConfig(n_steps=10, **LOOP))
    pout = _train(prc)
    jpub, pub = jout["publisher"], pout["publisher"]
    assert pub.seq == jpub.seq == 5
    np.testing.assert_array_equal(pub.pub_step, jpub.pub_step)
    assert sorted(pub.pub_step.tolist()) == [6, 8, 10]
    got = _dequantized(pub.ring.numpy(), pub.scales.float().numpy())
    want = _dequantized(np.asarray(jpub.ring),
                        np.asarray(jpub.scales.astype(np.float32)))
    w = np.asarray(jout["state"].params["w"])
    step = np.maximum(pub.scales.float().numpy(),
                      np.asarray(jpub.scales.astype(np.float32)))[..., None]
    assert np.all(np.abs(got - want) <= step + 1e-4 * np.abs(w).max())
    # the freshest slot holds the final weights, quantized
    k = pub.due_slot(10)
    assert pub.pub_step[k] == 10
    q, s = quantize_int8_rows(flatten_tree(pub.layout,
                                           pout["state"].params),
                              scale_dtype=torch.bfloat16)
    assert torch.equal(pub.ring[k], q)
    assert torch.equal(pub.scales[k].view(torch.int16), s.view(torch.int16))


def test_restart_carries_the_publisher_bit_for_bit(tmp_path):
    rc = _rc(base, "int8", period=2, bound=5)
    whole = _train(rc, 12, ckpt_dir=str(tmp_path / "whole"), ckpt_every=5)
    _train(rc, 5, ckpt_dir=str(tmp_path / "split"), ckpt_every=5)
    rest = _train(rc, 12, ckpt_dir=str(tmp_path / "split"), ckpt_every=5)
    a, b = rest["publisher"], whole["publisher"]
    assert torch.equal(a.ring, b.ring)
    assert torch.equal(a.scales.view(torch.int16), b.scales.view(torch.int16))
    np.testing.assert_array_equal(a.pub_step, b.pub_step)
    assert (a.seq, a.pops, a.misses) == (b.seq, b.pops, b.misses) == (6, 0, 0)
    assert torch.equal(rest["state"].params["w"], whole["state"].params["w"])
    with open(tmp_path / "split" / "step_000000010" / "manifest.json") as f:
        extra = json.load(f)["extra"]
    assert extra["publisher"]["ring"] == {ckpt.NPZ_REF:
                                          "extra:/publisher/ring"}
    assert extra["publisher"]["seq"] == 5


def test_jax_restores_the_state_of_a_port_checkpoint_with_a_publisher(
        tmp_path):
    """The arrays of ``extra`` sit in state.npz beside the state's leaves:
    JAX's ``restore`` reads the state as it reads its own checkpoints.
    JAX's own ``save`` of a publisher fails (ROADMAP C.13)."""
    rc, jrc = _rc(base), _rc(jbase)
    out = _train(rc, 4, ckpt_dir=str(tmp_path / "port"), ckpt_every=4)
    template = japi.build(jax_build_model(jrc.model), jrc).init_state(
        jax.random.PRNGKey(0))
    jstate, jextra = jckpt.restore(str(tmp_path / "port"), template)
    np.testing.assert_array_equal(np.asarray(jstate.params["w"]),
                                  out["state"].params["w"].numpy())
    assert jextra["step"] == 4
    with pytest.raises(TypeError, match="JSON serializable"):
        jloop.train(jax_build_model(jrc.model), jrc, jloop.LoopConfig(
            n_steps=2, ckpt_dir=str(tmp_path / "jax"), ckpt_every=2, **LOOP))


@pytest.mark.parametrize("strategy", ["ambdg", "kbatch", "decentralized"])
def test_served_params_across_strategy_states(strategy):
    rc = _rc(base, strategy=strategy, period=1, bound=0)
    out = _train(rc, 3)
    state = out["state"]
    served = tloop._served_params(state, strategy)
    if strategy == "kbatch":
        want = state.base.params
    elif strategy == "decentralized":
        assert state.params["w"].shape == (4, DIM)
        want = {"w": state.params["w"][0]}
    else:
        want = state.params
    assert torch.equal(served["w"], want["w"])
    pub = out["publisher"]
    assert (pub.seq, pub.n_slots) == (3, 1)
    q, _ = quantize_int8_rows(flatten_tree(pub.layout, want),
                              scale_dtype=torch.bfloat16)
    assert torch.equal(pub.ring[0], q)


def test_engine_serves_what_train_published():
    """An engine attached to ``train``'s publisher (qwen1.5-0.5b SMOKE, 2
    workers x 2 sequences of 32, 4 steps, publish every 2, bound 3)
    refreshes to the freshest due snapshot, the popped weights equal the
    ring's dequantization, and the staleness stays within the bound."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    rc = base.RunConfig(
        model=cfg, shape=dataclasses.replace(base.TRAIN_4K, seq_len=32),
        ambdg=base.AmbdgConfig(tau=1, n_microbatches=1),
        serve=base.ServeConfig(slots=2, max_len=16, max_new=2,
                               publish_period=2, staleness_bound=3,
                               arrival_rate=1.0, seed=2))
    model = build_model(cfg, device="cpu")
    out = tloop.train(model, rc, tloop.LoopConfig(
        n_steps=4, n_workers=2, samples_per_worker=2, log_every=1),
        device="cpu")
    pub = out["publisher"]
    engine, queue = api.serve(model, rc, publisher=pub, device="cpu")
    stales = []
    for now in range(4, 9):
        stales.append(engine.refresh_weights(now))
        queue.step()
        engine.step(queue)
    assert stales == [0, 1, 2, 3, None]
    assert engine.stats.staleness_max == 3 <= rc.serve.staleness_bound
    assert (engine.stats.publish_pops, engine.stats.publish_misses) == (4, 1)
    want = pub.dequantize(pub.due_slot(7))
    for a, b in zip(tree_flatten(engine.params)[0], tree_flatten(want)[0]):
        assert torch.equal(a, b)
