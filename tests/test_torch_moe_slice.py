"""The MoE slice against the JAX package: mixtral-8x7b and mixtral-8x22b
at their SMOKE widths (4 experts, top 2, a sliding window of 32), f32
compute, JAX's weights carried across with ``convert.params_from_jax``.

  * ``forward``: the logits and the summed aux loss at S = 64 (twice the
    window, so the window masks), and ``lm_loss`` with the aux loss in
    it (``loss_sum`` free of it), within 1e-5 of the largest;
  * the worker's gradient at the init weights, leaf by leaf, against
    ``jax.grad``: within 1e-4 of each leaf's largest element;
  * (AMB-DG through ``api.build`` is ``test_torch_moe_train.py``, a
    file of its own so that the test run can spread the two);
  * ``decode_step`` for 40 steps from a zero f32 cache, with a scalar
    position and with ragged per-slot positions: the rolling buffer of
    32 slots wraps at step 32 (scalar) and 27 (the slot at t + 5). Each
    step's logits and the final cache within 1e-5 of the largest;
  * the engine's greedy tokens equal JAX's ``Engine.generate``
    (``tests/test_serve.py``'s test) for 40 new tokens past prompts of
    4, 7 and 5 tokens, with f32 caches: past the wrap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro.serve import Engine as JEngine
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.anytime import accumulate_scan
from repro_torch.core.arena import tree_flatten
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model
from repro_torch.serve import Engine

ARCHS = ["mixtral-8x7b", "mixtral-8x22b"]
SEQ = 64
B, MAX_LEN, DECODE_STEPS = 3, 64, 40


def _f32(cfg_fn, arch):
    return dataclasses.replace(cfg_fn(arch), compute_dtype="float32")


def _models(arch):
    jcfg, cfg = _f32(jax_smoke_config, arch), _f32(get_smoke_config, arch)
    jparams, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) or 1.0
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, (what, gap, scale)


def _tokens(cfg, seed=1, batch=2, seq=SEQ):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_loss_match_jax(arch):
    jcfg, cfg, jparams, params = _models(arch)
    toks = _tokens(cfg)
    jlogits, jaux = jax.jit(lambda p, t: jtf.forward(p, jcfg, t))(
        jparams, jnp.asarray(toks))
    with torch.no_grad():
        logits, aux = tf.forward(params, cfg, torch.from_numpy(toks))
    _close(logits, jlogits, 1e-5, "logits")
    assert float(jaux) > 0
    _close(aux, jaux, 1e-5, "aux")
    w = np.array([1.0, 0.0], np.float32)      # a masked sample too
    batch = {"tokens": toks, "weights": w}
    jloss, jm = jax.jit(lambda p, b: jtf.lm_loss(p, jcfg, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, m = tf.lm_loss(params, cfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    _close(loss, jloss, 1e-5, "loss")
    _close(m["loss_sum"], jm["loss_sum"], 1e-5, "loss_sum")
    assert float(m["count"]) == float(jm["count"]) == SEQ - 1
    # the loss carries aux times the count; loss_sum does not
    np.testing.assert_allclose(float(loss) - float(m["loss_sum"]),
                               float(aux) * (SEQ - 1), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_matches_jax(arch):
    jcfg, cfg, jparams, params = _models(arch)
    toks = _tokens(cfg, seed=2)
    w = np.ones((2,), np.float32)
    jgrad = jax.jit(jax.grad(lambda p: jtf.lm_loss(p, jcfg, {
        "tokens": jnp.asarray(toks), "weights": jnp.asarray(w)})[0]))(
            jparams)
    model = build_model(cfg, device="cpu")
    g, _, _ = accumulate_scan(model.loss, params,
                              {"tokens": torch.from_numpy(toks),
                               "weights": torch.from_numpy(w)}, 1)
    leaves = tree_flatten(g)[0]
    jleaves = jax.tree.leaves(jgrad)
    assert len(leaves) == len(jleaves)
    for i, (a, b) in enumerate(zip(leaves, jleaves)):
        _close(a, b, 1e-4, f"leaf {i}")
    names = [p for p, _ in jax.tree_util.tree_flatten_with_path(jgrad)[0]]
    assert any("w_router" in str(n) for n in names)


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_past_the_window_matches_jax(arch, ragged):
    jcfg, cfg, jparams, params = _models(arch)
    jcache, _ = jtf.init_decode_state(jcfg, B, MAX_LEN, jnp.float32)
    model = build_model(cfg, device="cpu")
    cache, _ = model.init_decode_state(B, MAX_LEN, torch.float32)
    assert cache["k"].shape[2] == cfg.sliding_window == 32   # rolling
    jstep = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, jcfg, c, t, pos))
    rng = np.random.default_rng(11)
    for t in range(DECODE_STEPS):
        toks = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = (np.array([t, t + 3, t + 5], np.int32) if ragged
               else np.int32(t))
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(toks),
                                jnp.asarray(pos))
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(toks), torch.as_tensor(pos))
        _close(logits, jlogits, 1e-5, f"logits at step {t}")
    for c, j in zip(tree_flatten(cache)[0], jax.tree.leaves(jcache)):
        _close(c, j, 1e-5, "cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_past_the_window_equal_jax(arch):
    jcfg = _f32(jax_smoke_config, arch)
    jengine = JEngine(jax_build_model(jcfg), 3, 48)
    engine = Engine(build_model(_f32(get_smoke_config, arch), device="cpu"),
                    3, 48)
    engine.params = convert.params_from_jax(jax.device_get(jengine.params),
                                            device="cpu")
    jengine.cache, _ = jengine.model.init_decode_state(3, 48, jnp.float32)
    jengine._cache0, _ = jengine.model.init_decode_state(3, 48, jnp.float32)
    engine.cache, _ = engine.model.init_decode_state(3, 48, torch.float32)
    engine._cache0, _ = engine.model.init_decode_state(3, 48, torch.float32)
    assert engine.cache["k"].shape[2] == 32
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, jcfg.vocab_size, size=n))
               for n in (4, 7, 5)]
    want = jengine.generate(prompts, max_new=DECODE_STEPS)
    got = engine.generate(prompts, max_new=DECODE_STEPS)
    assert got == want
    assert [len(o) for o in got] == [n + DECODE_STEPS for n in (4, 7, 5)]
    assert dataclasses.asdict(engine.stats) == \
        dataclasses.asdict(jengine.stats)
