"""The port's sgd and adam optimizers (``repro_torch.optim``), its
dynamic-trip accumulation (``core.anytime.accumulate_while``) and the
deprecated AMB alias (``core.amb``), against the JAX package on the CPU.

The optimizers repeat JAX's arithmetic op for op in f32: the same
numpy-seeded parameters and gradients give the same parameters after 5
steps to rtol 1e-6, atol 1e-9 (XLA and PyTorch evaluate adam's f32
``b ** t`` with their own ``pow``, which may differ by an ulp; the
multiplies, divisions and square roots are correctly rounded in both).
The arena forms equal the pytree forms bit for bit (the same operations
on the same values, as JAX's ``tests/test_arena.py`` holds them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import anytime as janytime
from repro.core import arena as jarena
from repro.data.pipeline import AnytimePipeline as JaxPipeline
from repro.models.api import build_model as jax_build_model
from repro.optim import make_arena_optimizer as jax_arena_optimizer
from repro.optim import make_optimizer as jax_optimizer
from repro_torch import api, convert
from repro_torch.configs import base
from repro_torch.configs import get_smoke_config
from repro_torch.core import anytime, arena
from repro_torch.core.amb import make_amb_train_step
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.models.api import build_model
from repro_torch.optim import make_arena_optimizer, make_optimizer
from repro_torch.train import checkpoint

SHAPES = {"w": (37, 5), "b": (5,), "layer": {"k": (3, 4, 6)}}
N_STEPS = 5


def _rc(cfgs, optimizer, **ambdg):
    return cfgs.RunConfig(model=(jax_smoke_config if cfgs is jbase else
                                 get_smoke_config)("amb-linreg"),
                          shape=cfgs.TRAIN_4K, optimizer=optimizer,
                          ambdg=cfgs.AmbdgConfig(**ambdg))


def _tree(rng, shapes, scale=1.0):
    return {k: (_tree(rng, v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32))
            for k, v in shapes.items()}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    return [x for k in sorted(tree) for x in
            (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _close(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


def _grad_steps(seed=1):
    """N_STEPS (pod-stacked gradient tree (2, ...), count) pairs."""
    rng = np.random.default_rng(seed)
    return [(_tree(rng, _map(lambda s: (2,) + s, SHAPES), scale=30.0),
             np.float32(6.0 + t)) for t in range(N_STEPS)]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_pytree_optimizers_match_jax(optimizer):
    params = _tree(np.random.default_rng(0), SHAPES)
    jopt, opt = (jax_optimizer(_rc(jbase, optimizer)),
                 make_optimizer(_rc(base, optimizer)))
    jp, p = _map(jnp.asarray, params), _map(torch.from_numpy, params)
    js, s = jopt.init(jp), opt.init(p)
    for g_pods, count in _grad_steps():
        g = _map(lambda x: x.sum(0) / np.float32(count), g_pods)
        jp, js = jopt.update(js, jp, _map(jnp.asarray, g))
        p, s = opt.update(s, p, _map(torch.from_numpy, g))
        _close(_map(lambda x: x.numpy(), p), jp)
    if optimizer == "adam":
        assert int(s[2]) == int(js[2]) == N_STEPS
        assert s[2].dtype == torch.int32


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_arena_optimizers_match_jax_and_the_pytree_forms(optimizer):
    """The flat-state forms against JAX's arena forms (5 steps, the
    tolerance above) and against the port's own pytree forms, bit for
    bit, on the same popped sums and counts."""
    params = _tree(np.random.default_rng(0), SHAPES)
    jp, p = _map(jnp.asarray, params), _map(torch.from_numpy, params)
    jlayout, layout = jarena.make_layout(jp), arena.make_layout(p)
    jopt = jax_arena_optimizer(_rc(jbase, optimizer), jlayout)
    opt = make_arena_optimizer(_rc(base, optimizer), layout, "cpu")
    tree_opt = make_optimizer(_rc(base, optimizer))
    js, s, ts, tp = jopt.init(), opt.init(), tree_opt.init(p), p
    for g_pods, count in _grad_steps():
        g_sum = arena.flatten_tree(layout, _map(torch.from_numpy, g_pods),
                                   leading=1).sum(0)
        jg_sum = jarena.flatten_tree(jlayout, _map(jnp.asarray, g_pods),
                                     leading=1).sum(0)
        c = torch.tensor(count)
        jp, js = jopt.update(js, jp, jg_sum, jnp.float32(count))
        p, s = opt.update(s, p, g_sum, c)
        tp, ts = tree_opt.update(
            ts, tp, anytime.normalize(arena.unflatten_tree(
                layout, g_sum, cast=False), c))
        _close(_map(lambda x: x.numpy(), p), jp)
        for a, b in zip(_leaves(p), _leaves(tp)):
            assert torch.equal(a, b)


def _linreg_strategy(rc):
    model = build_model(rc.model, device="cpu")
    return model, api.build(model, rc, device="cpu")


def _batches(n, seed=0):
    pipe = AnytimePipeline(get_smoke_config("amb-linreg"), 4, 8, seed=seed)
    return [{k: torch.from_numpy(v) for k, v in
             pipe.next_global_batch().items()} for _ in range(n)]


def test_adam_state_survives_a_checkpoint_round_trip(tmp_path):
    """(m, v, t) of the arena adam through ``train/checkpoint.py``: the
    restored run's next two steps equal the uninterrupted run's, bit for
    bit."""
    rc = _rc(base, "adam", tau=1, n_microbatches=2)
    _, strategy = _linreg_strategy(rc)
    batches = _batches(5)
    state = strategy.init_state(torch.Generator().manual_seed(0))
    for b in batches[:3]:
        state, _ = strategy.train_step(state, b)
    checkpoint.save(str(tmp_path), 3, state)
    restored, _ = checkpoint.restore(str(tmp_path), strategy.init_state())
    m, v, t = restored.opt_state
    assert t.dtype == torch.int32 and int(t) == 3
    assert torch.equal(m, state.opt_state[0])
    assert torch.equal(v, state.opt_state[1])
    for b in batches[3:]:
        state, _ = strategy.train_step(state, b)
        restored, _ = strategy.train_step(restored, b)
    for a, b in zip(_leaves(state.params), _leaves(restored.params)):
        assert torch.equal(a, b)
    for a, b in zip(state.opt_state, restored.opt_state):
        assert torch.equal(a, b)


def _linreg_pair():
    """JAX's and the port's linreg SMOKE at the same parameters, and one
    batch of 32 samples."""
    jmodel = jax_build_model(jax_smoke_config("amb-linreg"))
    model = build_model(get_smoke_config("amb-linreg"), device="cpu")
    rng = np.random.default_rng(2)
    host_params = {"w": rng.standard_normal(
        get_smoke_config("amb-linreg").linreg_dim).astype(np.float32)}
    jparams = _map(jnp.asarray, host_params)
    params = convert.params_from_jax(host_params, device="cpu")
    host = JaxPipeline(jax_smoke_config("amb-linreg"), 4, 8,
                       seed=3).next_global_batch()
    return (jmodel, jparams, {k: jnp.asarray(v) for k, v in host.items()},
            model, params, {k: torch.from_numpy(np.asarray(v))
                            for k, v in host.items()})


@pytest.mark.parametrize("n_active", [4, 2])
def test_accumulate_while_matches_jax(n_active):
    """The first ``n_active`` of 4 microbatches: grad sums to JAX's at
    rtol 1e-5 (the matmuls sum in different orders), counts and loss
    sums likewise; at n_active = n_mb the same values as the masked
    accumulation, bit for bit."""
    jmodel, jparams, jbatch, model, params, batch = _linreg_pair()
    jg, jc, jm = janytime.accumulate_while(jmodel.loss, jparams, jbatch, 4,
                                           jnp.int32(n_active))
    g, c, m = anytime.accumulate_while(model.loss, params, batch, 4,
                                       torch.tensor(n_active))
    for a, b in zip(_leaves(g), _leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert float(c) == float(jc)
    np.testing.assert_allclose(float(m["loss_sum"]), float(jm["loss_sum"]),
                               rtol=1e-5)
    gs, cs, ms = anytime.accumulate_scan(model.loss, params, batch, 4)
    if n_active == 4:
        assert all(torch.equal(a, b) for a, b in zip(_leaves(g),
                                                    _leaves(gs)))
        assert torch.equal(c, cs) and torch.equal(m["loss_sum"],
                                                  ms["loss_sum"])
    else:
        assert float(c) < float(cs)
    with pytest.raises(ValueError, match="n_active"):
        anytime.accumulate_while(model.loss, params, batch, 4, 5)


def test_while_dynamic_steps_as_scan_masked_and_reads_n_active():
    """``anytime_impl="while_dynamic"`` through ``api.build``: without
    ``batch["n_active"]`` (and with n_active = n_mb) every step equals
    "scan_masked" bit for bit; with fewer microbatches the step counts
    fewer samples."""
    import dataclasses
    rc = _rc(base, "dual_averaging", tau=1, n_microbatches=4)
    wrc = rc.replace(ambdg=dataclasses.replace(rc.ambdg,
                                               anytime_impl="while_dynamic"))
    runs = {}
    for name, r, extra in (("scan", rc, {}), ("while", wrc, {}),
                           ("while_full", wrc,
                            {"n_active": torch.tensor(4)})):
        _, strategy = _linreg_strategy(r)
        state = strategy.init_state(torch.Generator().manual_seed(0))
        for b in _batches(3):
            state, metrics = strategy.train_step(state, {**b, **extra})
        runs[name] = (state, metrics)
    for name in ("while", "while_full"):
        for a, b in zip(_leaves(runs[name][0].params),
                        _leaves(runs["scan"][0].params)):
            assert torch.equal(a, b), name
    _, strategy = _linreg_strategy(wrc)
    state = strategy.init_state(torch.Generator().manual_seed(0))
    b = _batches(1)[0]
    _, full = strategy.train_step(state, b)
    _, half = strategy.train_step(state, {**b, "n_active": torch.tensor(2)})
    assert float(half["local_count"]) == float(full["local_count"]) / 2


def test_amb_alias_equals_the_amb_strategy():
    """``make_amb_train_step`` (JAX's deprecated alias) steps exactly as
    ``api.build(model, rc.replace(strategy="amb"))``, bit for bit."""
    rc = _rc(base, "dual_averaging", tau=2, n_microbatches=2)
    model, strategy = _linreg_strategy(rc.replace(strategy="amb"))
    init, step = make_amb_train_step(model, rc)
    a = init(torch.Generator().manual_seed(0))
    b = strategy.init_state(torch.Generator().manual_seed(0))
    for batch in _batches(3):
        a, ma = step(a, batch)
        b, mb = strategy.train_step(b, batch)
        assert float(ma["loss"]) == float(mb["loss"])
        for x, y in zip(_leaves(a.params), _leaves(b.params)):
            assert torch.equal(x, y)
