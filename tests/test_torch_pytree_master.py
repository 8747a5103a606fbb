"""The port's pytree master against the JAX package and against the
port's own arena master, on numpy-seeded inputs.

  * Pytree dual averaging (``init``, ``prox_step``, ``update``) vs
    ``repro.core.dual_averaging`` on a nested tree of odd leaf sizes,
    six updates: ``l2`` bitwise (z, t and w). ``l2_ball`` with the
    projection active: z bitwise, w at rtol 2e-6, atol 1e-8 (JAX's own
    tolerance between its two masters, ``tests/test_arena.py``): the
    per-leaf norms are sums whose order differs between frameworks.
  * ``delayed.push_pop`` vs JAX's, run eagerly (as
    ``test_torch_variable_ring.py`` runs its ring code; ROADMAP C.4):
    f32 and int8, tau in {0, 1, 4}, 1 and 4 pods, 2(tau + 1) + 1
    steps: popped sums, counts and the whole buffer bitwise.
  * The port's pytree master against its arena master on
    ``tests/test_arena.py``'s odd leaf shapes and grid (tau in
    {0, 1, 4}, 1 and 4 pods, none and int8), ten steps: params and z
    bitwise in every cell, int8 with 4 pods included. (JAX holds that
    one cell to rtol 3e-6, atol 5e-7: XLA:CPU associates its fused pod
    folds differently in its two programs. Eager PyTorch runs both
    folds as the same left-to-right adds, so the port is bitwise.)
    Under ``l2_ball`` (tau 1, 1 and 4 pods, none and int8, six steps,
    the projection active): z bitwise, params at JAX's rtol 2e-6,
    atol 1e-8, since the two masters sum the ball norm in different
    orders.
  * ``train_step`` with ``master_impl="pytree"`` against JAX's on
    amb-linreg SMOKE and qwen1.5-0.5b SMOKE (f32), none and int8: JAX
    runs three steps, its whole state is carried across with
    ``convert``, one master update each from the same pod-stacked
    gradients agrees bit for bit (params, z, t, buffer), then both run
    two more steps on the same batches: counts exact, loss and grad
    norm to rtol 1e-5, params and z to 1e-5 of their largest element
    plus, under int8, one quantization step (the two frameworks'
    gradients differ in their last bits, as in ``test_torch_slice.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import base as jbase
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import anytime as janytime
from repro.core import delayed as jdelayed
from repro.core import dual_averaging as jda
from repro.data.pipeline import AnytimePipeline as JaxPipeline
from repro.models.api import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import api, convert
from repro_torch.configs import base, get_smoke_config
from repro_torch.core import ambdg, arena, delayed
from repro_torch.core import dual_averaging as da
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.models.api import build_model
from repro_torch.optim import make_arena_optimizer, make_optimizer

# odd, row-misaligned leaf sizes (tests/test_arena.py), and a scalar
SHAPES = {"a": (7,), "b": {"c": (3, 5), "d": (130,)}, "e": (257,), "s": ()}
eq = np.testing.assert_array_equal


def _np_tree(rng, lead=(), scale=1.0, shapes=SHAPES):
    return {k: (_np_tree(rng, lead, scale, v) if isinstance(v, dict) else
                (rng.standard_normal(lead + v) * scale).astype(np.float32))
            for k, v in shapes.items()}


def _t(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [torch.from_numpy(np.array(x))
                                    for x in leaves])


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _same(port_tree, jax_tree, check=eq):
    got = tree_flatten(port_tree)[0]
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        check(a.numpy(), np.asarray(b))


def _cfgs(proximal, **kw):
    kw = dict(tau=2, b_bar=8.0, smoothness_L=2.0, proximal=proximal, **kw)
    return base.AmbdgConfig(**kw), jbase.AmbdgConfig(**kw)


@pytest.mark.parametrize("proximal", ["l2", "l2_ball"])
def test_pytree_dual_averaging_matches_jax(proximal):
    cfg, jcfg = _cfgs(proximal, radius_C=0.5)
    rng = np.random.default_rng(0)
    params = _np_tree(rng)
    state, jstate = da.init(_t(params)), jda.init(_j(params))
    _same(state.z, jstate.z)
    assert state.t.dtype == torch.int32 and int(state.t) == int(jstate.t)
    projected = False
    for t in range(6):
        g = _np_tree(rng, scale=3.0)
        w, state = da.update(state, _t(g), cfg)
        jw, jstate = jda.update(jstate, _j(g), jcfg)
        _same(state.z, jstate.z)
        assert int(state.t) == int(jstate.t) == t + 1
        if proximal == "l2":
            _same(w, jw)
        else:
            _same(w, jw, lambda a, b: np.testing.assert_allclose(
                a, b, rtol=2e-6, atol=1e-8))
            norm = np.sqrt(sum(np.sum(np.square(x.numpy()))
                               for x in tree_flatten(w)[0]))
            projected = projected or abs(norm - 0.5) < 1e-5
    assert proximal == "l2" or projected, "the ball never projected"
    # prox_step alone, at one alpha
    a = da.alpha(torch.tensor(3.0), cfg)
    _same(da.prox_step(state.z, a, cfg),
          jda.prox_step(jstate.z, jda.alpha(jnp.float32(3.0), jcfg), jcfg),
          eq if proximal == "l2" else
          (lambda x, y: np.testing.assert_allclose(x, y, rtol=2e-6,
                                                   atol=1e-8)))


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("n_pods", [1, 4])
@pytest.mark.parametrize("tau", [0, 1, 4])
def test_push_pop_matches_jax(tau, n_pods, compression):
    rng = np.random.default_rng(tau * 10 + n_pods)
    params = _np_tree(rng)
    buf = delayed.init_buffer(_t(params), tau, n_pods, compression)
    jbuf = jdelayed.init_buffer(_j(params), tau, n_pods, compression)
    if tau == 0:      # the synchronous exchange: no buffer, one pod fold
        assert buf is None and jbuf is None
        g = _np_tree(rng, (n_pods,), 30.0)
        _same(arena.tree_map(delayed.pod_sum, _t(g)),
              jax.tree.map(jdelayed.pod_sum, _j(g)))
        return
    for step in range(2 * (tau + 1) + 1):
        g = _np_tree(rng, (n_pods,), 30.0)
        counts = np.full((n_pods,), 5.0 + step, np.float32)
        gs, c, buf = delayed.push_pop(buf, _t(g), torch.from_numpy(counts),
                                      compression)
        jgs, jc, jbuf = jdelayed.push_pop(jbuf, _j(g), jnp.asarray(counts),
                                          compression)
        _same(gs, jgs)
        assert c.item() == float(jc)
        assert (c.item() == 0.0) == (step < tau)
        _same(buf.grads, jbuf.grads)
        eq(buf.counts.numpy(), np.asarray(jbuf.counts))
        assert buf.head.dtype == torch.int32
        assert int(buf.head) == int(jbuf.head) == (step + 1) % tau
        if compression == "int8":
            assert tree_flatten(buf.grads)[0][0].dtype == torch.int8
            _same(buf.scales, jbuf.scales)
            _same(buf.residual, jbuf.residual)
        else:
            assert buf.scales is None and buf.residual is None


def _grid_rc(tau, compression):
    cfg = get_smoke_config("amb-linreg")
    return base.RunConfig(
        model=cfg, shape=base.TRAIN_4K,
        mesh=base.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=base.AmbdgConfig(tau=tau, b_bar=8.0, smoothness_L=2.0,
                               pod_compression=compression))


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("n_pods", [1, 4])
@pytest.mark.parametrize("tau", [0, 1, 4])
def test_pytree_master_equals_arena_master(tau, n_pods, compression):
    rc = _grid_rc(tau, compression)
    rng = np.random.default_rng(100 + tau + n_pods)
    params = _t(_np_tree(rng))
    layout = arena.make_layout(params)
    opt_p = make_optimizer(rc)
    opt_a = make_arena_optimizer(rc, layout, torch.device("cpu"))
    p_ref, o_ref = params, opt_p.init(params)
    buf = delayed.init_buffer(params, tau, n_pods, compression)
    p_ar, o_ar = params, opt_a.init()
    ar = arena.init_arena(layout, tau, n_pods, compression, device="cpu")
    for t in range(10):
        grads = _np_tree(rng, (n_pods,))
        counts = torch.full((n_pods,), 3.0 + t)
        p_ref, o_ref, buf, _, c_ref = ambdg.pytree_master_update(
            opt_p, p_ref, o_ref, buf, _t(grads), counts, compression)
        p_ar, o_ar, ar, _, c_ar = ambdg.arena_master_update(
            layout, opt_a, p_ar, o_ar, ar, _t(grads), counts, compression)
        assert c_ref.item() == c_ar.item()
        for a, b in zip(tree_flatten(p_ref)[0], tree_flatten(p_ar)[0]):
            assert torch.equal(a, b), (t, a, b)
        z_ar = arena.unflatten_tree(layout, o_ar.z, cast=False)
        for a, b in zip(tree_flatten(o_ref.z)[0], tree_flatten(z_ar)[0]):
            assert torch.equal(a, b), t
        assert int(o_ref.t) == int(o_ar.t) == t + 1


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("n_pods", [1, 4])
def test_pytree_master_near_arena_master_l2_ball(n_pods, compression):
    """Under ``l2_ball`` the arena master's ball norm is one flat sum and
    the pytree master's a sum of per-leaf sums, so with the projection
    active w agrees to JAX's tolerance between its two masters
    (``tests/test_arena.py``: rtol 2e-6, atol 1e-8); z, which the norm
    does not reach, stays bitwise."""
    rc = _grid_rc(1, compression)
    rc = rc.replace(ambdg=dataclasses.replace(rc.ambdg, proximal="l2_ball",
                                              radius_C=0.05))
    rng = np.random.default_rng(200 + n_pods)
    params = _t(_np_tree(rng))
    layout = arena.make_layout(params)
    opt_p = make_optimizer(rc)
    opt_a = make_arena_optimizer(rc, layout, torch.device("cpu"))
    p_ref, o_ref = params, opt_p.init(params)
    buf = delayed.init_buffer(params, 1, n_pods, compression)
    p_ar, o_ar = params, opt_a.init()
    ar = arena.init_arena(layout, 1, n_pods, compression, device="cpu")
    projected = 0
    for t in range(6):
        grads = _t(_np_tree(rng, (n_pods,)))
        counts = torch.full((n_pods,), 4.0)
        p_ref, o_ref, buf, _, _ = ambdg.pytree_master_update(
            opt_p, p_ref, o_ref, buf, grads, counts, compression)
        p_ar, o_ar, ar, _, _ = ambdg.arena_master_update(
            layout, opt_a, p_ar, o_ar, ar, grads, counts, compression)
        z_ar = arena.unflatten_tree(layout, o_ar.z, cast=False)
        for a, b in zip(tree_flatten(o_ref.z)[0], tree_flatten(z_ar)[0]):
            assert torch.equal(a, b), t
        for a, b in zip(tree_flatten(p_ref)[0], tree_flatten(p_ar)[0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-6,
                                       atol=1e-8)
        norm = np.sqrt(sum(np.sum(np.square(x.numpy()))
                           for x in tree_flatten(p_ref)[0]))
        projected += abs(norm - 0.05) < 1e-5
    assert projected >= 4, "the ball never projected"


N_WORKERS, SPW, SEQ = 4, 2, 32


def _rcs(arch, compression):
    if arch == "amb-linreg":
        jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
        extra = {}
    else:
        jcfg = dataclasses.replace(jax_smoke_config(arch),
                                   compute_dtype="float32")
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        extra = dict(shape=dict(seq_len=SEQ, global_batch=N_WORKERS * SPW))

    def rc(cfgs, model_cfg):
        shape = cfgs.TRAIN_4K
        if extra:
            shape = dataclasses.replace(shape, **extra["shape"])
        return cfgs.RunConfig(
            model=model_cfg, shape=shape,
            mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
            ambdg=cfgs.AmbdgConfig(tau=2, n_microbatches=2, b_bar=8.0,
                                   smoothness_L=8.0, proximal="l2",
                                   pod_compression=compression),
            master_impl="pytree")
    return (jcfg, rc(jbase, jcfg)), (cfg, rc(base, cfg))


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("arch", ["amb-linreg", "qwen1.5-0.5b"])
def test_pytree_train_step_matches_jax(arch, compression):
    (jcfg, jrc), (cfg, rc) = _rcs(arch, compression)
    seq = SEQ if arch != "amb-linreg" else 0
    js = japi.build(jax_build_model(jcfg), jrc)
    ps = api.build(build_model(cfg, device="cpu"), rc, device="cpu")
    jpipe = JaxPipeline(jcfg, N_WORKERS, SPW, seq_len=seq, seed=0)
    pipe = AnytimePipeline(cfg, N_WORKERS, SPW, seq_len=seq, seed=0)
    jstate = js.init_state(jax.random.PRNGKey(0))
    for _ in range(3):        # eager: the JAX pytree master unjitted
        jstate, _ = js.train_step(jstate, _j(jpipe.next_global_batch()))
        pipe.next_global_batch()
    jstate = jax.device_get(jstate)
    pstate = convert.train_state_from_jax(jstate, device="cpu")
    assert pstate.arena is None and isinstance(pstate.buffer,
                                               delayed.DelayBuffer)
    assert isinstance(pstate.opt_state, da.DualAveragingState)
    _same(pstate.opt_state.z, jstate.opt_state.z)
    jstate = jax.tree.map(jnp.asarray, jstate)

    # one master update each from the same pod-stacked gradients: bitwise
    rng = np.random.default_rng(5)
    leaves, treedef = tree_flatten(pstate.params)
    grads = [(rng.standard_normal((1,) + tuple(x.shape)) * 3).astype(
        np.float32) for x in leaves]
    counts = np.array([13.0], np.float32)
    jgrads = jax.tree.unflatten(jax.tree.structure(jstate.params),
                                [jnp.asarray(g) for g in grads])
    jgs, jc, jbuf = jdelayed.push_pop(jstate.buffer, jgrads,
                                      jnp.asarray(counts), compression)
    jp, jo = jax_make_optimizer(jrc).update(
        jstate.opt_state, jstate.params, janytime.normalize(jgs, jc))
    pp, po, pbuf, _, pc = ambdg.pytree_master_update(
        make_optimizer(rc), pstate.params, pstate.opt_state, pstate.buffer,
        tree_unflatten(treedef, [torch.from_numpy(g) for g in grads]),
        torch.from_numpy(counts), compression)
    assert pc.item() == float(jc) > 0
    _same(pp, jp)
    _same(po.z, jo.z)
    assert int(po.t) == int(jo.t)
    for f in ("grads",) + (("scales", "residual")
                           if compression == "int8" else ()):
        _same(getattr(pbuf, f), getattr(jbuf, f))
    eq(pbuf.counts.numpy(), np.asarray(jbuf.counts))
    assert int(pbuf.head) == int(jbuf.head)

    # then two steps of each package's train_step on the same batches
    jstate = jstate._replace(params=jp, opt_state=jo, buffer=jbuf)
    pstate = pstate._replace(params=pp, opt_state=po, buffer=pbuf)
    q_step = 0.0
    for _ in range(2):
        batch, jbatch = pipe.next_global_batch(), jpipe.next_global_batch()
        for k in batch:
            eq(batch[k], jbatch[k])
        jstate, jm = js.train_step(jstate, _j(batch))
        pstate, pm = ps.train_step(pstate, _t(batch))
        count = pm["applied_count"].item()
        assert count == float(jm["applied_count"]) > 0
        assert pm["local_count"].item() == float(jm["local_count"])
        q_now = 0.0
        if compression == "int8":
            s_max = max(float(s.max())
                        for s in tree_flatten(pstate.buffer.scales)[0])
            q_now = s_max / count
            q_step = max(q_step, q_now)
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   atol=q_now)
    for port_tree, jax_tree in ((pstate.opt_state.z, jstate.opt_state.z),
                                (pstate.params, jstate.params)):
        for a, b in zip(tree_flatten(port_tree)[0],
                        jax.tree.leaves(jax_tree)):
            b = np.asarray(b)
            assert np.all(np.isfinite(a.numpy()))
            # w = -alpha z with alpha < 1: z's limit covers w
            np.testing.assert_allclose(
                a.numpy(), b, rtol=0,
                atol=1e-5 * np.abs(b).max() + q_step)
