"""The port's gradient arena and arena dual averaging against the JAX
package, on numpy-seeded inputs.

  * ``ArenaLayout`` (rows, offsets, row -> leaf), ``flatten_tree`` /
    ``unflatten_tree`` and ``row_scales`` vs ``repro.core.arena`` on a
    multi-leaf tree with a scalar leaf and leaves that are not a
    multiple of 128: bitwise.
  * ``push_pop`` on ring layout v2 for tau in {1, 4}, P in {1, 3},
    compression none/int8, over 2(tau+1) steps so the ring wraps twice:
    ring slots, scales, residual, counts, popped sum and count bitwise
    per step. The JAX side is ``repro.core.arena.push_pop`` called
    directly, off any sharding profile, so it folds pods left to right
    as the port does (``repro/core/delayed.py:79-82``).
  * ``update_arena``: ``l2`` bitwise; ``l2_ball`` within two ulps per
    element (its ball norm is a flat sum whose order differs between
    frameworks, which can move the projection factor by one ulp; the
    JAX suite holds its own two master paths to rtol 2e-6 there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AmbdgConfig as JaxAmbdgConfig
from repro.core import arena as jarena
from repro.core import dual_averaging as jda
from repro_torch.configs.base import AmbdgConfig
from repro_torch.core import arena
from repro_torch.core import dual_averaging as da

SHAPES = {"a": (9,), "b": (33, 7), "c": (140,), "s": ()}


def _tree(rng, lead=()):
    return {k: rng.standard_normal(lead + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _layouts():
    zeros = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    return arena.make_layout(_t(zeros)), jarena.make_layout(_j(zeros))


def test_layout_matches_jax():
    lt, lj = _layouts()
    assert lt.rows == lj.rows == 256
    for f in ("sizes", "row_counts", "row_offsets", "n_leaves", "shapes"):
        assert getattr(lt, f) == getattr(lj, f), f
    np.testing.assert_array_equal(lt.row_to_leaf, lj.row_to_leaf)


@pytest.mark.parametrize("leading", [0, 1])
def test_flatten_unflatten_row_scales_bitwise(leading):
    lt, lj = _layouts()
    rng = np.random.default_rng(leading)
    tree = _tree(rng, lead=(3,) * leading)
    ft = arena.flatten_tree(lt, _t(tree), leading=leading)
    fj = jarena.flatten_tree(lj, _j(tree), leading=leading)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    scale = np.float32(-0.37)
    back_t = arena.unflatten_tree(lt, ft, cast=False,
                                  scale=torch.tensor(scale))
    back_j = jarena.unflatten_tree(lj, fj, cast=False, scale=scale)
    for k in SHAPES:
        assert tuple(back_t[k].shape) == np.asarray(back_j[k]).shape
        np.testing.assert_array_equal(back_t[k].numpy(),
                                      np.asarray(back_j[k]))
    if leading:
        # row_scales of an error-fed gradient: fed = g + residual
        res = (rng.standard_normal(ft.shape) * 1e-3).astype(np.float32)
        res[..., lt.rows - 8:, :] = 0.0
        fed_t = ft + torch.from_numpy(res)
        fed_j = fj + jnp.asarray(res)
        np.testing.assert_array_equal(
            arena.row_scales(lt, fed_t).numpy(),
            np.asarray(jarena.row_scales(lj, fed_j)))


def _grads(t, n_pods):
    return _tree(np.random.default_rng(1000 + t), lead=(n_pods,))


def _assert_arena_equal(at, aj):
    for st, sj in zip(at.ring, aj.ring):
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if aj.scales is not None:
        for st, sj in zip(at.scales, aj.scales):
            np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(at.residual.numpy(),
                                      np.asarray(aj.residual))
    np.testing.assert_array_equal(at.counts.numpy(), np.asarray(aj.counts))
    assert at.phase == aj.phase and int(at.head) == int(aj.head)


@pytest.mark.parametrize("tau", [1, 4])
@pytest.mark.parametrize("n_pods", [1, 3])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_push_pop_v2_bitwise_over_wrapped_ring(tau, n_pods, compression):
    lt, lj = _layouts()
    at = arena.init_arena(lt, tau, n_pods, compression, device="cpu")
    aj = jarena.init_arena(lj, tau, n_pods, compression)
    _assert_arena_equal(at, aj)
    for t in range(2 * (tau + 1)):
        g = _grads(t, n_pods)
        counts = np.arange(1, n_pods + 1, dtype=np.float32) * (t + 1)
        gs_t, c_t, at = arena.push_pop(lt, at, _t(g),
                                       torch.from_numpy(counts), compression)
        gs_j, c_j, aj = jarena.push_pop(lj, aj, _j(g), jnp.asarray(counts),
                                        compression)
        np.testing.assert_array_equal(gs_t.numpy(), np.asarray(gs_j))
        assert c_t.item() == float(c_j)
        _assert_arena_equal(at, aj)
        if t >= tau:   # the popped entry is the one pushed tau steps ago
            assert c_t.item() == float(np.sum(
                np.arange(1, n_pods + 1) * (t - tau + 1)))


def _update_inputs(layout, seed):
    """z and g in arena form (pad lanes and rows zero, as in any arena)."""
    rng = np.random.default_rng(seed)
    z = arena.flatten_tree(layout, _t(_tree(rng)))
    g = arena.flatten_tree(layout, _t(_tree(rng))) * 50
    return z.numpy(), g.numpy()


@pytest.mark.parametrize("proximal", ["l2", "l2_ball"])
@pytest.mark.parametrize("count", [0.0, 611.0])
def test_update_arena_matches_jax(proximal, count):
    lt, lj = _layouts()
    z, g = _update_inputs(lt, seed=int(count))
    # radius 5 makes the ball projection active (||w|| ~ 6-60 here)
    kw = dict(tau=4, b_bar=800.0, smoothness_L=1.0, proximal=proximal,
              radius_C=5.0)
    st = da.ArenaDualAveragingState(z=torch.from_numpy(z.copy()),
                                    t=torch.tensor(6, dtype=torch.int32))
    sj = jda.ArenaDualAveragingState(z=jnp.asarray(z), t=jnp.int32(6))
    pt, st = da.update_arena(lt, st, torch.from_numpy(g),
                             torch.tensor(np.float32(count)),
                             AmbdgConfig(**kw))
    pj, sj = jda.update_arena(lj, sj, jnp.asarray(g), jnp.float32(count),
                              JaxAmbdgConfig(**kw))
    np.testing.assert_array_equal(st.z.numpy(), np.asarray(sj.z))
    assert int(st.t) == int(sj.t) == 7
    for k in SHAPES:
        got, want = pt[k].numpy(), np.asarray(pj[k])
        if proximal == "l2":
            np.testing.assert_array_equal(got, want)
        else:
            # the summation order of the ball norm can move the
            # projection factor by one ulp; the product's own rounding
            # adds at most one more
            ulp = np.spacing(np.abs(want).astype(np.float32))
            assert np.all(np.abs(got - want) <= 2 * ulp), k
    if proximal == "l2_ball":
        flat = np.concatenate([pt[k].numpy().ravel() for k in SHAPES])
        assert np.linalg.norm(flat) == pytest.approx(5.0, rel=1e-6)


def test_alpha_matches_jax_bitwise():
    cfg = AmbdgConfig(tau=4, b_bar=800.0, smoothness_L=1.0)
    jcfg = JaxAmbdgConfig(tau=4, b_bar=800.0, smoothness_L=1.0)
    for t in range(0, 200, 7):
        got = da.alpha(torch.tensor(float(t), dtype=torch.float32), cfg)
        want = jda.alpha(jnp.float32(t), jcfg)
        assert np.float32(got.item()) == np.asarray(want), t
