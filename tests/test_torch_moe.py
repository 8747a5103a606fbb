"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) at mixtral-8x7b's SMOKE widths (4
experts, top 2, d 64, d_ff 128), JAX's weights carried across with
``convert.params_from_jax`` and numpy-seeded inputs.

  * ``moe_init``: JAX's leaf names and shapes;
  * ``_capacity`` and ``_group``: JAX's numbers;
  * ``_router``: the expert indices exactly, the gates and the aux loss
    to 1e-6, on random inputs, on all-zero router weights (every
    probability ties: JAX takes the lowest indices first, ROADMAP C.12,
    C.14) and in bf16 on inputs whose products are exact in any order
    (so both packages round the same logits and tie as often);
  * ``moe_apply_einsum`` and ``moe_apply_gather``: the forward at JAX's
    atol = rtol = 1e-4 (``tests/test_moe.py``) and its gradient (``jax.grad``
    against autograd, inputs and every weight) to rtol 1e-4 plus 1e-4 of
    the leaf's largest element (the f32 summation orders of leaves whose
    elements reach 10^3), at the default capacity and at one small
    enough to drop assignments: the tokens with every assignment dropped
    (an output row of exact zeros) are the same;
  * the two routes against each other in the port (f32, and bf16 on
    the same device: their routing is the same);
  * the group-size invariance of ``tests/test_moe.py``, for both routes;
  * an unknown ``moe_impl`` raises (JAX runs einsum for it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.models import moe as jmoe
from repro.models.common import ParamFactory as JParamFactory
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe
from repro_torch.models.api import build_model
from repro_torch.models.common import ParamFactory

IMPLS = ["einsum", "gather"]
SMALL_CF = 0.25          # C = 16 for a group of 128: drops assignments


def _cfgs(cf=None, **moe_kw):
    jcfg, cfg = C.get_smoke_config("mixtral-8x7b"), get_smoke_config(
        "mixtral-8x7b")
    if cf is not None:
        moe_kw["capacity_factor"] = cf
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    f = JParamFactory(jax.random.PRNGKey(0))
    jmoe.moe_init(f, jcfg)
    jp = f.params["moe"]
    return jp, convert.params_from_jax(jax.device_get(jp), device="cpu")


def _x(seed, shape=(2, 64, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_moe_init_names_and_shapes_are_jax():
    jcfg, cfg = _cfgs()
    f = JParamFactory(jax.random.PRNGKey(0))
    jmoe.moe_init(f, jcfg)
    g = ParamFactory(torch.Generator().manual_seed(0), torch.float32, "cpu")
    moe.moe_init(g, cfg)
    want = {k: tuple(v.shape) for k, v in f.params["moe"].items()}
    got = {k: tuple(v.shape) for k, v in g.params["moe"].items()}
    assert got == want == {"w_router": (64, 4), "w_gate": (4, 64, 128),
                           "w_up": (4, 64, 128), "w_down": (4, 128, 64)}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
def test_capacity_and_groups_match_jax(arch):
    for jcfg, cfg in ((C.get_smoke_config(arch), get_smoke_config(arch)),
                      (C.get_config(arch), get_config(arch))):
        for cf in (0.25, 1.0, 1.25, 8.0):
            jc = dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, capacity_factor=cf))
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
            for group in (1, 7, 8, 64, 100, 2048, 4096):
                assert moe._capacity(c, group) == jmoe._capacity(jc, group)
        for shape in ((2, 64), (1, 8192), (3, 40), (8, 1), (5, 1)):
            x = np.zeros(shape + (4,), np.float32)
            jg, jn = jmoe._group(jcfg, jnp.asarray(x))
            g, n = moe._group(cfg, torch.from_numpy(x))
            assert n == jn and tuple(g.shape) == jg.shape


def _router_case(case, weights):
    jp, p = weights
    if case == "random":
        return jp, p, _x(1), "float32"
    if case == "zero_router":
        zp = dict(jp, w_router=jnp.zeros_like(jp["w_router"]))
        return zp, dict(p, w_router=torch.zeros_like(p["w_router"])), \
            _x(1), "float32"
    # bf16: x in quarters of [-2, 2] and router weights in eighths of
    # [-1/2, 1/2]: every product and partial sum is exact in f32 in any
    # order, so both packages round the same logits to bf16, and ties
    # between the rounded logits are common
    rng = np.random.default_rng(3)
    x = (rng.integers(-8, 9, size=(2, 64, 64)) / 4).astype(np.float32)
    w = (rng.integers(-4, 5, size=(64, 4)) / 8).astype(np.float32)
    return dict(jp, w_router=jnp.asarray(w)), \
        dict(p, w_router=torch.from_numpy(w)), x, "bfloat16"


@pytest.mark.parametrize("case", ["random", "zero_router", "bf16"])
def test_router_matches_jax(case, weights):
    jp, p, x, dtype = _router_case(case, weights)
    jcfg, cfg = _cfgs()
    jx, _ = jmoe._group(jcfg, jnp.asarray(x, jnp.dtype(dtype)))
    tx, _ = moe._group(cfg, torch.from_numpy(x).to(getattr(torch, dtype)))
    jg, ji, ja = jmoe._router(jp, jcfg, jx)
    g, i, a = moe._router(p, cfg, tx)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
    if case == "zero_router":    # uniform probabilities: experts 0 and 1
        assert (i.numpy() == [0, 1]).all()
    if case == "bf16":
        logits = (tx @ p["w_router"].to(torch.bfloat16)).float()
        top2 = torch.sort(logits, dim=-1, descending=True).values[..., :2]
        assert int((top2[..., 0] == top2[..., 1]).sum()) > 0


def _apply_both(impl, weights, cf, x):
    """Forward and gradient of sum(y * r) + aux in both packages: (y,
    aux, grads of the weights and x) each, port first."""
    jp, p = weights
    jcfg, cfg = _cfgs(cf)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jf = getattr(jmoe, f"moe_apply_{impl}")
    tf = getattr(moe, f"moe_apply_{impl}")

    def jloss(pp, xx):
        y, aux = jf(pp, jcfg, xx)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, ja)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, a = tf(tp, cfg, tx)
    (torch.sum(y * torch.from_numpy(r)) + a).backward()
    grads = dict({k: v.grad for k, v in tp.items()}, x=tx.grad)
    jgrads = dict(jgrads[0], x=jgrads[1])
    return (y.detach(), a, grads), (jy, ja, jgrads)


@pytest.mark.parametrize("cf", [None, SMALL_CF], ids=["default", "drops"])
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_apply_and_gradient_match_jax(impl, cf, weights):
    x = _x(1)
    (y, a, grads), (jy, ja, jgrads) = _apply_both(impl, weights, cf, x)
    jy = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(a.item(), float(ja), rtol=1e-6)
    dropped = np.abs(jy).sum(-1) == 0          # every assignment dropped
    np.testing.assert_array_equal((y.abs().sum(-1) == 0).numpy(), dropped)
    assert dropped.any() == (cf == SMALL_CF)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = np.asarray(jgrads[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    assert float(grads["w_router"].abs().sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [None, SMALL_CF], ids=["default", "drops"])
def test_einsum_equals_gather_in_the_port(cf, dtype, weights):
    """The same routing and drops; f32 to 1e-5 of the largest element;
    bf16 to one bf16 ulp (2^-7) in the relative l2 norm over the output:
    the einsum route rounds each token's combined sum once, the gather
    route each weighted expert output and then their sum, so where the
    two addends cancel an element may differ by their own rounding."""
    _, p = weights
    _, cfg = _cfgs(cf)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    x = torch.from_numpy(_x(4)).to(getattr(torch, dtype))
    y1, a1 = moe.moe_apply_einsum(p, cfg, x)
    y2, a2 = moe.moe_apply_gather(p, cfg, x)
    assert y1.dtype == y2.dtype == x.dtype
    assert float(a1) == float(a2)
    y1, y2 = y1.float().numpy(), y2.float().numpy()
    if dtype == "float32":
        assert np.abs(y1 - y2).max() <= 1e-5 * np.abs(y1).max()
    else:
        assert np.linalg.norm(y1 - y2) <= 2.0 ** -7 * np.linalg.norm(y1)
    np.testing.assert_array_equal(np.abs(y1).sum(-1) == 0,
                                  np.abs(y2).sum(-1) == 0)


@pytest.mark.parametrize("impl", IMPLS)
def test_group_size_invariance(impl, weights):
    """Full-capacity routing does not depend on the group size (no
    drops), as ``tests/test_moe.py`` holds for JAX's einsum route."""
    _, p = weights
    _, big = _cfgs(8.0, dispatch_group=128)
    _, small = _cfgs(8.0, dispatch_group=32)
    x = torch.from_numpy(_x(2))
    f = getattr(moe, f"moe_apply_{impl}")
    np.testing.assert_allclose(f(p, big, x)[0].numpy(),
                               f(p, small, x)[0].numpy(), atol=1e-4,
                               rtol=1e-4)


def test_unknown_moe_impl_raises(weights):
    _, p = weights
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, moe_impl="sorted")
    with pytest.raises(ValueError, match="moe_impl"):
        moe.moe_apply(p, cfg, torch.zeros((1, 8, cfg.d_model)))
    with pytest.raises(ValueError, match="moe_impl"):
        build_model(cfg, device="cpu")
