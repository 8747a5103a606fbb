"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
model's (``repro/models/ssm.py``), on zamba2's SMOKE widths.

``mamba2_apply`` on both scan routes ("xla": the port of
``ssd_chunked``; "kernel": ``ssd_mamba2``, on CPU tensors the plain
recurrence through ``LinearScanTrain``) against JAX's, which always
computes ``ssd_chunked``: outputs and the gradients of every block
parameter, at a length that fills whole chunks and at one that needs
padding (45 steps, chunk 32: 19 padded steps). Weights come from JAX's
``mamba2_init`` and inputs from numpy seeds.

Tolerances, relative to the largest magnitude of the tensor compared:
  * f32 compute: 1e-5 (the two frameworks' summation orders; the
    kernel route sums the same terms in the recurrence's order), 3e-5
    for the gradients of the decay parameters (a_log, dt_bias);
  * bf16 compute: the output to 2e-2 (a few bf16 roundings, 2^-8 each,
    placed differently: XLA fuses elementwise chains in f32; the
    kernel route keeps its scores in f32 where ``ssd_chunked`` rounds
    them to bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro.models.common import split_factory
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.models import ssm
from repro_torch.models.common import ParamFactory


def _cfgs(dtype, scan_impl="xla"):
    jcfg = dataclasses.replace(jax_smoke_config("zamba2-2.7b"),
                               compute_dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"),
                              compute_dtype=dtype, scan_impl=scan_impl)
    return jcfg, cfg


def _jax_block(jcfg, seed=0):
    params, _ = split_factory(lambda f: jssm.mamba2_init(f, jcfg),
                              jax.random.PRNGKey(seed), jnp.float32)
    params = params["mamba"]
    # non-trivial decays, skips and conv bias (the init's are 1, 1, 0)
    rng = np.random.default_rng(seed)
    for name, scale in (("a_log", 0.5), ("dt_bias", 0.5), ("d_skip", 0.5),
                        ("b_conv", 0.1), ("norm_scale", 0.1)):
        params[name] = params[name] + jnp.asarray(
            rng.standard_normal(params[name].shape) * scale, jnp.float32)
    return params


# the decay leaves' gradients sum over every step of every head through
# the running log-decay, in another order in each framework (read: at
# most 1.1e-5 on a_log, either route)
DECAY_TOL = {"['a_log']": 3e-5, "['dt_bias']": 3e-5}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("S", [64, 45])
@pytest.mark.parametrize("scan_impl", ["xla", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_matches_jax(dtype, scan_impl, S):
    jcfg, cfg = _cfgs(dtype, scan_impl)
    jp = _jax_block(jcfg)
    p = convert.params_from_jax(jax.device_get(jp), device="cpu")
    dt = getattr(torch, dtype)
    u = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    ju = jnp.asarray(u).astype(getattr(jnp, dtype))
    want = jssm.mamba2_apply(jp, jcfg, ju)
    leaves, treedef = tree_flatten(p)
    leaves = [x.requires_grad_(True) for x in leaves]
    got = ssm.mamba2_apply(tree_unflatten(treedef, leaves), cfg,
                           torch.from_numpy(u).to(dt))
    assert got.dtype == dt and tuple(got.shape) == (2, S, cfg.d_model)
    if dtype == "bfloat16":
        assert _rel(got.detach().float().numpy(), want) <= 2e-2
        return
    assert _rel(got.detach().numpy(), want) <= 1e-5
    # gradients of sum(out cos out): every block parameter
    jgrads = jax.grad(lambda q: jnp.sum(jnp.cos(
        jssm.mamba2_apply(q, jcfg, ju)) * jssm.mamba2_apply(q, jcfg, ju)))(jp)
    grads = torch.autograd.grad(torch.sum(got * torch.cos(got)), leaves)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for name, g, jg in zip(names, grads, jax.tree.leaves(jgrads)):
        assert np.all(np.isfinite(g.numpy()))
        assert _rel(g.numpy(), jg) <= DECAY_TOL.get(name, 1e-5), name


def test_padding_leaves_the_real_steps_alone():
    """The padded steps (zeros in x, B and C; dt = -30 before the
    softplus) follow every real one, so a length that needs padding
    gives, step for step, what the first steps of a longer sequence
    give (f32, both routes)."""
    for scan_impl in ("xla", "kernel"):
        _, cfg = _cfgs("float32", scan_impl)
        p = convert.params_from_jax(jax.device_get(_jax_block(cfg)),
                                    device="cpu")
        u = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (2, 64, cfg.d_model)).astype(np.float32))
        with torch.no_grad():
            full = ssm.mamba2_apply(p, cfg, u)
            short = ssm.mamba2_apply(p, cfg, u[:, :45])
        torch.testing.assert_close(short, full[:, :45], rtol=1e-5, atol=1e-5)


def test_strong_decay_gradient_is_finite():
    """Mask before exp (``ssd_chunked``): with decay rates e^3 times the
    init's (about -40 per step) the upper triangle's exp would overflow;
    the gradient stays finite on both routes and the two agree to 1e-5,
    a_log's to 1e-3: there ``ssd_chunked``'s f32 gradient loses digits
    to the running log-decay, where the kernel route's strict backward
    keeps them (``test_torch_linear_scan.py::
    test_strict_backward_keeps_the_decay_gradient``)."""
    grads = {}
    for scan_impl in ("xla", "kernel"):
        _, cfg = _cfgs("float32", scan_impl)
        jp = _jax_block(cfg)
        jp["a_log"] = jp["a_log"] + 3.0
        p = convert.params_from_jax(jax.device_get(jp), device="cpu")
        leaves, treedef = tree_flatten(p)
        leaves = [x.requires_grad_(True) for x in leaves]
        u = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, 64, cfg.d_model)).astype(np.float32))
        out = ssm.mamba2_apply(tree_unflatten(treedef, leaves), cfg, u)
        grads[scan_impl] = torch.autograd.grad(out.square().sum(), leaves)
    names = sorted(ssm_leaf_names(cfg))
    for name, a, b in zip(names, grads["xla"], grads["kernel"]):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        assert _rel(a.numpy(), b.numpy()) <= (
            1e-3 if name == "a_log" else 1e-5), name


def ssm_leaf_names(cfg):
    f = ParamFactory(None, torch.float32, "meta")
    ssm.mamba2_init(f, cfg)
    return f.params["mamba"]


def test_init_matches_jax_tree():
    """``mamba2_init``: JAX's leaf names and shapes, ones and zeros
    where JAX has them."""
    jcfg, cfg = _cfgs("float32")
    jp, _ = split_factory(lambda f: jssm.mamba2_init(f, jcfg),
                          jax.random.PRNGKey(0), jnp.float32)
    f = ParamFactory(torch.Generator().manual_seed(0), torch.float32, "cpu")
    ssm.mamba2_init(f, cfg)
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    leaves, _ = tree_flatten(f.params)
    assert len(leaves) == len(jl) == 8
    for (path, j), t in zip(jl, leaves):
        assert tuple(t.shape) == j.shape, path
        j = np.asarray(j)
        if np.all(j == 1.0) or np.all(j == 0.0):
            np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("fn", ["mamba2_state_init", "mamba2_state_axes",
                                "mamba2_decode"])
def test_decode_functions_raise(fn):
    """The decode functions are ported (``tests/test_torch_decode.py``
    holds them to JAX) and raise on what they cannot serve: a state for a
    config without an ssm, more than one token a decode step, and (JAX's
    signature) any argument to the axes tree."""
    jcfg, cfg = _cfgs("float32")
    if fn == "mamba2_state_init":
        with pytest.raises(ValueError, match="ssm config"):
            ssm.mamba2_state_init(dataclasses.replace(cfg, ssm=None), 1, 2)
        assert ssm.mamba2_state_init(cfg, 1, 2)["ssm"].dtype == torch.float32
    elif fn == "mamba2_state_axes":
        with pytest.raises(TypeError):
            ssm.mamba2_state_axes(cfg)
        assert ssm.mamba2_state_axes() == jssm.mamba2_state_axes()
    else:
        p = convert.params_from_jax(jax.device_get(_jax_block(jcfg)),
                                    device="cpu")
        state = ssm.mamba2_state_init(cfg, 1, 2)
        with pytest.raises(ValueError, match="one token"):
            ssm.mamba2_decode(p, cfg, torch.zeros((2, 2, cfg.d_model)),
                              state["ssm"][0], state["conv"][0])


def test_unknown_scan_impl_raises():
    _, cfg = _cfgs("float32", "pallas")
    p = convert.params_from_jax(jax.device_get(_jax_block(cfg)), device="cpu")
    with pytest.raises(ValueError, match="scan_impl"):
        ssm.mamba2_apply(p, cfg, torch.zeros((1, 32, cfg.d_model)))
