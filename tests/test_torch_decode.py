"""The port's decode path (``layers.decode_attention``,
``ssm.mamba2_decode``, ``transformer.init_decode_state`` and
``decode_step``) against the JAX model's, for the DENSE qwen1.5-0.5b,
qwen3-1.7b (qk-norm), yi-6b (GQA) and chatglm3-6b (half-rotary RoPE),
zamba2-2.7b (HYBRID: Mamba2
layers and the shared attention block), seamless-m4t-large-v2 (ENCDEC:
the decoder's self-attention cache and the cross-attention's memory
K/V, left at 0 as JAX's serve path leaves them, ROADMAP C.17) and
paligemma-3b (VLM: the dense decode, MQA, head dim 16) at their SMOKE
widths; and
qwen1.5-0.5b with a sliding window of 8 (the rolling cache of 8 slots,
12 steps: past its wrap).

The JAX weights come across with ``convert.params_from_jax``; both
models decode the same numpy-seeded tokens for 8 steps from a zero
cache, with one scalar position for the batch (lockstep) and with
ragged per-slot positions (continuous batching: the slots start at
positions 0, 3 and 5), the KV cache in the compute dtype. Each step's
logits and, after the last step, every cache leaf are compared.

Tolerances, per element:
  * f32 compute: 1e-5 of the largest magnitude of the tensor compared
    (the frameworks' summation orders);
  * bf16 compute: one bf16 ulp of the element (2^-7 of it) plus 1e-2
    of the largest magnitude (the frameworks round at other places:
    XLA fuses elementwise chains in f32, PyTorch rounds after each op).
    zamba2's Mamba2 layers carry those roundings through the state:
    there both packages' bf16 logits lie 1-4 % of the largest from the
    f32 logits and up to 1.8 % from each other, so its bf16 case holds
    the port's largest distance from the f32 decode (logits and cache)
    to at most twice the reference's (ROADMAP C.13).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import encdec as jed
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.arena import tree_flatten
from repro_torch.models.api import build_model

ARCHS = ["qwen1.5-0.5b", "qwen3-1.7b", "yi-6b", "chatglm3-6b",
         "zamba2-2.7b", "seamless-m4t-large-v2", "paligemma-3b"]
B, MAX_LEN, STEPS = 3, 16, 8
F32_TOL = 1e-5
BF16_ULP, BF16_TOL = 2.0 ** -7, 1e-2
HYBRID_BF16_FACTOR = 2.0


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    if dtype == "float32":
        limit = F32_TOL * scale
    else:
        limit = BF16_ULP * np.abs(want) + BF16_TOL * scale
    gap = np.abs(got - want)
    assert np.all(gap <= limit), (what, float(gap.max()), scale)


def _models(arch, dtype, **kw):
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype=dtype,
                               **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype,
                              **kw)
    jparams, _ = _jax_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _jax_model(jcfg):
    """The JAX module of the family: ``encdec`` or ``transformer``."""
    return jed if jcfg.family == "encdec" else jtf


def _positions(ragged, t):
    if ragged:
        return np.array([t, t + 3, t + 5], np.int32)
    return np.int32(t)


def _decode_both(arch, dtype, ragged, steps=STEPS, **kw):
    jcfg, cfg, jparams, params = _models(arch, dtype, **kw)
    # the KV cache in the compute dtype: under f32 compute a bf16 cache
    # would round k and v, and a last-bit difference upstream can flip
    # one rounding (ROADMAP C.13)
    jm = _jax_model(jcfg)
    jcache, _ = jm.init_decode_state(jcfg, B, MAX_LEN, jnp.dtype(dtype))
    model = build_model(cfg, device="cpu")
    cache, _ = model.init_decode_state(B, MAX_LEN, getattr(torch, dtype))
    jstep = jax.jit(lambda p, c, t, pos: jm.decode_step(p, jcfg, c, t, pos))
    rng = np.random.default_rng(11)
    out = []
    for t in range(steps):
        toks = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = _positions(ragged, t)
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(toks),
                                jnp.asarray(pos))
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(toks), torch.as_tensor(pos))
        out.append((logits, jlogits))
    return out, cache, jcache


def assert_as_near_f32(got, want, ref, what):
    """bf16 ``got`` no further from the f32 result ``ref`` than twice
    the reference's bf16 ``want`` is."""
    got, want, ref = _f32(got), _f32(want), _f32(ref)
    mine, theirs = np.abs(got - ref).max(), np.abs(want - ref).max()
    assert mine <= HYBRID_BF16_FACTOR * theirs, (what, mine, theirs)


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, dtype, ragged):
    steps, cache, jcache = _decode_both(arch, dtype, ragged)
    leaves, _ = tree_flatten(cache)
    jleaves = jax.tree.leaves(jcache)
    assert len(leaves) == len(jleaves)
    for logits, _ in steps:
        assert logits.dtype == getattr(torch, dtype)
    if dtype == "bfloat16" and arch == "zamba2-2.7b":
        # both packages' bf16 logits lie 1-4 % of the largest from the
        # f32 ones, and 1-1.8 % from each other (ROADMAP C.13): hold the
        # port to the reference's own distance from f32
        ref, ref_cache, _ = _decode_both(arch, "float32", ragged)
        for t, ((logits, jlogits), (want, _)) in enumerate(zip(steps, ref)):
            assert_as_near_f32(logits, jlogits, want, f"logits at step {t}")
        for i, (c, j, r) in enumerate(zip(leaves, jleaves,
                                          tree_flatten(ref_cache)[0])):
            assert_as_near_f32(c, j, r, f"cache leaf {i}")
        return
    for t, (logits, jlogits) in enumerate(steps):
        assert_close(logits, jlogits, dtype, f"logits at step {t}")
    for i, (c, j) in enumerate(zip(leaves, jleaves)):
        assert_close(c, j, dtype, f"cache leaf {i}")


@pytest.mark.parametrize("dtype", [None, "float32"], ids=["default", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_matches_jax(arch, dtype):
    """Shapes, dtypes (the KV cache's default is bf16, the Mamba2 state
    f32) and the logical-axes trees."""
    jcfg, cfg, _, _ = _models(arch, "bfloat16")
    model = build_model(cfg, device="cpu")
    jm = _jax_model(jcfg)
    if dtype is None:
        jcache, jaxes = jm.init_decode_state(jcfg, B, MAX_LEN)
        cache, axes = model.init_decode_state(B, MAX_LEN)
    else:
        jcache, jaxes = jm.init_decode_state(jcfg, B, MAX_LEN, jnp.float32)
        cache, axes = model.init_decode_state(B, MAX_LEN, torch.float32)
    jl = jax.tree_util.tree_flatten_with_path(jcache)[0]
    leaves, _ = tree_flatten(cache)
    assert len(jl) == len(leaves)
    for (path, j), c in zip(jl, leaves):
        assert tuple(c.shape) == j.shape, path
        assert str(c.dtype).split(".")[-1] == str(j.dtype), path
        assert not torch.any(c != 0), path
    assert jax.tree.leaves(jaxes, is_leaf=lambda x: isinstance(x, tuple)) \
        == tree_flatten(axes)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_cache_carried_across_continues_as_jax(arch):
    """``convert.decode_state_from_jax``: from JAX's cache after 4 ragged
    steps, the port's next step equals JAX's next step (f32)."""
    jcfg, cfg, jparams, params = _models(arch, "float32")
    jm = _jax_model(jcfg)
    jcache, _ = jm.init_decode_state(jcfg, B, MAX_LEN, jnp.float32)
    jstep = jax.jit(lambda p, c, t, pos: jm.decode_step(p, jcfg, c, t, pos))
    rng = np.random.default_rng(12)
    toks = [rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
            for _ in range(5)]
    for t in range(4):
        _, jcache = jstep(jparams, jcache, jnp.asarray(toks[t]),
                          jnp.asarray(_positions(True, t)))
    cache = convert.decode_state_from_jax(jax.device_get(jcache),
                                          device="cpu")
    for c, j in zip(tree_flatten(cache)[0], jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(_f32(c), _f32(j))
    jlogits, _ = jstep(jparams, jcache, jnp.asarray(toks[4]),
                       jnp.asarray(_positions(True, 4)))
    with torch.no_grad():
        logits, _ = build_model(cfg, device="cpu").decode_step(
            params, cache, torch.from_numpy(toks[4]),
            torch.as_tensor(_positions(True, 4)))
    assert_close(logits, jlogits, "float32", "logits after the carry")


def test_per_slot_positions_equal_lockstep_rows():
    """A (B,) position vector whose entries are equal decodes as the
    scalar position does, bit for bit (the two branches of
    ``decode_attention``)."""
    _, cfg, _, params = _models("qwen1.5-0.5b", "float32")
    model = build_model(cfg, device="cpu")
    a, _ = model.init_decode_state(B, MAX_LEN, torch.float32)
    b, _ = model.init_decode_state(B, MAX_LEN, torch.float32)
    rng = np.random.default_rng(13)
    with torch.no_grad():
        for t in range(4):
            toks = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, size=(B, 1)))
            la, a = model.decode_step(params, a, toks, t)
            lb, b = model.decode_step(params, b, toks,
                                      torch.full((B,), t))
            assert torch.equal(la, lb)
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
def test_windowed_dense_decode_matches_jax(ragged):
    """qwen1.5-0.5b SMOKE with sliding_window = 8: the rolling cache holds
    8 slots; 12 steps (the slots at t + 3 and t + 5 wrap at steps 5 and
    3) give JAX's logits and cache, f32."""
    steps, cache, jcache = _decode_both("qwen1.5-0.5b", "float32", ragged,
                                        steps=12, sliding_window=8)
    assert cache["k"].shape[2] == 8
    for t, (logits, jlogits) in enumerate(steps):
        assert_close(logits, jlogits, "float32", f"logits at step {t}")
    for i, (c, j) in enumerate(zip(tree_flatten(cache)[0],
                                   jax.tree.leaves(jcache))):
        assert_close(c, j, "float32", f"cache leaf {i}")
