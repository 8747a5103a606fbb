"""The model-level attention masks and the logit softcap of the port
(``repro_torch.models.layers``) against the JAX package's
(``repro.models.layers``), on numpy-seeded inputs.

  * ``causal_mask`` with and without a window and ``prefix_lm_mask``,
    each with a query offset: exactly JAX's;
  * ``gqa_attend`` with a softcap, f32: within 1e-6 of the largest
    output element;
  * ``chunked_gqa_attend`` (the plain core past 8192 tokens, run here at
    S = 4096 in two q-blocks of 2048) with the window and the softcap
    through ``mask_fn``, one head: within 1e-5 of the largest element;
  * ``attention_apply`` with ``attn_impl="flash"`` and a window (on CPU
    tensors the flash kernels' plain version) against JAX's
    ``attention_apply``, whose core is ``gqa_attend`` under the windowed
    mask: within 1e-5 of the largest element;
  * ``attn_impl="flash"`` with ``logit_softcap`` or ``prefix_lm`` raises
    at ``build_model`` and at ``attention_apply``: the kernels compute
    neither, and the plain core must not stand in for them silently.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.models import layers as jl
from repro.models.common import ParamFactory as JParamFactory
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers
from repro_torch.models.api import build_model


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("q_len,kv_len,window,offset", [
    (16, 16, None, 0), (16, 16, 4, 0), (8, 40, 5, 32), (64, 64, 32, 0),
    (7, 30, 1, 23), (12, 12, 100, 0)])
def test_causal_mask_is_jax(q_len, kv_len, window, offset):
    want = np.asarray(jl.causal_mask(q_len, kv_len, window=window,
                                     q_offset=offset))
    got = layers.causal_mask(q_len, kv_len, window=window, q_offset=offset)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q_len,kv_len,prefix,offset", [
    (16, 16, 0, 0), (16, 16, 5, 0), (8, 40, 12, 32), (10, 10, 10, 0),
    (6, 24, 20, 18)])
def test_prefix_lm_mask_is_jax(q_len, kv_len, prefix, offset):
    want = np.asarray(jl.prefix_lm_mask(q_len, kv_len, prefix,
                                        q_offset=offset))
    got = layers.prefix_lm_mask(q_len, kv_len, prefix, q_offset=offset)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("softcap", [None, 5.0, 50.0])
def test_gqa_attend_softcap_matches_jax(softcap, window):
    q, k, v = (_normal(s, sh) for s, sh in ((0, (2, 24, 4, 16)),
                                              (1, (2, 24, 2, 16)),
                                              (2, (2, 24, 2, 16))))
    q *= 3.0     # scores beyond the cap of 5
    want = jl.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jl.causal_mask(24, 24, window=window), softcap)
    got = layers.gqa_attend(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            layers.causal_mask(24, 24, window=window),
                            softcap)
    _close(got.numpy(), want, 1e-6)


def test_chunked_attention_carries_window_and_softcap():
    S, window, cap = 4096, 1000, 20.0
    q, k, v = (_normal(s, (1, S, 1, 16)) for s in (3, 4, 5))
    q *= 4.0

    def jmask(off, qn):
        return jl.causal_mask(qn, S, window=window, q_offset=off)

    def mask(off, qn):
        return layers.causal_mask(qn, S, window=window, q_offset=off)

    want = jl.chunked_gqa_attend(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jmask, cap)
    got = layers.chunked_gqa_attend(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), mask, cap)
    _close(got.numpy(), want, 1e-5)
    # and it is the unchunked core's result
    whole = layers.gqa_attend(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), mask(0, S), cap)
    _close(got.numpy(), whole.numpy(), 1e-6)


def _attn_params(cfg_j):
    f = JParamFactory(jax.random.PRNGKey(0))
    jl.attention_init(f, cfg_j)
    jp = f.params["attn"]
    return jp, convert.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("window", [8, 32])
def test_flash_attention_apply_with_window_matches_jax(window):
    jcfg = dataclasses.replace(C.get_smoke_config("mixtral-8x7b"),
                               compute_dtype="float32", sliding_window=window)
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              compute_dtype="float32", sliding_window=window,
                              attn_impl="flash")
    jp, p = _attn_params(jcfg)
    S = 64
    x = _normal(6, (2, S, cfg.d_model))
    pos = np.arange(S, dtype=np.int32)[None, :]
    want = jl.attention_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              jl.causal_mask(S, S, window=window))
    got = layers.attention_apply(p, cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos), None)
    _close(got.numpy(), want, 1e-5)
    # the window masks something at S = 64: without it the result moves
    full = layers.attention_apply(
        p, dataclasses.replace(cfg, sliding_window=None),
        torch.from_numpy(x), torch.from_numpy(pos), None)
    assert np.abs(full.numpy() - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("kw", [dict(logit_softcap=30.0),
                                dict(prefix_lm=True)])
def test_flash_with_softcap_or_prefix_lm_raises(kw):
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              attn_impl="flash", **kw)
    with pytest.raises(NotImplementedError, match="flash"):
        build_model(cfg, device="cpu")
    _, p = _attn_params(C.get_smoke_config("mixtral-8x7b"))
    x = torch.zeros((1, 16, cfg.d_model))
    pos = torch.arange(16)[None, :]
    with pytest.raises(NotImplementedError, match="flash"):
        layers.attention_apply(p, cfg, x, pos, None)
    # the plain core takes both
    build_model(dataclasses.replace(cfg, attn_impl="xla"), device="cpu")
