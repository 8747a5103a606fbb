"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's flash kernels, run in interpret mode on the
CPU, and its ``attention_ref``.

On CPU tensors the port runs the plain versions; the CUDA kernels are
held against those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Inputs are numpy-seeded and fed to both packages.
Tolerances are JAX's own (``tests/test_kernels.py``,
``tests/test_kernels_bwd.py``): 2e-5 in f32 and 2e-2 in bf16 for the
forward, atol 2e-4 / rtol 2e-3 for the gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.bwd import flash_attention_bwd as jax_bwd
from repro.kernels.flash_attention.bwd import \
    flash_attention_train as jax_train
from repro.kernels.flash_attention.bwd import flash_fwd_lse as jax_fwd_lse
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops, ref

FWD_GRID = [   # tests/test_kernels.py:17-25
    (2, 4, 2, 256, 256, 64, True, None),
    (1, 8, 8, 128, 128, 128, True, None),
    (2, 4, 1, 256, 512, 64, True, None),      # MQA, right-aligned q
    (1, 4, 2, 256, 256, 64, True, 128),       # sliding window
    (1, 2, 2, 128, 256, 64, False, None),     # bidirectional
    # the head dims the CUDA kernels widen to: zamba2's 80, paligemma's 256
    (1, 4, 2, 256, 256, 80, True, None),      # GQA
    (1, 2, 2, 256, 256, 80, True, 96),        # sliding window
    (1, 2, 2, 128, 256, 80, False, None),     # bidirectional
    (1, 8, 1, 128, 128, 256, True, None),     # MQA (paligemma's layout)
    (1, 2, 2, 256, 256, 256, True, 64),       # sliding window
    (1, 2, 2, 128, 128, 256, False, None),    # bidirectional
]
BWD_GRID = [   # tests/test_kernels_bwd.py:12-18
    (1, 2, 2, 128, 128, 64, True, None),
    (1, 4, 2, 128, 128, 64, True, None),      # GQA group-sum in dkv
    (1, 2, 1, 128, 256, 64, True, None),      # MQA, right-aligned q
    (1, 2, 2, 128, 128, 64, True, 64),        # sliding window
    (1, 2, 2, 128, 128, 64, False, None),     # bidirectional
    (1, 4, 2, 128, 128, 80, True, None),      # D = 80, GQA
    (1, 2, 2, 128, 128, 80, True, 64),        # D = 80, sliding window
    (1, 2, 2, 128, 128, 80, False, None),     # D = 80, bidirectional
    (1, 4, 1, 128, 128, 256, True, None),     # D = 256, MQA
    (1, 2, 2, 128, 128, 256, True, 64),       # D = 256, sliding window
    (1, 2, 2, 128, 128, 256, False, None),    # D = 256, bidirectional
]
# causal with Sq > Skv: the first Sq - Skv query rows have no valid key
NO_KEY = (1, 2, 2, 256, 128, 64, True, None)


def _inputs(B, Hq, Hkv, Sq, Skv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    return q, k, v


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, jd, td):
    # through JAX's rounding, so both packages see the same bf16 values
    return torch.from_numpy(np.asarray(jnp.asarray(x).astype(jd),
                                       np.float32)).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window", FWD_GRID)
def test_plain_forward_matches_jax(B, Hq, Hkv, Sq, Skv, D, causal, window,
                                   dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v = _inputs(B, Hq, Hkv, Sq, Skv, D)
    out = ops.flash_attention(*(_torch(x, jd, td) for x in (q, k, v)),
                              causal=causal, window=window)
    assert out.dtype == td and tuple(out.shape) == (B, Hq, Sq, D)
    jq, jk, jv = _jax(q, jd), _jax(k, jd), _jax(v, jd)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in (jax_flash(jq, jk, jv, causal=causal, window=window,
                           interpret=True),
                 jax_ref(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(_f32(out), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window",
                         BWD_GRID + [NO_KEY])
def test_plain_lse_matches_jax(B, Hq, Hkv, Sq, Skv, D, causal, window):
    q, k, v = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=1)
    o, lse = ref.flash_fwd_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=causal, window=window,
                                   scale=D ** -0.5)
    jo, jlse = jax_fwd_lse(*(jnp.asarray(x) for x in (q, k, v)),
                           causal=causal, window=window, scale=D ** -0.5,
                           block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(o), _f32(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_f32(lse), _f32(jlse), atol=2e-5, rtol=2e-5)


def _grads_torch(fn, q, k, v):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = fn(*ts)
    torch.sum(o * torch.cos(o)).backward()      # JAX's cotangent
    return [t.grad for t in ts]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window", BWD_GRID)
def test_plain_backward_matches_jax(B, Hq, Hkv, Sq, Skv, D, causal, window):
    """Autograd of the plain version (the model's CPU path) and the
    recomputing ``FlashAttentionTrain`` with its plain parts, against
    jax.grad through JAX's flash kernels (interpret mode)."""
    q, k, v = _inputs(B, Hq, Hkv, Sq, Skv, D)

    def loss_jax(q, k, v):
        o = jax_train(q, k, v, causal, window, 64, 64, True)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for fn in (lambda a, b, c: ops.flash_attention_train(
                   a, b, c, causal, window, 64, 64),
               lambda a, b, c: ops.FlashAttentionTrain.apply(
                   a, b, c, causal, window, False)):
        got = _grads_torch(fn, q, k, v)
        for a, b, name in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(_f32(a), _f32(b), atol=2e-4,
                                       rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window",
                         BWD_GRID + [NO_KEY])
def test_plain_kernel_backward_matches_jax(B, Hq, Hkv, Sq, Skv, D, causal,
                                           window):
    """``flash_bwd_ref`` (what the dq and dk/dv kernels compute, from
    the saved lse) against JAX's ``flash_attention_bwd`` on the same
    o, lse and cotangent, rows with no valid key included."""
    q, k, v = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=2)
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo, jlse = jax_fwd_lse(jq, jk, jv, causal=causal, window=window,
                           scale=D ** -0.5, block_q=64, block_k=64,
                           interpret=True)
    want = jax_bwd(jq, jk, jv, jo, jlse, jnp.asarray(do), causal=causal,
                   window=window, scale=D ** -0.5, block_q=64, block_k=64,
                   interpret=True)
    o, lse = ref.flash_fwd_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=causal, window=window,
                                   scale=D ** -0.5)
    delta = torch.sum(torch.from_numpy(do) * o, dim=-1)
    got = ref.flash_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v)), lse,
                            delta, torch.from_numpy(do), causal=causal,
                            window=window, scale=D ** -0.5)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=2e-4, rtol=2e-3,
                                   err_msg=name)


def test_rows_with_no_valid_key_match_jax():
    """Causal attention with Sq > Skv: the first Sq - Skv query rows
    have no key in reach. The TPU kernel visits every key tile, so such
    a row's output is the mean of v (attention_ref's uniform softmax
    over -1e30 scores gives the same) and its lse is -1e30; the plain
    version agrees with both."""
    B, Hq, Hkv, Sq, Skv, D, causal, window = NO_KEY
    q, k, v = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=4)
    out = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(
        _f32(out), _f32(jax_flash(jq, jk, jv, causal=True, interpret=True)),
        atol=2e-5, rtol=2e-5)
    n_empty = Sq - Skv
    mean_v = np.repeat(v.mean(axis=2, keepdims=True), Hq // Hkv, axis=1)
    np.testing.assert_allclose(_f32(out)[:, :, :n_empty],
                               np.broadcast_to(mean_v, (B, Hq, n_empty, D)),
                               atol=2e-5, rtol=2e-5)
    _, lse = ref.flash_fwd_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=True, window=None, scale=D ** -0.5)
    assert np.all(_f32(lse)[:, :, :n_empty] == np.float32(-1e30))
    assert np.all(np.isfinite(_f32(lse)[:, :, n_empty:]))


def test_block_sizes_must_divide_the_lengths():
    q = torch.zeros((1, 2, 96, 64))
    with pytest.raises(ValueError, match="multiples of"):
        ops.flash_attention(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="multiples of"):
        ops.flash_attention_train(q, q, q, True, None, 64, 32)
    assert ops.flash_attention(q, q, q, block_q=32, block_k=32).shape == \
        q.shape


@pytest.mark.parametrize("entry", ["forward", "train"])
def test_kernel_impl_on_cpu_raises_and_launches_nothing(entry):
    from repro_torch.kernels.flash_attention import kernel
    counters = (kernel.FWD, kernel.FWD_LSE, kernel.DQ, kernel.DKV)
    before = [c.launches for c in counters]
    q = torch.zeros((1, 2, 128, 64))
    fn = ops.flash_attention if entry == "forward" else \
        ops.flash_attention_train
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(q, q, q, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_fwd_lse(q, q, q, causal=True, window=None, scale=0.125)
    assert [c.launches for c in counters] == before


# -- the rounding model of the bf16 Hopper kernels ---------------------------
# The bf16 kernels (csrc/flash_attention.cu) run s = q k^T and dp = do v^T
# as bf16 products with f32 accumulation (the products are exact in f32),
# and each product with an f32-computed operand (p v, ds k, ds^T q,
# p^T do) as two bf16 products on that operand's split hi = bf16(x),
# lo = bf16(x - hi). On the card chip_smoke.py holds every element of
# their outputs to ELEMENT_ULP |want| + ELEMENT_FLOOR max |want| against
# the plain version (ref.py). Here the same numerics in plain torch meet
# that limit on the CPU, and one bf16 rounding of the operand misses it.
ELEMENT_ULP, ELEMENT_FLOOR = 2.0 ** -7, 1e-5
MODEL_SHAPE = (1, 4, 2, 512)   # B, Hq, Hkv, S; causal


def _product(x, y, rounding):
    """x @ y for an f32-computed x and a bf16-valued y: as two bf16
    products on x's hi/lo split ("split"), or on bf16(x) ("single")."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    if rounding == "single":
        return hi @ y
    return hi @ y + (x - hi).to(torch.bfloat16).to(torch.float32) @ y


def _over_limit(got, want):
    """The largest |got - want| over its element's limit (<= 1 passes)."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    limit = ELEMENT_ULP * w.abs() + ELEMENT_FLOOR * w.abs().max()
    return float(((g - w).abs() / limit).max())


def _modelled(kind, q, k, v, do, lse, delta, rounding):
    """The kernel ``kind``'s outputs under the model, and the plain
    version's (``ref``), from the same inputs, lse and delta."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    scale = D ** -0.5
    f32 = torch.float32
    kg, vg = (x.repeat_interleave(G, dim=1).to(f32) for x in (k, v))
    qf, dof = q.to(f32), do.to(f32)
    mask = ref.attention_mask(S, S, True, None, "cpu")
    s = torch.where(mask, qf @ kg.transpose(-1, -2) * scale, ref.NEG_INF)
    kw = dict(causal=True, window=None, scale=scale)
    if kind == "fwd":
        p = torch.exp(s - s.max(-1, keepdim=True).values)
        o = _product(p, vg, rounding) / p.sum(-1, keepdim=True)
        return [o.to(q.dtype)], [ref.attention_ref(q, k, v, causal=True)]
    p = torch.exp(s - lse[..., None])
    ds = p * (dof @ vg.transpose(-1, -2) - delta[..., None]) * scale
    if kind == "dq":
        return ([_product(ds, kg, rounding).to(q.dtype)],
                [ref.flash_bwd_dq_ref(q, k, v, lse, delta, do, **kw)])
    group = (B, k.shape[1], G, S, D)
    dk = _product(ds.transpose(-1, -2), qf, rounding).reshape(group).sum(2)
    dv = _product(p.transpose(-1, -2), dof, rounding).reshape(group).sum(2)
    return ([dk.to(k.dtype), dv.to(v.dtype)],
            list(ref.flash_bwd_dkv_ref(q, k, v, lse, delta, do, **kw)))


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_split_operand_meets_the_element_limit(kind, D):
    """The hi/lo split keeps each output within the element limit the
    card holds the bf16 kernels to; a single bf16 rounding of the
    f32-computed operand does not (it reads 24-46x the limit here)."""
    B, Hq, Hkv, S = MODEL_SHAPE
    rng = np.random.default_rng(D)
    q, do = (torch.from_numpy(rng.standard_normal((B, Hq, S, D))
                              .astype(np.float32)).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, S, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    o, lse = ref.flash_fwd_lse_ref(q, k, v, causal=True, window=None,
                                   scale=D ** -0.5)
    delta = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
    over = {}
    for rounding in ("split", "single"):
        got, want = _modelled(kind, q, k, v, do, lse, delta, rounding)
        over[rounding] = max(_over_limit(g, w) for g, w in zip(got, want))
    assert over["split"] <= 1.0, over
    assert over["single"] > 10.0, over
