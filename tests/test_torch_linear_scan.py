"""The port's chunked linear scan (``repro_torch.kernels.linear_scan``)
against the JAX package.

The plain recurrence (what the wrappers run on CPU tensors, and the
oracle the CUDA kernel is held against on the card) against JAX's
Pallas kernel in interpret mode and JAX's ``linear_scan_ref``, at the
shapes of ``tests/test_kernels.py``; the Mamba2 mapping ``ssd_mamba2``
against JAX's and against the model's ``ssd_chunked``; and the backward
of ``LinearScanTrain`` (the scan three more times on flipped and
swapped operands) against autograd of the plain recurrence and
``jax.grad`` of JAX's ``linear_scan_ref``. Inputs are numpy-seeded.

Tolerances, relative to the largest magnitude of the tensor compared:
  * forward, f32: 1e-5 against JAX's recurrence (the same steps, other
    summation order), 1e-4 against the chunked Pallas kernel (JAX's own
    test tolerance);
  * forward, bf16 inputs: the outputs are rounded once to bf16, so one
    bf16 ulp of the element (2^-7 of it at the bottom of a binade) plus
    1e-5 of the largest;
    against the Pallas kernel JAX's 2e-2;
  * backward, f32: 1e-4 (the formulas take dg as the difference of two
    row sums, so it carries their rounding; the recurrence's autograd
    sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan.ops import linear_scan as jax_scan
from repro.kernels.linear_scan.ops import ssd_mamba2 as jax_ssd_mamba2
from repro.kernels.linear_scan.ref import linear_scan_ref as jax_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.linear_scan import kernel
from repro_torch.kernels.linear_scan.ops import (linear_scan,
                                                 linear_scan_train,
                                                 scan_backward, ssd_mamba2)
from repro_torch.kernels.linear_scan.ref import linear_scan_ref
from repro_torch.models.ssm import ssd_chunked

SHAPES = [   # BH, BHG, S, ds, hd, chunk (tests/test_kernels.py:41-45)
    (4, 4, 256, 32, 64, 128),
    (6, 2, 256, 16, 32, 64),     # grouped q/k
    (2, 2, 512, 64, 64, 128),
]


def _inputs(BH, BHG, S, ds, hd, seed, decay=0.1):
    rng = np.random.default_rng(seed)
    g = (-np.abs(rng.standard_normal((BH, S))) * decay).astype(np.float32)
    q = rng.standard_normal((BHG, S, ds)).astype(np.float32)
    k = (rng.standard_normal((BHG, S, ds)) * 0.1).astype(np.float32)
    v = rng.standard_normal((BH, S, hd)).astype(np.float32)
    return g, q, k, v


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,BHG,S,ds,hd,chunk", SHAPES)
def test_plain_matches_jax(BH, BHG, S, ds, hd, chunk, dtype):
    g, q, k, v = _inputs(BH, BHG, S, ds, hd, seed=S + ds)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    tg = torch.from_numpy(g)
    got = linear_scan_ref(tg, tq, tk, tv)
    assert got.dtype == td and tuple(got.shape) == (BH, S, hd)
    # the CPU dispatch of the public wrapper is the plain recurrence
    assert torch.equal(linear_scan(tg, tq, tk, tv, chunk=chunk), got)
    got = got.float().numpy()
    want = np.asarray(jax_ref(jnp.asarray(g), jq, jk, jv), np.float32)
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5
    else:
        limit = 2.0 ** -7 * np.abs(want) + 1e-5 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= limit)
    pallas = jax_scan(jnp.asarray(g), jq, jk, jv, chunk=chunk, interpret=True)
    assert _rel(got, pallas) <= (1e-4 if dtype == "float32" else 2e-2)


def _ssd_inputs(seed, Bt=2, S=256, nh=4, hd=32, g=2, ds=16):
    """The inputs of tests/test_kernels.py:63, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((nh,))).astype(np.float32)
    B = (rng.standard_normal((Bt, S, g, ds)) * 0.2).astype(np.float32)
    C = (rng.standard_normal((Bt, S, g, ds)) * 0.2).astype(np.float32)
    return x, dt, A, B, C


def test_ssd_mamba2_matches_jax_and_the_model_path():
    """The mapping (v = x dt, g = dt A, q = C, k = B, group broadcast)
    against JAX's ``ssd_mamba2`` (Pallas, interpret) and the model's
    ``ssd_chunked`` (JAX's and the port's), f32, chunk 64; JAX's own
    contract holds kernel and model path to atol 2e-3, rtol 1e-3."""
    arrays = _ssd_inputs(seed=2)
    t = [torch.from_numpy(a) for a in arrays]
    j = [jnp.asarray(a) for a in arrays]
    got = ssd_mamba2(*t, chunk=64)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 256, 4, 32)
    got = got.numpy()
    want = np.asarray(jax_ssd_mamba2(*j, chunk=64, interpret=True))
    assert _rel(got, want) <= 1e-5
    y_xla, h_xla = ssd_chunked(*t, 64)
    jy_xla, jh_xla = jax_ssd_chunked(*j, 64)
    assert _rel(y_xla.numpy(), jy_xla) <= 1e-5
    assert _rel(h_xla.numpy(), jh_xla) <= 1e-5
    np.testing.assert_allclose(got, np.asarray(jy_xla), atol=2e-3, rtol=1e-3)


BWD_CASES = [   # BH, BHG, S, ds, hd, chunk, decay scale
    (4, 4, 64, 16, 32, 32, 0.1),
    (6, 2, 64, 32, 16, 16, 0.1),     # rep 3: group sums
    (4, 2, 48, 16, 16, 16, 5.0),     # strong decay, g ~ -5
]


@pytest.mark.parametrize("BH,BHG,S,ds,hd,chunk,decay", BWD_CASES)
def test_backward_matches_autograd_and_jax_grad(BH, BHG, S, ds, hd, chunk,
                                                decay):
    """``LinearScanTrain`` on CPU tensors (the plain recurrence in place
    of the kernel, the same formulas) against autograd of the
    recurrence and ``jax.grad`` of JAX's ``linear_scan_ref``, with a
    cotangent sum(y cos y)."""
    g, q, k, v = _inputs(BH, BHG, S, ds, hd, seed=BH * S, decay=decay)

    def torch_grads(fn):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (g, q, k, v)]
        y = fn(*ts)
        torch.sum(y * torch.cos(y)).backward()
        return y.detach().numpy(), [t.grad.numpy() for t in ts]

    y, got = torch_grads(lambda *ts: linear_scan_train(*ts, chunk=chunk))
    y_ref, want = torch_grads(linear_scan_ref)
    np.testing.assert_array_equal(y, y_ref)

    def jloss(*xs):
        yy = jax_ref(*xs)
        return jnp.sum(yy * jnp.cos(yy))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (g, q, k, v)))
    for name, a, b, c in zip("gqkv", got, want, jgrads):
        assert a.shape == b.shape and a.dtype == np.float32, name
        assert np.all(np.isfinite(a)), name
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
        assert _rel(a, c) <= 1e-4, (name, _rel(a, c))


def test_backward_keeps_input_dtypes():
    """bf16 q, k and an f32 v (the Mamba2 mapping in bf16 compute): the
    gradients come back in each input's dtype."""
    g, q, k, v = _inputs(2, 1, 32, 16, 16, seed=5)
    ts = [torch.from_numpy(g), torch.from_numpy(q).bfloat16(),
          torch.from_numpy(k).bfloat16(), torch.from_numpy(v)]
    ts = [t.requires_grad_(True) for t in ts]
    y = linear_scan_train(*ts, chunk=16)
    assert y.dtype == torch.float32
    y.sum().backward()
    assert [t.grad.dtype for t in ts] == [torch.float32, torch.bfloat16,
                                          torch.bfloat16, torch.float32]


def test_kernel_impl_on_cpu_raises_and_launches_nothing():
    g, q, k, v = (torch.from_numpy(x) for x in _inputs(2, 2, 64, 16, 16, 0))
    before = (kernel.FWD.launches, kernel.BWD.launches)
    for fn in (linear_scan, linear_scan_train):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(g, q, k, v, chunk=32, impl="kernel")
    assert (kernel.FWD.launches, kernel.BWD.launches) == before


def test_chunk_must_divide_the_sequence():
    g, q, k, v = (torch.from_numpy(x) for x in _inputs(2, 2, 64, 16, 16, 0))
    with pytest.raises(ValueError, match="multiple of chunk"):
        linear_scan(g, q, k, v, chunk=48)


def test_plain_inter_chunk_part():
    """``linear_scan_ref(..., chunk=L)`` also returns y_inter, the part of
    y_t from the steps before t's chunk: y minus the chunk-local scan
    (each chunk on its own, from a zero state), strict or not."""
    g, q, k, v = (torch.from_numpy(x) for x in _inputs(6, 2, 96, 16, 16, 4))
    for strict in (False, True):
        y, y_inter = linear_scan_ref(g, q, k, v, strict, chunk=32)
        local = torch.cat([linear_scan_ref(g[:, c:c + 32], q[:, c:c + 32],
                                           k[:, c:c + 32], v[:, c:c + 32],
                                           strict)
                           for c in range(0, 96, 32)], dim=1)
        assert torch.equal(y, linear_scan_ref(g, q, k, v, strict))
        assert torch.equal(y_inter[:, :32], torch.zeros_like(y[:, :32]))
        assert _rel(y_inter.numpy(), (y - local).numpy()) <= 1e-5


@pytest.mark.parametrize("rate,S", [(2.0, 64), (40.0, 64), (2.0, 512)])
def test_backward_keeps_the_decay_gradient(rate, S):
    """The decay-rate gradient of ``ssd_mamba2`` (f32 inputs, f32
    formulas, chunk 32) within 1e-4 of the recurrence's in f64, decay
    rates A = -rate (dt * A about -1.8 and -36 a step), over 2 and 16
    chunks. Two choices keep it: the dq and dk calls are strict (at
    strong decay each step's own term would dominate both row sums whose
    difference is dG), and dg is assembled chunk by chunk (a reverse
    cumsum of dG over all of S leaves the residue of the pairs that
    cancel inside it)."""
    rng = np.random.default_rng(0)
    Bt, nh, hd, ds = 1, 8, 16, 16
    arrays = [rng.standard_normal((Bt, S, nh, hd)),
              np.abs(rng.standard_normal((Bt, S, nh))) + 0.1,
              -np.ones(nh) * rate,
              rng.standard_normal((Bt, S, 1, ds)) * 0.3,
              rng.standard_normal((Bt, S, 1, ds)) * 0.3]
    ts = [torch.tensor(x, dtype=torch.float32, requires_grad=True)
          for x in arrays]
    y = ssd_mamba2(*ts, chunk=32)
    torch.sum(y * torch.cos(y)).backward()
    x, dt, A, B, C = t64 = [torch.tensor(x, dtype=torch.float64,
                                         requires_grad=True) for x in arrays]
    h = torch.zeros((Bt, nh, hd, ds), dtype=torch.float64)
    ys = []
    for t in range(S):                # the recurrence itself, in f64
        h = (torch.exp(dt[:, t] * A)[..., None, None] * h
             + (x[:, t] * dt[:, t, :, None])[..., None] * B[:, t, :, None, :])
        ys.append(torch.einsum("bhds,bgs->bhd", h, C[:, t]))
    y64 = torch.stack(ys, dim=1)
    torch.sum(y64 * torch.cos(y64)).backward()
    for name, a, b in zip(("x", "dt", "A", "B", "C"), ts, t64):
        assert _rel(a.grad.numpy(), b.grad.numpy()) <= 1e-4, name


# -- the arithmetic of the chunk-parallel CUDA kernels -----------------------
# csrc/linear_scan.cu forms, per chunk of L steps, the chunk's own state
# S_c = sum_j (k_j exp(seg - cum_j)) v_j^T, passes h_in[c] = exp(seg_{c-1})
# h_in[c-1] + S_{c-1} along the chunks in f32, and writes
# y_i = exp(cum_i) q_i . h_in + sum_{j <= i} exp(cum_i - cum_j) (q_i . k_j) v_j
# (cum and every exponent in f64 before the f32 exp). Its products run on
# TF32 tensor cores; an f32 operand x is split hi = tf32(x), lo = x - hi
# (of which the tensor cores read the leading 11 bits) and each product is
# lo*hi + hi*lo + hi*hi (3xTF32; a bf16 operand is exact in TF32). On the card chip_smoke.py holds every
# element of y and y_inter to SCAN_ULP |want| + SCAN_F32_TOL max |want|
# against the plain recurrence. Here the same arithmetic in plain torch
# (f32 sums) meets that limit on the CPU, and a single TF32 rounding of
# each operand misses it by far.
SCAN_ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
SCAN_F32_TOL = 3e-6
MODEL_SHAPE = (4, 2, 1024, 64, 64, 256)   # BH, BHG, S, ds, hd, chunk


def _tf32(x):
    """x rounded to TF32 (10 fraction bits, to nearest, ties away from
    zero: cvt.rna.tf32.f32) on its f32 bits."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _read(x):
    """The leading 11 bits of x, as a TF32 product reads an f32 operand
    (the low 13 bits of its fraction dropped)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _product(x, y, split):
    """x @ y as the tensor cores form it: on the operands' 3xTF32 split
    ("3xtf32"), or on one TF32 rounding of each ("tf32")."""
    xh, yh = _tf32(x), _tf32(y)
    if split == "tf32":
        return xh @ yh
    return _read(x - xh) @ yh + xh @ _read(y - yh) + xh @ yh


def _chunk_parallel(g, q, k, v, strict, chunk, split):
    """(y, y_inter) of the scan by the kernels' chunk-parallel form."""
    BH, S = g.shape
    rep = BH // q.shape[0]
    qf, kf = (torch.repeat_interleave(x, rep, 0).float() for x in (q, k))
    vf = v.float()
    steps = torch.arange(chunk)
    mask = steps[None, :] + int(strict) <= steps[:, None]
    h = torch.zeros((BH, qf.shape[-1], vf.shape[-1]))
    ys, inters = [], []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        cum = torch.cumsum(g[:, sl].double(), dim=1)
        inter = (_product(qf[:, sl], h, split)
                 * torch.exp(cum.float())[..., None])
        diff = torch.where(mask, cum[:, :, None] - cum[:, None, :], 0.0)
        p = torch.where(mask, _product(qf[:, sl], kf[:, sl].transpose(1, 2),
                                       split) * torch.exp(diff.float()), 0.0)
        ys.append(inter + _product(p, vf[:, sl], split))
        inters.append(inter)
        seg = cum[:, -1:]
        k_dec = kf[:, sl] * torch.exp((seg - cum).float())[..., None]
        h = (torch.exp(seg.float())[..., None] * h
             + _product(k_dec.transpose(1, 2), vf[:, sl], split))
    return torch.cat(ys, dim=1).to(v.dtype), torch.cat(inters, dim=1)


_FORMS = {}


def _main_forms(rate):
    """The main path's four scan calls at MODEL_SHAPE, as chip_smoke.py's
    ``scan_main_forms`` makes them: the forward (bf16 q and k, f32 v) and
    the backward's dv, dk and dq forms on the operands ``scan_backward``
    gives them for a random cotangent. Decays -rate x U(0, 1) a step
    (0.2: the card's rows) or -rate x U(0.5, 1.5) (40: strong decay)."""
    if rate not in _FORMS:
        BH, BHG, S, ds, hd, chunk = MODEL_SHAPE
        rng = np.random.default_rng(0)
        u = rng.random((BH, S))
        g = -rate * (u if rate < 1 else u + 0.5)
        t = lambda x: torch.from_numpy(x.astype(np.float32))
        q = t(rng.standard_normal((BHG, S, ds))).bfloat16()
        k = (t(rng.standard_normal((BHG, S, ds))) * 0.1).bfloat16()
        v = t(rng.standard_normal((BH, S, hd)))
        dy = t(rng.standard_normal((BH, S, hd)))
        calls = []

        def record(*a):   # (g, q, k, v, strict, with_inter): v stands for y
            calls.append(a)
            return (a[3], a[3]) if a[5] else a[3]

        scan_backward(record, t(g), q, k, v, dy, chunk)
        _FORMS[rate] = dict(zip(("fwd", "bwd_dv", "bwd_dk", "bwd_dq"),
                                [(t(g), q, k, v, False, False)] + calls))
    return _FORMS[rate]


def _over_limit(g, q, k, v, strict, split):
    """The largest |model - recurrence| over its element's limit, y and
    y_inter (<= 1 passes)."""
    chunk = MODEL_SHAPE[-1]
    got = _chunk_parallel(g, q, k, v, strict, chunk, split)
    want = linear_scan_ref(g, q, k, v, strict, chunk)
    over = 0.0
    for a, b, ulp in zip(got, want, (SCAN_ULP[v.dtype], 0.0)):
        a, b = a.float(), b.float()
        limit = ulp * b.abs() + SCAN_F32_TOL * b.abs().max()
        over = max(over, float(((a - b).abs() / limit).max()))
    return over


@pytest.mark.parametrize("form", ["fwd", "bwd_dv", "bwd_dk", "bwd_dq"])
def test_split_meets_the_element_limit(form):
    """3xTF32 keeps each main-path form within the limit the card holds
    the kernels to (it reads 0.08-0.14 of it here); one TF32 rounding of
    each operand reads over 100x it."""
    g, q, k, v, strict, _ = _main_forms(0.2)[form]
    assert _over_limit(g, q, k, v, strict, "3xtf32") <= 1.0
    assert _over_limit(g, q, k, v, strict, "tf32") > 10.0


@pytest.mark.parametrize("form", ["fwd", "bwd_dv", "bwd_dk", "bwd_dq"])
def test_chunk_parallel_form_at_strong_decay(form):
    """At about -40 a step (``test_backward_keeps_the_decay_gradient``'s
    strong decay) every exp(cum_i - cum_j) but the nearest underflows and
    exp(seg) is 0: the chunk states, the pass and the f64 exponents still
    keep the model within the limit."""
    g, q, k, v, strict, _ = _main_forms(40.0)[form]
    assert _over_limit(g, q, k, v, strict, "3xtf32") <= 1.0
