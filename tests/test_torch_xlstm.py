"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's (``repro/models/xlstm.py``), module by module, on numpy-seeded
inputs and JAX's weights carried across with ``convert.params_from_jax``
(xlstm-125m's SMOKE widths: d 64, 2 heads; the mLSTM's head dim 64,
the sLSTM's 32).

Tolerances, each relative to the largest magnitude of the tensor
compared:
  * f32: 1e-5 for values, 1e-5 for gradients: the two frameworks' f32
    summation orders (JAX's three-operand einsums are contracted
    pairwise in the port) and nothing else;
  * the sLSTM from a random given state: 1e-4 (SLSTM_GIVEN_TOL: the
    recurrence amplifies f32 rounding; both packages lie that far from
    an f64 recurrence);
  * bf16 compute (the chunk and the blocks): 2e-2, one bf16 rounding
    (2^-8) of a product that the two frameworks accumulate in another
    order, carried through the normaliser.
The chunked mLSTM is also held against a step recurrence in f64 (JAX's
``tests/test_kernels.py::test_mlstm_chunked_matches_recurrence``, at
its shapes), to 1e-5 where JAX's test allows atol 2e-4, rtol 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import xlstm as jx
from repro.models.common import split_factory
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.models import xlstm
from repro_torch.models.common import ParamFactory

# the sLSTM from a random given state (n ~ 1, m ~ 0) amplifies f32
# rounding step by step: at step 24 JAX reads 2.6e-5 and the port 4.6e-5
# of the largest element from an f64 recurrence of the same inputs
SLSTM_GIVEN_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The sLSTM's time loop runs thousands of tiny ops: intra-op threads
    only wait on each other there, and under a parallel test run they
    take cores from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, (what, gap, scale)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_smoke_config("xlstm-125m"),
                                compute_dtype=dtype),
            dataclasses.replace(get_smoke_config("xlstm-125m"),
                                compute_dtype=dtype))


def _params(init, jcfg, seed=0):
    jp, _ = split_factory(lambda f: init(f, jcfg), jax.random.PRNGKey(seed),
                          jnp.float32)
    return jp, convert.params_from_jax(jax.device_get(jp), device="cpu")


def _pair(x, jdt, tdt):
    """The same numpy array as a JAX array and a tensor of one dtype."""
    return jnp.asarray(x, jnp.float32).astype(jdt), \
        torch.from_numpy(np.asarray(x, np.float32)).to(tdt)


def _gates(rng, shape):
    logf = np.log(1 / (1 + np.exp(-(rng.standard_normal(shape) + 2))))
    return logf.astype(np.float32), \
        (rng.standard_normal(shape) * 0.5).astype(np.float32)


def test_dims_and_init_follow_jax():
    """Both head dims, and each block's leaves: JAX's names and shapes."""
    jcfg, cfg = _cfgs()
    assert xlstm.mlstm_dims(cfg) == jx.mlstm_dims(jcfg) == (128, 2, 64)
    assert xlstm.slstm_dims(cfg) == jx.slstm_dims(jcfg) == (2, 32, 85)
    for jinit, init in ((jx.mlstm_init, xlstm.mlstm_init),
                        (jx.slstm_init, xlstm.slstm_init)):
        jp, _ = _params(jinit, jcfg)
        f = ParamFactory(torch.Generator().manual_seed(0), torch.float32,
                         "cpu")
        init(f, cfg)
        names = jax.tree_util.tree_flatten_with_path(jp)[0]
        leaves = tree_flatten(f.params)[0]
        assert len(leaves) == len(names)
        for x, (path, y) in zip(leaves, names):
            assert tuple(x.shape) == y.shape, jax.tree_util.keystr(path)
        # the gate biases: b_f at ones, the rest zeros
        if init is xlstm.mlstm_init:
            assert torch.equal(f.params["mlstm"]["b_f"], torch.ones(2))
            assert torch.equal(f.params["mlstm"]["b_i"], torch.zeros(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True], ids=["first", "carried"])
def test_mlstm_chunk_matches_jax(carried, dtype):
    """One chunk of 16 from the initial carry (C = n = 0, m = NEG_INF) or
    from a given one: y and the carry after it."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    B, nh, L, hd = 2, 2, 16, 8
    q, k, v = (rng.standard_normal((B, nh, L, hd)) * s
               for s in (1.0, 0.3, 1.0))
    logf, logi = _gates(rng, (B, nh, L))
    if carried:
        carry = (rng.standard_normal((B, nh, hd, hd)).astype(np.float32),
                 rng.standard_normal((B, nh, hd)).astype(np.float32),
                 rng.standard_normal((B, nh)).astype(np.float32))
    else:
        carry = (np.zeros((B, nh, hd, hd), np.float32),
                 np.zeros((B, nh, hd), np.float32),
                 np.full((B, nh), xlstm.NEG_INF, np.float32))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, jdt, tdt) for a in (q, k, v))
    jy, jc = jx._mlstm_chunk(jq, jk, jv, jnp.asarray(logf),
                             jnp.asarray(logi),
                             tuple(jnp.asarray(c) for c in carry))
    y, c = xlstm._mlstm_chunk(tq, tk, tv, torch.from_numpy(logf),
                              torch.from_numpy(logi),
                              tuple(torch.from_numpy(a) for a in carry))
    assert y.dtype == torch.float32
    _close(y, jy, tol, "y")
    for name, a, b in zip("Cnm", c, jc):
        _close(a, b, 1e-5, name)      # the carry is f32 in both


def test_mlstm_sequence_and_its_gradient_match_jax():
    """Four chunks of 16 (the carry runs three times) and one of 64: y,
    and the gradient of <y, w> with respect to every input."""
    rng = np.random.default_rng(2)
    B, S, nh, hd = 2, 64, 2, 16
    q, k, v = (rng.standard_normal((B, S, nh, hd)).astype(np.float32) * s
               for s in (1.0, 0.3, 1.0))
    logf, logi = _gates(rng, (B, S, nh))
    w = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    ins = (q, k, v, logf, logi)
    for chunk in (16, 64):
        jf = lambda *a: jnp.sum(jx.mlstm_sequence(*a, chunk=chunk) * w)
        jy = jx.mlstm_sequence(*map(jnp.asarray, ins), chunk=chunk)
        jg = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
        t = [torch.from_numpy(a).requires_grad_(True) for a in ins]
        y = xlstm.mlstm_sequence(*t, chunk=chunk)
        _close(y, jy, 1e-5, f"y, chunk {chunk}")
        g = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)), t)
        for name, a, b in zip(("q", "k", "v", "logf", "logi"), g, jg):
            _close(a, b, 1e-5, f"d{name}, chunk {chunk}")


def test_mlstm_chunked_matches_the_f64_recurrence():
    """JAX's ``test_mlstm_chunked_matches_recurrence`` for the port: the
    chunked form (chunk 16 of 64) against the stabilised step recurrence
    in f64."""
    rng = np.random.default_rng(3)
    B, S, nh, hd = 2, 64, 2, 16
    q = rng.standard_normal((B, S, nh, hd))
    k = rng.standard_normal((B, S, nh, hd)) * 0.3
    v = rng.standard_normal((B, S, nh, hd))
    lf, li = (a.astype(np.float64) for a in _gates(rng, (B, S, nh)))
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    y_chunk = xlstm.mlstm_sequence(f32(q), f32(k), f32(v), f32(lf), f32(li),
                                   chunk=16).numpy()
    C = np.zeros((B, nh, hd, hd))
    n = np.zeros((B, nh, hd))
    m = np.full((B, nh), -1e30)
    ys = np.zeros((B, S, nh, hd))
    for t in range(S):
        m_new = np.maximum(lf[:, t] + m, li[:, t])
        fw = np.exp(lf[:, t] + m - m_new)
        iw = np.exp(li[:, t] - m_new)
        C = C * fw[..., None, None] + np.einsum(
            "bhd,bhe,bh->bhde", k[:, t], v[:, t], iw)
        n = n * fw[..., None] + k[:, t] * iw[..., None]
        m = m_new
        qs = q[:, t] / np.sqrt(hd)
        num = np.einsum("bhd,bhde->bhe", qs, C)
        den = np.maximum(np.abs(np.einsum("bhd,bhd->bh", qs, n)),
                         np.exp(-m))
        ys[:, t] = num / den[..., None]
    _close(y_chunk, ys, 1e-5, "y")


def test_mlstm_sequence_needs_whole_chunks():
    """JAX asserts S % min(chunk, S) == 0; the port raises."""
    x = torch.zeros((1, 24, 2, 8))
    gates = torch.zeros((1, 24, 2))
    with pytest.raises(ValueError, match="multiple of chunk"):
        xlstm.mlstm_sequence(x, x, x, gates, gates, chunk=16)
    assert xlstm.mlstm_sequence(x, x, x, gates, gates, chunk=8).shape == \
        x.shape


def _block_grads(jfn, fn, jp, p, x):
    """JAX's and the port's gradient of <block(params, x), 1> with
    respect to the params and x."""
    jg = jax.grad(lambda pp, xx: jnp.sum(jfn(pp, xx).astype(jnp.float32)),
                  argnums=(0, 1))(jp, jnp.asarray(x))
    leaves, tdef = tree_flatten(p)
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    tx = torch.from_numpy(np.asarray(x, np.float32)).requires_grad_(True)
    out = fn(tree_unflatten(tdef, leaves), tx)
    g = torch.autograd.grad(out.to(torch.float32).sum(), leaves + [tx])
    return g, jax.tree.leaves(jg[0]) + [jg[1]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_block_apply_matches_jax(dtype):
    """The block on (2, 64, 64) inputs with chunk 64 (one chunk at the
    SMOKE's conv_width 4 -> 256): output and gradient, f32 and bf16
    compute."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, cfg = _cfgs(dtype)
    jp, p = _params(jx.mlstm_init, jcfg)
    x = np.random.default_rng(4).standard_normal((2, 64, 64)).astype(
        np.float32)
    jx_, tx = _pair(x, jdt, tdt)
    want = jx.mlstm_block_apply(jp["mlstm"], jcfg, jx_)
    with torch.no_grad():
        got = xlstm.mlstm_block_apply(p["mlstm"], cfg, tx)
    assert got.dtype == tdt
    _close(got, want, tol, "y")
    if dtype == "float32":
        g, jg = _block_grads(
            lambda pp, xx: jx.mlstm_block_apply(pp["mlstm"], jcfg, xx),
            lambda pp, xx: xlstm.mlstm_block_apply(pp["mlstm"], cfg, xx),
            jp, p, x)
        for i, (a, b) in enumerate(zip(g, jg)):
            _close(a, b, 1e-5, f"grad {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("given", [False, True], ids=["zero", "given"])
def test_slstm_block_apply_matches_jax(given, dtype):
    """``slstm_scan`` through ``slstm_block_apply`` over 24 steps, from the
    zero state (m at -30) or from a given one: y, the final (h, c, n, m)
    and, in f32, the gradient."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, cfg = _cfgs(dtype)
    jp, p = _params(jx.slstm_init, jcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    jst = st = None
    if given:
        s = [rng.standard_normal((2, 2, 32)).astype(np.float32)
             for _ in range(4)]
        s[2] = np.abs(s[2]) + 0.5            # n > 0
        jst = tuple(jnp.asarray(a) for a in s)
        st = tuple(torch.from_numpy(a) for a in s)
    jx_, tx = _pair(x, jdt, tdt)
    want, jfinal = jx.slstm_block_apply(jp["slstm"], jcfg, jx_, jst)
    with torch.no_grad():
        got, final = xlstm.slstm_block_apply(p["slstm"], cfg, tx, st)
    if given and dtype == "float32":
        tol = SLSTM_GIVEN_TOL
    _close(got, want, tol, "y")
    for name, a, b in zip("hcnm", final, jfinal):
        assert a.dtype == torch.float32
        _close(a, b, tol, name)
    if dtype == "float32":
        g, jg = _block_grads(
            lambda pp, xx: jx.slstm_block_apply(pp["slstm"], jcfg, xx,
                                                jst)[0],
            lambda pp, xx: xlstm.slstm_block_apply(pp["slstm"], cfg, xx,
                                                   st)[0],
            jp, p, x)
        for i, (a, b) in enumerate(zip(g, jg)):
            _close(a, b, tol, f"grad {i}")


def test_slstm_zero_state_and_the_two_m_floors():
    """The sLSTM's m starts at -30 (JAX's ``slstm_zero_state``), the
    mLSTM's at -1e30 (``mlstm_state_init``); every other state at 0."""
    jcfg, cfg = _cfgs()
    for a, b in zip(xlstm.slstm_zero_state(cfg, 3),
                    jx.slstm_zero_state(jcfg, 3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(xlstm.slstm_zero_state(cfg, 1)[3].max()) == -30.0
    got = xlstm.mlstm_state_init(cfg, 2, 3)
    want = jx.mlstm_state_init(jcfg, 2, 3)
    for k in ("C", "n", "m"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert float(got["m"].max()) == float(np.float32(-1e30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_decodes_match_jax(dtype):
    """Eight one-token steps of each block's decode: the mLSTM's O(1)
    recurrence (``mlstm_block_decode``, its state views overwritten in
    place) and the sLSTM's block on one token with the carried state."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, cfg = _cfgs(dtype)
    jpm, pm = _params(jx.mlstm_init, jcfg, seed=1)
    jps, ps = _params(jx.slstm_init, jcfg, seed=2)
    rng = np.random.default_rng(6)
    jm = {k: v[0] for k, v in jx.mlstm_state_init(jcfg, 1, 3).items()}
    stacked = xlstm.mlstm_state_init(cfg, 1, 3)
    tm = {k: v[0] for k, v in stacked.items()}
    js, ts = jx.slstm_zero_state(jcfg, 3), xlstm.slstm_zero_state(cfg, 3)
    for t in range(8):
        x = rng.standard_normal((3, 1, 64)).astype(np.float32)
        jx_, tx = _pair(x, jdt, tdt)
        jy, jm = jx.mlstm_block_decode(jpm["mlstm"], jcfg, jx_, jm)
        jys, js = jx.slstm_block_apply(jps["slstm"], jcfg, jx_, js)
        with torch.no_grad():
            y, out = xlstm.mlstm_block_decode(pm["mlstm"], cfg, tx, tm)
            ys, ts = xlstm.slstm_block_apply(ps["slstm"], cfg, tx, ts)
        assert out is tm
        _close(y, jy, tol, f"mLSTM y at {t}")
        _close(ys, jys, tol, f"sLSTM y at {t}")
    for k in ("C", "n", "m"):
        _close(stacked[k][0], jm[k], 1e-5 if dtype == "float32" else tol, k)
    for name, a, b in zip("hcnm", ts, js):
        _close(a, b, 1e-5 if dtype == "float32" else tol, name)
    with pytest.raises(ValueError, match="one token"):
        xlstm.mlstm_block_decode(pm["mlstm"], cfg, torch.zeros((3, 2, 64)),
                                 tm)
