"""The gossip consensus and the compression operators of the port
(``repro_torch.core.consensus``, ``repro_torch.optim.compression``)
against the JAX package, on the CPU, on numpy-seeded inputs.

Bitwise where JAX has a bitwise contract: the int8 quantizers and the
top-k error feedback; the stencil fold against JAX's fold run op by op
(``jax.disable_jit``: each product and add its own op, as in eager
PyTorch), and every element within 2 ulp of the messages' largest
magnitude of JAX's jitted fold (XLA:CPU contracts some ``acc + w * v``
into an FMA where the weight is not a power of two, ROADMAP C.1); the
masked fold under the all-alive mask against the plain fold; the int8 fold against JAX's jitted and op-by-op folds (every
product in its round is exact, so no contraction can move a bit). The
matrix-power oracle and the consensus errors at f32 summation tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jcons
from repro.optim import compression as jcomp
from repro_torch.core import consensus
from repro_torch.optim import compression

FOLDS = [("ring", 8), ("ring", 2), ("torus", 4), ("torus", 16),
         ("complete", 6)]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _jnp(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _rows(seed, shape, ties=True):
    """Standard normals with, under ``ties``, rows whose scale is 2^-6
    and whose quotients by it land on .5 exactly (round half to even),
    a row of zeros and a row of tiny values (the 1e-12 floor)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    if ties:
        flat = g.reshape(-1, shape[-1])
        half = max(1, flat.shape[0] // 2)
        k = rng.integers(-127, 127, size=(half, shape[-1]))
        flat[2:2 + half] = ((k + 0.5) * 2.0 ** -6).astype(np.float32)[
            :flat.shape[0] - 2]
        flat[2:2 + half, 0] = 127.0 * 2.0 ** -6
        flat[0] = 0.0
        flat[1] = 1e-14
    return g


# -- compression --------------------------------------------------------------
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 128), (3, 6, 128), (4, 24)])
def test_quantize_int8_rows_bitwise(scale_dtype, shape):
    g = _rows(len(shape), shape)
    q, s = compression.quantize_int8_rows(
        _t(g), scale_dtype=getattr(torch, scale_dtype))
    jq, js = jcomp.quantize_int8_rows(jnp.asarray(g),
                                      scale_dtype=getattr(jnp, scale_dtype))
    assert q.dtype == torch.int8 and s.dtype == getattr(torch, scale_dtype)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), _jnp(js))
    np.testing.assert_array_equal(
        compression.dequantize_int8_rows(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8_rows(jq, js)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_bitwise(seed):
    g = _rows(seed, (6, 40), ties=seed > 0) * (10.0 ** (seed - 1))
    q, s = compression.quantize_int8(_t(g))
    jq, js = jcomp.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(compression.dequantize_int8(q, s).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js)))


def _distinct(seed, shape):
    """Values of distinct magnitudes."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    mags = (rng.permutation(n) + 1).astype(np.float32) / 7.0
    signs = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
    return (mags * signs).reshape(shape)


def _ties(seed, shape):
    """Magnitudes from a handful of values: most entries tie."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, size=shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("draw", [_distinct, _ties])
def test_topk_sparsify_and_densify_match_jax(frac, draw):
    """Values and indices equal JAX's, ties included (lowest index
    first among equal magnitudes)."""
    g = draw(3, (12, 17))
    vals, idx = compression.topk_sparsify(_t(g), frac)
    jvals, jidx = jcomp.topk_sparsify(jnp.asarray(g), frac)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        compression.topk_densify(vals, idx, g.shape).numpy(),
        np.asarray(jcomp.topk_densify(jvals, jidx, g.shape)))


def test_error_feedback_rounds_bitwise():
    """Four rounds of top-k with error feedback over a nested tree: the
    compressed trees and the residuals equal JAX's bit for bit, and the
    residual carries exactly the mass each round dropped."""
    tree = {"b": {"w": _distinct(5, (9, 8))}, "a": _distinct(6, (31,))}
    state = compression.init_feedback(
        {"b": {"w": _t(tree["b"]["w"])}, "a": _t(tree["a"])})
    jstate = jcomp.init_feedback(jax.tree.map(jnp.asarray, tree))
    for r in range(4):
        g = {"b": {"w": _distinct(10 + r, (9, 8))},
             "a": _distinct(20 + r, (31,))}
        out, state = compression.compress_with_feedback(
            state, {"b": {"w": _t(g["b"]["w"])}, "a": _t(g["a"])}, 0.2)
        jout, jstate = jcomp.compress_with_feedback(
            jstate, jax.tree.map(jnp.asarray, g), 0.2)
        for x, y in ((out, jout), (state.residual, jstate.residual)):
            np.testing.assert_array_equal(x["a"].numpy(), np.asarray(y["a"]))
            np.testing.assert_array_equal(x["b"]["w"].numpy(),
                                          np.asarray(y["b"]["w"]))
        assert int((out["a"] != 0).sum()) == int(31 * 0.2)


# -- the matrices and the stencils (numpy, the same values as JAX's) ----------
@pytest.mark.parametrize("topology,n", FOLDS + [("complete", 5),
                                                ("torus", 9)])
def test_matrices_stencils_and_rounds_equal_jax(topology, n):
    Q = consensus.gossip_matrix(topology, n)
    np.testing.assert_array_equal(Q, jcons.gossip_matrix(topology, n))
    assert consensus.lambda2(Q) == jcons.lambda2(Q)
    np.testing.assert_array_equal(consensus._stencil_matrix(topology, n),
                                  jcons._stencil_matrix(topology, n))
    np.testing.assert_allclose(consensus._stencil_matrix(topology, n), Q,
                               atol=1e-12)
    ours, theirs = (consensus.topology_stencil(topology, n),
                    jcons.topology_stencil(topology, n))
    assert [w for _, w in ours] == [w for _, w in theirs]
    for (a, _), (b, _) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        assert consensus._is_self_term(a) == jcons._is_self_term(b)
    if n > 1:
        lam = consensus.lambda2(Q)
        for delta, J in ((0.05, 1.0), (0.01, 3.0), (0.5, 0.1)):
            assert consensus.min_rounds(delta, n, J, lam) == \
                jcons.min_rounds(delta, n, J, lam)
    for comp in consensus.COMPRESSION_MODES:
        assert consensus.payload_bytes_per_round(
            topology, n, 256, compression=comp) == \
            jcons.payload_bytes_per_round(topology, n, 256, compression=comp)
    assert consensus.COMPRESSION_MODES == jcons.COMPRESSION_MODES


def test_min_rounds_refuses_a_disconnected_graph():
    for m in (consensus, jcons):
        with pytest.raises(ValueError, match="connected"):
            m.min_rounds(0.05, 4, 1.0, 1.0)
    for m in (consensus, jcons):
        with pytest.raises(ValueError, match="square"):
            m.gossip_matrix("torus", 8)


# -- the plain fold -------------------------------------------------------------
def _values(seed, n, shape=(5, 128)):
    return np.random.default_rng(seed).standard_normal(
        (n,) + shape).astype(np.float32)


def _ulps(got, want, scale):
    """Elementwise distance in ulps of ``scale`` (the messages' largest
    magnitude): a fold that cancels ends far below its terms, where an
    ulp of the element itself measures nothing."""
    return (np.abs(got.astype(np.float64) - want)
            / np.spacing(np.float32(scale)))


@pytest.mark.parametrize("topology,n", FOLDS)
def test_fold_matches_jax_op_by_op_bitwise(topology, n):
    """r rounds of the stencil fold: bitwise JAX's fold run op by op,
    within 2 ulp (of the largest message) of its jitted fold, and the matrix power (the dense
    oracle, ``run_consensus``) to f32 summation tolerance."""
    v = _values(n, n)
    got = consensus.run_consensus_fold(_t(v), topology, 4).numpy()
    with jax.disable_jit():
        eager = np.asarray(jcons.run_consensus_fold(jnp.asarray(v), topology,
                                                    4))
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(jax.jit(jcons.run_consensus_fold,
                                static_argnums=(1, 2))(jnp.asarray(v),
                                                       topology, 4))
    assert _ulps(got, jitted, np.abs(v).max()).max() <= 2.0
    one = consensus.gossip_round_dense(_t(v), topology).numpy()
    with jax.disable_jit():
        np.testing.assert_array_equal(one, np.asarray(
            jcons.gossip_round_dense(jnp.asarray(v), topology)))
    Q = consensus.gossip_matrix(topology, n)
    mat = consensus.run_consensus(_t(v.reshape(n, -1)), Q, 4).numpy()
    np.testing.assert_allclose(got.reshape(n, -1), mat, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mat, np.asarray(jcons.run_consensus(
        jnp.asarray(v.reshape(n, -1)), Q, 4)), rtol=1e-5, atol=1e-6)


def test_zero_rounds_is_the_identity():
    v = _t(_values(0, 4))
    assert consensus.run_consensus_fold(v, "ring", 0) is v
    out, res = consensus.run_consensus_fold_int8(v, torch.ones_like(v),
                                                 "ring", 0)
    assert out is v and torch.equal(res, torch.ones_like(v))


@pytest.mark.parametrize("seed", [0, 1])
def test_consensus_errors_match_jax(seed):
    v = _values(seed, 6).reshape(6, -1)
    np.testing.assert_allclose(
        consensus.consensus_error(_t(v)).item(),
        float(jcons.consensus_error(jnp.asarray(v))), rtol=1e-6)
    active = np.array([1, 0, 1, 1, 0, 1], np.float32)
    np.testing.assert_allclose(
        consensus.consensus_error_masked(_t(v), _t(active)).item(),
        float(jcons.consensus_error_masked(jnp.asarray(v),
                                           jnp.asarray(active))), rtol=1e-6)
    # alive workers that agree read exact 0; all dead reads exact 0
    same = np.array([[1.0, 1.0], [100.0, -3.0], [1.0, 1.0]], np.float32)
    assert consensus.consensus_error_masked(
        _t(same), _t(np.array([1.0, 0.0, 1.0], np.float32))).item() == 0.0
    assert consensus.consensus_error_masked(
        _t(same), torch.zeros(3)).item() == 0.0


# -- the masked fold ------------------------------------------------------------
@pytest.mark.parametrize("topology,n", FOLDS)
def test_masked_fold_all_alive_is_the_plain_fold_bitwise(topology, n):
    """JAX's own contract (which its jitted programs miss by an ulp on
    torus-4 and complete-6, ROADMAP C.1), held by the port."""
    v = _t(_values(n + 1, n, (8, 16)))
    masked = consensus.run_consensus_fold_masked(v, topology, 4,
                                                 torch.ones(n))
    assert torch.equal(masked, consensus.run_consensus_fold(v, topology, 4))
    one = consensus.gossip_round_dense_masked(v, topology, torch.ones(n))
    assert torch.equal(one, consensus.gossip_round_dense(v, topology))


@pytest.mark.parametrize("topology,n", FOLDS)
def test_masked_fold_matches_jax_op_by_op_bitwise(topology, n):
    """A mask with dead workers: bitwise JAX's masked fold run op by op,
    and the masked-matrix power (dead sources' weight moved to each
    receiver's self term) to f32 tolerance."""
    rng = np.random.default_rng(n)
    v = _values(n + 2, n, (4, 16))
    active = (rng.uniform(size=n) < 0.6).astype(np.float32)
    active[0] = 1.0
    active[-1] = 0.0
    got = consensus.run_consensus_fold_masked(_t(v), topology, 3,
                                              _t(active)).numpy()
    with jax.disable_jit():
        want = np.asarray(jcons.run_consensus_fold_masked(
            jnp.asarray(v), topology, 3, jnp.asarray(active)))
    np.testing.assert_array_equal(got, want)
    Q = consensus.gossip_matrix(topology, n)
    Qe = Q * active[None, :]
    np.fill_diagonal(Qe, 0.0)
    np.fill_diagonal(Qe, 1.0 - Qe.sum(axis=1))
    oracle = np.linalg.matrix_power(Qe, 3) @ v.reshape(n, -1).astype(
        np.float64)
    np.testing.assert_allclose(got.reshape(n, -1), oracle, rtol=1e-5,
                               atol=1e-5)


# -- the int8 fold ----------------------------------------------------------------
@pytest.mark.parametrize("topology,n", FOLDS + [("complete", 8)])
@pytest.mark.parametrize("r", [1, 3])
def test_int8_fold_matches_jax_bitwise(topology, n, r):
    """On the same (values, residual): bitwise JAX's jitted fold and its
    fold run op by op, values and residual."""
    v = _values(n + r, n, (6, 128)) * 3.0
    res = _values(n + r + 100, n, (6, 128)) * 1e-2
    out, res_out = consensus.run_consensus_fold_int8(_t(v), _t(res),
                                                     topology, r)
    jit = jax.jit(jcons.run_consensus_fold_int8, static_argnums=(2, 3))
    with jax.disable_jit():
        eager = jcons.run_consensus_fold_int8(jnp.asarray(v),
                                              jnp.asarray(res), topology, r)
    for want in (jit(jnp.asarray(v), jnp.asarray(res), topology, r), eager):
        np.testing.assert_array_equal(out.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(res_out.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("topology,n", [("ring", 8), ("torus", 16),
                                        ("complete", 8)])
@pytest.mark.parametrize("r", [1, 3, 8])
def test_int8_residual_telescopes(topology, n, r):
    """Error feedback: each round's dequantized message plus the new
    residual equals that round's fed value (v + residual, in f32)
    exactly, so over r rounds the sent messages plus the last residual
    sum to the true messages (``test_compressed_residual_telescopes``'s
    tolerance: the only rounding is the f32 sum v + residual)."""
    v = _t(_values(42, n, (6, 128)))
    res = torch.zeros_like(v)
    sent = np.zeros(tuple(v.shape), np.float64)
    true = np.zeros(tuple(v.shape), np.float64)
    for _ in range(r):
        fed = v + res
        q, s = compression.quantize_int8_rows(fed, scale_dtype=torch.bfloat16)
        d = compression.dequantize_int8_rows(q, s)
        v_next, res_next = consensus.gossip_round_dense_int8(v, res, topology)
        np.testing.assert_array_equal(
            d.numpy().astype(np.float64) + res_next.numpy(),
            fed.numpy().astype(np.float64))
        sent += d.numpy()
        true += v.numpy()
        v, res = v_next, res_next
    np.testing.assert_allclose(sent + res.numpy(), true, rtol=1e-5,
                               atol=1e-5)


def test_int8_products_are_exact():
    """The contract the bitwise int8 fold rests on: every q * scale and
    q * bf16(w * scale) the round forms is exact in f32 (torus's 1/3 is
    the hard weight)."""
    q_all = np.arange(-127, 128, dtype=np.float64)
    _, s = compression.quantize_int8_rows(_t(_values(9, 32, (128,))),
                                          scale_dtype=torch.bfloat16)
    for scale in (s, consensus._weighted_scale(1.0 / 3.0, s),
                  consensus._weighted_scale(0.25, s)):
        s64 = scale.to(torch.float32).numpy().astype(np.float64)
        prod32 = (q_all[None, :].astype(np.float32)
                  * s64[:, None].astype(np.float32))
        np.testing.assert_array_equal(prod32.astype(np.float64),
                                      q_all[None, :] * s64[:, None])
    np.testing.assert_array_equal(
        consensus._weighted_scale(1.0 / 3.0, s).numpy(),
        np.asarray(jcons._weighted_scale(1.0 / 3.0, jnp.asarray(
            s.to(torch.float32).numpy()).astype(jnp.bfloat16))))
