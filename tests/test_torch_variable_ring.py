"""The port's stacked delay rings against the JAX package: the
delay-tolerant v3 ring (variable pop) and the fixed v1 ring (rotate),
on numpy-seeded inputs.

Tolerances: none. Every comparison here is bitwise.

  * The plain variable pop and its (count, stale_sum) epilogue equal
    JAX's oracles ``ring_variable_pop_ref`` / ``ring_variable_meta_ref``
    and the Pallas ``variable_pop_fwd`` in interpret mode, f32 and int8,
    one and two pods. With an ``inf`` in a slot that is not due, the
    port's pop is unchanged (a dead slot adds an exact zero) while the
    JAX oracle's ``m * x`` turns it into NaN.
  * ``push_pop_variable`` on CPU tensors (the gather) equals JAX's
    ``push_pop_variable`` run eagerly on the CPU step by step (under
    ``jax.jit`` XLA:CPU moves some int8 row scales by one ulp, ROADMAP
    C.4, so the JAX side is not jitted here): grad_sum, count,
    tau_obs, and the ring, scales, residual, due, stale, counts, head
    and phase after each step, P = 1 and 2, none and int8.
  * The ring pops exactly what ``staleness.delivery_schedule`` of the
    drawn sequence says, and ``tau_obs`` is ``observed_staleness``.
  * A constant delay sequence on the v3 ring gives the v2 fixed path's
    pops and state bit for bit.
  * The v1 ``push_pop`` equals JAX's v1 and pops what the v2 ring pops;
    ``convert_ring`` v2 -> v1 equals JAX's, and v1 -> v2 gives back the
    live slots of the v2 ring it came from.
  * The plain v1 rotate equals JAX's ``ring_push_pop_ref``; its int8
    residual is the un-contracted fed - q * s, and the interpret-mode
    Pallas kernel's is the FMA-contracted form of the same q and s
    (ROADMAP C.3), each held exactly.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arena as jarena
from repro.kernels.delay_ring import kernel as jkernel
from repro.kernels.delay_ring import ref as jref
from repro_torch.configs.base import DelayConfig
from repro_torch.core import arena
from repro_torch.core.delay_process import make_delay_process
from repro_torch.core.staleness import delivery_schedule, observed_staleness
from repro_torch.kernels.delay_ring.ops import (ring_push_pop,
                                                ring_variable_pop)

SHAPES = {"a": (9,), "b": (33, 7), "c": (140,)}
eq = np.testing.assert_array_equal


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _ring(rng, n_slots, n_pods, rows, int8):
    shape = (n_slots, n_pods, rows, 128)
    if int8:
        ring = rng.integers(-127, 128, size=shape).astype(np.int8)
        scales = rng.uniform(1e-3, 1.0, size=shape[:3]).astype(np.float32)
        return ring, scales
    return rng.standard_normal(shape).astype(np.float32), None


def _mask(n_slots, due):
    m = np.zeros((n_slots,), bool)
    m[list(due)] = True
    return m


# ---------------------------------------------------------------------------
# the plain variable pop against JAX's oracles and interpret-mode kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("due", [(), (3,), (0, 4), (1, 2, 6)])
@pytest.mark.parametrize("n_pods", [1, 2])
@pytest.mark.parametrize("int8", [False, True])
def test_plain_pop_matches_jax_oracle_and_interpret_kernel(int8, n_pods,
                                                           due):
    rng = np.random.default_rng(len(due) + 10 * n_pods)
    n_slots = 7
    ring, scales = _ring(rng, n_slots, n_pods, 256, int8)
    mask = _mask(n_slots, due)
    cs = np.stack([rng.integers(0, 300, n_slots),
                   rng.integers(0, 8, n_slots)]).astype(np.float32)
    t = lambda x: None if x is None else torch.from_numpy(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    popped, meta = ring_variable_pop(t(ring), t(mask), scales=t(scales),
                                     counts_stale=t(cs))
    want = jref.ring_variable_pop_ref(j(ring), j(mask), scales=j(scales))
    want_meta = jref.ring_variable_meta_ref(j(mask), j(cs))
    kp, km = jkernel.variable_pop_fwd(j(ring), j(mask), scales=j(scales),
                                      counts_stale=j(cs), interpret=True)
    eq(popped.numpy(), np.asarray(want))
    eq(popped.numpy(), np.asarray(kp))
    eq(meta.numpy(), np.asarray(want_meta))
    eq(meta.numpy(), np.asarray(km))
    # the CPU path's gather folds pods first: equal to the oracle's pod
    # fold at one pod, and always finite on finite data
    gather = arena._variable_pop_ref(t(ring), t(scales), t(mask))
    if n_pods == 1:
        eq(gather.numpy(), popped.numpy()[0])


@pytest.mark.parametrize("int8", [False, True])
def test_dead_slot_inf_does_not_leak(int8):
    rng = np.random.default_rng(3)
    ring, scales = _ring(rng, 5, 2, 256, int8)
    mask = _mask(5, (1, 3))
    t = torch.from_numpy
    clean = ring_variable_pop(t(ring), t(mask),
                              scales=None if scales is None else t(scales))
    if int8:
        scales[2, :, :4] = np.inf        # slot 2 is not due
    else:
        ring[2, :, :4, :] = np.inf
    dirty = ring_variable_pop(t(ring), t(mask),
                              scales=None if scales is None else t(scales))
    eq(dirty.numpy(), clean.numpy())
    assert np.isfinite(dirty.numpy()).all()
    gather = arena._variable_pop_ref(
        t(ring), None if scales is None else t(scales), t(mask))
    assert np.isfinite(gather.numpy()).all()
    # the JAX oracle multiplies the dead slot by 0: inf * 0 = NaN
    want = jref.ring_variable_pop_ref(
        jnp.asarray(ring), jnp.asarray(mask),
        scales=None if scales is None else jnp.asarray(scales))
    assert not np.isfinite(np.asarray(want)).all()


# ---------------------------------------------------------------------------
# push_pop_variable against JAX's, step by step
# ---------------------------------------------------------------------------
def _grads(rng, n_pods):
    return {k: (rng.standard_normal((n_pods,) + s) * 3).astype(np.float32)
            for k, s in SHAPES.items()}


def _layouts():
    zeros = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    return (arena.make_layout({k: torch.from_numpy(v)
                               for k, v in zeros.items()}),
            jarena.make_layout({k: jnp.asarray(v)
                                for k, v in zeros.items()}))


def _tt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jj(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_arena_equal(pa, ja, variable=True):
    if isinstance(pa.ring, tuple):
        for a, b in zip(pa.ring, ja.ring):
            eq(_np(a), np.asarray(b))
    else:
        eq(_np(pa.ring), np.asarray(ja.ring))
    if pa.scales is not None:
        if isinstance(pa.scales, tuple):
            for a, b in zip(pa.scales, ja.scales):
                eq(_np(a), np.asarray(b))
        else:
            eq(_np(pa.scales), np.asarray(ja.scales))
        eq(_np(pa.residual), np.asarray(ja.residual))
    eq(_np(pa.counts), np.asarray(ja.counts))
    assert int(pa.head) == int(ja.head)
    assert pa.phase == ja.phase
    if variable:
        eq(_np(pa.due), np.asarray(ja.due))
        eq(_np(pa.stale), np.asarray(ja.stale))


def _uncontracted_fold(pa, t):
    """The port's int8 pop, in numpy float32: the due slots' pods
    dequantized (q * s rounded) and folded pods first, then slots in
    ascending order from zero (one slot: no zero added)."""
    due = np.flatnonzero(pa.due.numpy() == t)
    ring, scales = pa.ring.numpy(), pa.scales.numpy()
    sums = []
    for j in due:
        x = [ring[j, p].astype(np.float32) * scales[j, p][:, None]
             for p in range(ring.shape[1])]
        acc = x[0]
        for y in x[1:]:
            acc = acc + y
        sums.append(acc)
    if len(sums) == 1:
        return sums[0]
    acc = np.zeros(ring.shape[2:], np.float32)
    for y in sums:
        acc = acc + y
    return acc


@pytest.mark.parametrize("process", ["heavy_tail", "jitter", "bursty"])
@pytest.mark.parametrize("n_pods", [1, 2])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_push_pop_variable_matches_jax_per_step(compression, n_pods,
                                                process):
    """Bitwise per step, with one exception: JAX's int8 gather runs
    inside ``lax.switch``/``fori_loop``, where XLA:CPU contracts each
    add of a dequantized product into an FMA despite the
    optimization_barrier (ROADMAP C.4). Where such an add happens (two
    or more pods, or two or more arrivals) the port's grad_sum is held
    bitwise to the un-contracted fold and JAX's to within one rounding
    of each add: 2 ulps of the largest dequantized value per add."""
    tau_max = 4
    layout, jlayout = _layouts()
    pa = arena.init_arena(layout, tau_max, n_pods, compression,
                          device="cpu", variable=True)
    ja = jarena.init_arena(jlayout, tau_max, n_pods, compression,
                           variable=True)
    jstep = functools.partial(jarena.push_pop_variable, jlayout,
                              compression=compression)
    delays = make_delay_process(
        DelayConfig(process=process, tau_max=tau_max, seed=7, jitter=2),
        2).sequence(3 * (tau_max + 1) + 3)
    rng = np.random.default_rng(n_pods)
    arrivals = set()
    for t, d in enumerate(delays):
        g = _grads(rng, n_pods)
        counts = (np.arange(1, n_pods + 1) * 10.0 + t).astype(np.float32)
        pg, pc, ptau, pa = arena.push_pop_variable(
            layout, pa, _tt(g), torch.from_numpy(counts),
            torch.tensor(int(d), dtype=torch.int32), compression)
        jg, jc, jtau, ja = jstep(ja, _jj(g), jnp.asarray(counts),
                                 jnp.int32(d))
        n_due = int((pa.due.numpy() == t).sum())
        arrivals.add(n_due)
        if compression == "int8" and (n_due > 1 or (n_due and n_pods > 1)):
            eq(pg.numpy(), _uncontracted_fold(pa, t))
            big = float(np.abs(pa.scales.numpy()).max()) * 127
            np.testing.assert_allclose(
                pg.numpy(), np.asarray(jg), rtol=0,
                atol=2 * n_due * n_pods * np.spacing(np.float32(big)))
        else:
            eq(pg.numpy(), np.asarray(jg))
        assert pc.item() == float(jc)
        assert ptau.item() == float(jtau)
        _assert_arena_equal(pa, ja)
    assert {0, 1}.issubset(arrivals)     # empty and single pops ran


def test_push_pop_variable_rejects_fixed_arena_and_v1_variable():
    layout, _ = _layouts()
    fixed = arena.init_arena(layout, 2, 1, device="cpu")
    g = _tt(_grads(np.random.default_rng(0), 1))
    with pytest.raises(ValueError, match="delay-tolerant"):
        arena.push_pop_variable(layout, fixed, g, torch.ones(1), 1)
    with pytest.raises(ValueError, match="v2"):
        arena.init_arena(layout, 2, 1, device="cpu", ring_version=1,
                         variable=True)
    var = arena.init_arena(layout, 2, 1, device="cpu", variable=True)
    with pytest.raises(ValueError, match="push_pop_variable"):
        arena.push_pop(layout, var, g, torch.ones(1))
    with pytest.raises(ValueError, match="no v1 layout"):
        arena.convert_ring(var, 1)
    assert arena.ring_version(var) == 3 and arena.arena_tau(var) == 2
    assert arena.ring_version(fixed) == 2 and arena.arena_tau(fixed) == 2


@pytest.mark.parametrize("process", ["heavy_tail", "jitter", "bursty"])
@pytest.mark.parametrize("tau_max", [1, 4, 8])
def test_ring_pops_the_delivery_schedule(process, tau_max):
    """Push s (1-indexed) carries count 2^(s-1) on one pod, so the
    applied count names exactly the pushes that arrived; tau_obs with
    equal counts is ``observed_staleness`` (the ring's cap on an empty
    step is the caller's fallback, checked in test_torch_slice)."""
    layout, _ = _layouts()
    n_steps = 2 * (tau_max + 1) + 3
    delays = make_delay_process(
        DelayConfig(process=process, tau_max=tau_max, seed=11), 2
    ).sequence(n_steps).tolist()
    sched = delivery_schedule(delays)
    ones = observed_staleness(delays, n_steps)
    zero = _tt({k: np.zeros((1,) + s, np.float32) for k, s in SHAPES.items()})
    pa = arena.init_arena(layout, tau_max, 1, device="cpu", variable=True)
    pb = arena.init_arena(layout, tau_max, 1, device="cpu", variable=True)
    for t, d in enumerate(delays):
        _, c, _, pa = arena.push_pop_variable(
            layout, pa, zero, torch.tensor([2.0 ** t]), d)
        assert c.item() == sum(2.0 ** (s - 1) for s in sched.get(t + 1, []))
        _, c1, tau_obs, pb = arena.push_pop_variable(
            layout, pb, zero, torch.ones(1), d)
        assert c1.item() == len(sched.get(t + 1, []))
        assert tau_obs.item() == pytest.approx(ones[t], rel=1e-6)
        assert pa.phase == (t + 1) % (tau_max + 1)
        assert int(pa.head) == t + 1


@pytest.mark.parametrize("n_pods", [1, 2])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_constant_sequence_degenerates_to_v2(compression, n_pods):
    tau = 2
    layout, _ = _layouts()
    fixed = arena.init_arena(layout, tau, n_pods, compression, device="cpu")
    var = arena.init_arena(layout, tau, n_pods, compression, device="cpu",
                           variable=True)
    rng = np.random.default_rng(5)
    for t in range(3 * (tau + 1) + 2):
        g = _grads(rng, n_pods)
        counts = torch.full((n_pods,), 2.0 + t)
        gs, cs, fixed = arena.push_pop(layout, fixed, _tt(g), counts,
                                       compression)
        gv, cv, tau_obs, var = arena.push_pop_variable(
            layout, var, _tt(g), counts, tau, compression)
        eq(gs.numpy(), gv.numpy())
        assert cs.item() == cv.item()
        assert tau_obs.item() == (float(tau) if t >= tau else 0.0)
        for k in range(tau + 1):
            eq(fixed.ring[k].numpy(), var.ring[k].numpy())
            if compression == "int8":
                eq(fixed.scales[k].numpy(), var.scales[k].numpy())
        if compression == "int8":
            eq(fixed.residual.numpy(), var.residual.numpy())


# ---------------------------------------------------------------------------
# the v1 stacked ring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tau", [1, 3])
@pytest.mark.parametrize("n_pods", [1, 2])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_v1_push_pop_matches_jax_v1_and_pops_what_v2_pops(compression,
                                                         n_pods, tau):
    layout, jlayout = _layouts()
    v1 = arena.init_arena(layout, tau, n_pods, compression, device="cpu",
                          ring_version=1)
    v2 = arena.init_arena(layout, tau, n_pods, compression, device="cpu")
    j1 = jarena.init_arena(jlayout, tau, n_pods, compression,
                           ring_version=1)
    assert arena.ring_version(v1) == 1 and arena.arena_tau(v1) == tau
    jstep = functools.partial(jarena.push_pop, jlayout,
                              compression=compression, impl="ref")
    rng = np.random.default_rng(tau + n_pods)
    for t in range(tau + 3):
        g = _grads(rng, n_pods)
        counts = (np.arange(1, n_pods + 1) + 3.0 * t).astype(np.float32)
        g1, c1, v1 = arena.push_pop(layout, v1, _tt(g),
                                    torch.from_numpy(counts), compression)
        g2, c2, v2 = arena.push_pop(layout, v2, _tt(g),
                                    torch.from_numpy(counts), compression)
        jg, jc, j1 = jstep(j1, _jj(g), jnp.asarray(counts))
        eq(g1.numpy(), np.asarray(jg))
        eq(g1.numpy(), g2.numpy())
        assert c1.item() == float(jc) == c2.item()
        _assert_arena_equal(v1, j1, variable=False)


@pytest.mark.parametrize("n_pods", [1, 2])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_convert_ring_round_trip_matches_jax(compression, n_pods):
    tau = 3
    layout, jlayout = _layouts()
    v2 = arena.init_arena(layout, tau, n_pods, compression, device="cpu")
    j2 = jarena.init_arena(jlayout, tau, n_pods, compression)
    jstep = functools.partial(jarena.push_pop, jlayout,
                              compression=compression)
    rng = np.random.default_rng(9)
    for t in range(tau + 2):          # phase != 0 and every slot filled
        g = _grads(rng, n_pods)
        counts = np.full((n_pods,), 1.0 + t, np.float32)
        _, _, v2 = arena.push_pop(layout, v2, _tt(g),
                                  torch.from_numpy(counts), compression)
        _, _, j2 = jstep(j2, _jj(g), jnp.asarray(counts))
    v1 = arena.convert_ring(v2, 1)
    j1 = jarena.convert_ring(j2, 1)
    _assert_arena_equal(v1, j1, variable=False)
    back = arena.convert_ring(v1, 2)
    # JAX's own v1 -> v2 direction indexes counts with a Python list,
    # which the installed jax refuses (ROADMAP C.4): the round trip is
    # held to the v2 arena it started from
    with pytest.raises(TypeError, match="non-tuple sequence"):
        jarena.convert_ring(j1, 2)
    for k in range(tau + 1):
        src = (k + v2.phase) % (tau + 1)      # back's slot k is v2's
        if k == 0:                            # the dead push slot
            assert not back.ring[0].any()
            continue
        eq(back.ring[k].numpy(), v2.ring[src].numpy())
        eq(back.counts[k].numpy(), v2.counts[src].numpy())
        if compression == "int8":
            eq(back.scales[k].numpy(), v2.scales[src].numpy())
    # the round trip pops the same entries in the same order
    for _ in range(tau + 1):
        z = _tt({k: np.zeros((n_pods,) + s, np.float32)
                 for k, s in SHAPES.items()})
        ga, ca, v2 = arena.push_pop(layout, v2, z, torch.ones(n_pods),
                                    compression)
        gb, cb, back = arena.push_pop(layout, back, z, torch.ones(n_pods),
                                      compression)
        eq(ga.numpy(), gb.numpy())
        assert ca.item() == cb.item()
    assert arena.convert_ring(v1, 1) is v1


@pytest.mark.parametrize("head", [0, 2])
@pytest.mark.parametrize("n_pods", [1, 2])
@pytest.mark.parametrize("int8", [False, True])
def test_plain_v1_rotate_matches_jax_ref_and_interpret_kernel(int8, n_pods,
                                                              head):
    rng = np.random.default_rng(head + 3 * n_pods)
    tau, rows = 3, 256
    ring, scales = _ring(rng, tau, n_pods, rows, int8)
    g = rng.standard_normal((n_pods, rows, 128)).astype(np.float32)
    scale_new = None
    if int8:
        scale_new = rng.uniform(1e-3, 1.0, (n_pods, rows)).astype(np.float32)
        scale_new[:, :32] = 2.0 ** -6          # fed / s exact: ties, clips
        k = rng.integers(-140, 140, size=(n_pods, 32, 128))
        g[:, :32] = ((k + 0.5) * 2.0 ** -6).astype(np.float32)
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    j = lambda x: None if x is None else jnp.asarray(x)
    pr, ps, pg = t(ring), t(scales), t(g)
    popped, r_out, s_out, res = ring_push_pop(
        pr, pg, torch.tensor(head, dtype=torch.int32), scales=ps,
        scale_new=t(scale_new))
    assert r_out is pr and (s_out is ps)
    want = jref.ring_push_pop_ref(j(ring), j(g), jnp.int32(head),
                                  scales=j(scales), scale_new=j(scale_new))
    kern = jkernel.delay_ring_fwd(j(ring), j(g), jnp.int32(head),
                                  scales=j(scales), scale_new=j(scale_new),
                                  interpret=True)
    for got, w, k in ((popped, want[0], kern[0]), (r_out, want[1], kern[1])):
        eq(got.numpy(), np.asarray(w))
        eq(got.numpy(), np.asarray(k))
    if not int8:
        assert res is None
        return
    assert res is pg                            # written over fed
    eq(s_out.numpy(), np.asarray(want[2]))
    eq(s_out.numpy(), np.asarray(kern[2]))
    eq(res.numpy(), np.asarray(want[3]))
    # interpret mode contracts fed - q * s into one FMA (ROADMAP C.3):
    # the exact float64 difference rounded once
    q64 = r_out.numpy()[head].astype(np.float64)
    fused = (g.astype(np.float64)
             - q64 * scale_new[..., None].astype(np.float64))
    eq(np.asarray(kern[3]), fused.astype(np.float32))
