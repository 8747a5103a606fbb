"""The port's CUDA kernels on the card, held bitwise against their plain
PyTorch versions (on the card and on the CPU), and the main paths (a
fixed and a stochastic delay) on the card against the CPU.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode):
they carry the ``cuda`` marker and skip without a card. The module
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.delay_ring.ops import (ring_push_pop,
                                                ring_slot_rotate_int8,
                                                ring_variable_pop)
from repro_torch.kernels.dual_update.ops import dual_update_arena

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(x, device):
    return torch.from_numpy(np.array(x)).to(device)


def _update(z, g, count, alpha, device, impl="auto"):
    zt = _t(z, device)
    z_new, w = dual_update_arena(zt, _t(g, device), _t(np.float32(count),
                                                       device),
                                 _t(np.float32(alpha), device), impl=impl)
    assert z_new is zt
    return z_new.cpu().numpy(), w.cpu().numpy()


@pytest.mark.parametrize("rows", [256, 3 * 256 + 40])
@pytest.mark.parametrize("count", [0.0, 1500.0])
def test_dual_update_kernel_matches_plain_bitwise(cuda, rows, count):
    from repro_torch.kernels.dual_update import kernel
    rng = np.random.default_rng(rows)
    z = rng.standard_normal((rows, 128)).astype(np.float32)
    g = (rng.standard_normal((rows, 128)) * 300).astype(np.float32)
    alpha = np.float32(1) / (np.float32(1) + np.sqrt(np.float32(11 / 800)))
    before = kernel.KERNEL.launches
    got = _update(z, g, count, alpha, cuda)
    assert kernel.KERNEL.launches == before + 1
    for want in (_update(z, g, count, alpha, cuda, impl="ref"),
                 _update(z, g, count, alpha, "cpu")):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _rotate_inputs(n_pods, rows, seed):
    rng = np.random.default_rng(seed)
    shape = (n_pods, rows, 128)
    slot_pop = rng.integers(-127, 128, size=shape).astype(np.int8)
    scales_pop = rng.uniform(1e-3, 1.0, size=shape[:2]).astype(np.float32)
    scale_new = rng.uniform(1e-3, 1.0, size=shape[:2]).astype(np.float32)
    fed = rng.standard_normal(shape).astype(np.float32)
    scale_new[:, :32] = 2.0 ** -6           # fed / s exact: ties, clips
    k = rng.integers(-140, 140, size=(n_pods, 32, 128))
    fed[:, :32] = ((k + 0.5) * 2.0 ** -6).astype(np.float32)
    slot_push = np.zeros(shape, np.int8)
    scales_push = np.zeros(shape[:2], np.float32)
    return slot_pop, scales_pop, slot_push, scales_push, fed, scale_new


def _rotate(args, device, impl="auto"):
    ts = [_t(a, device) for a in args]
    out = ring_slot_rotate_int8(*ts, impl=impl)
    return [x.cpu().numpy() for x in out]


@pytest.mark.parametrize("n_pods,rows", [(1, 256), (3, 256 + 40)])
def test_slot_rotate_kernel_matches_plain_bitwise(cuda, n_pods, rows):
    from repro_torch.kernels.delay_ring import kernel
    args = _rotate_inputs(n_pods, rows, seed=7)
    before = kernel.KERNEL.launches
    got = _rotate(args, cuda)
    assert kernel.KERNEL.launches == before + 1
    for want in (_rotate(args, cuda, impl="ref"), _rotate(args, "cpu")):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _variable_inputs(int8, n_pods, rows, seed):
    rng = np.random.default_rng(seed)
    shape = (7, n_pods, rows, 128)
    if int8:
        ring = rng.integers(-127, 128, size=shape).astype(np.int8)
        scales = rng.uniform(1e-3, 1.0, size=shape[:3]).astype(np.float32)
        scales[5, :, :3] = np.inf           # slot 5 is never due below
    else:
        ring = rng.standard_normal(shape).astype(np.float32)
        ring[5, :, :3] = np.inf
        scales = None
    cs = np.stack([rng.integers(0, 300, 7),
                   rng.integers(0, 8, 7)]).astype(np.float32)
    return ring, scales, cs


@pytest.mark.parametrize("due", [(), (2,), (0, 6), (1, 3, 4)])
@pytest.mark.parametrize("n_pods,rows", [(1, 256), (2, 256 + 40)])
@pytest.mark.parametrize("int8", [False, True])
def test_variable_pop_kernel_matches_plain_bitwise(cuda, int8, n_pods, rows,
                                                   due):
    """The masked pop and its (count, stale_sum) epilogue, kernel vs
    plain version on the card and on the CPU: bitwise, with an inf in a
    slot that is not due (it must not reach the result)."""
    from repro_torch.kernels.delay_ring import kernel
    ring, scales, cs = _variable_inputs(int8, n_pods, rows, len(due))
    mask = np.zeros(7, bool)
    mask[list(due)] = True

    def run(device, impl="auto"):
        popped, meta = ring_variable_pop(
            _t(ring, device), _t(mask, device),
            scales=None if scales is None else _t(scales, device),
            counts_stale=_t(cs, device), impl=impl)
        return popped.cpu().numpy(), meta.cpu().numpy()

    before = kernel.VARIABLE_POP_KERNEL.launches
    got = run(cuda)
    assert kernel.VARIABLE_POP_KERNEL.launches == before + 1
    assert np.isfinite(got[0]).all()
    for want in (run(cuda, impl="ref"), run("cpu")):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("head", [0, 3])
@pytest.mark.parametrize("n_pods,rows", [(1, 256), (2, 256 + 40)])
@pytest.mark.parametrize("int8", [False, True])
def test_ring_rotate_kernel_matches_plain_bitwise(cuda, int8, n_pods, rows,
                                                  head):
    """The v1 rotate, kernel vs plain version on the card and the CPU:
    popped, ring, scales and residual bitwise (fed / s on ties and past
    the clip under int8)."""
    from repro_torch.kernels.delay_ring import kernel
    rng = np.random.default_rng(head + n_pods)
    tau = 4
    args = _rotate_inputs(n_pods, rows, seed=head)
    fed, scale_new = args[4], args[5]
    if int8:
        ring = rng.integers(-127, 128, size=(tau, n_pods, rows, 128)
                            ).astype(np.int8)
        scales = rng.uniform(1e-3, 1.0, (tau, n_pods, rows)
                             ).astype(np.float32)
    else:
        ring = rng.standard_normal((tau, n_pods, rows, 128)
                                   ).astype(np.float32)
        scales = scale_new = None

    def run(device, impl="auto"):
        r = _t(ring, device)
        s = None if scales is None else _t(scales, device)
        g = _t(fed, device)
        out = ring_push_pop(r, g, _t(np.int32(head), device), scales=s,
                            scale_new=None if scale_new is None
                            else _t(scale_new, device), impl=impl)
        assert out[1] is r and out[2] is s
        return [x.cpu().numpy() for x in out if x is not None]

    before = kernel.RING_KERNEL.launches
    got = run(cuda)
    assert kernel.RING_KERNEL.launches == before + 1
    for want in (run(cuda, impl="ref"), run("cpu")):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_stochastic_delay_on_cuda_matches_cpu(cuda, compression):
    """12 steps of AMB-DG under a heavy-tailed delay (tau_max = 8) on the
    SMOKE linear regression, card vs CPU: applied counts and tau_applied
    exact, one variable-pop launch per step and no ring rotate; w to
    float32 summation-order tolerance (plus one quantization step under
    int8)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (AmbdgConfig, DelayConfig,
                                          MeshConfig, RunConfig, TRAIN_4K)
    from repro_torch.kernels.delay_ring import kernel as ring_kernel
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("amb-linreg")
    rc = RunConfig(model=cfg, shape=TRAIN_4K, mesh=MeshConfig(1, 1, 1),
                   ambdg=AmbdgConfig(tau=4, b_bar=800.0, proximal="l2_ball",
                                     radius_C=1.05 * 128 ** 0.5,
                                     pod_compression=compression),
                   delay=DelayConfig(process="heavy_tail", tau_max=8,
                                     seed=7))
    loop = LoopConfig(n_steps=12, n_workers=8, samples_per_worker=16,
                      log_every=1)
    counters = (ring_kernel.VARIABLE_POP_KERNEL, ring_kernel.KERNEL)
    n0 = [k.launches for k in counters]
    gpu = train(build_model(cfg, device=cuda), rc, loop, device=cuda)
    n1 = [k.launches for k in counters]
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (12, 0)
    cpu = train(build_model(cfg, device="cpu"), rc, loop, device="cpu")
    for a, b in zip(gpu["history"], cpu["history"]):
        assert a["applied_count"] == b["applied_count"]
        assert a["tau_applied"] == b["tau_applied"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    wg = gpu["state"].params["w"].cpu().numpy()
    wc = cpu["state"].params["w"].numpy()
    tol = 1e-5 * np.abs(wc).max()
    if compression == "int8":
        tol += float(cpu["state"].arena.scales.max()) / min(
            h["applied_count"] for h in cpu["history"]
            if h["applied_count"])
    np.testing.assert_allclose(wg, wc, rtol=0, atol=tol)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_slice_on_cuda_matches_cpu(cuda, compression):
    """8 steps of AMB-DG (tau = 2) on the SMOKE linear regression, card
    vs CPU from the same seed: applied counts exact, w to float32
    summation-order tolerance (plus one quantization step under int8);
    every step launched the dual-update kernel (and the rotate, int8)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (AmbdgConfig, MeshConfig,
                                          RunConfig, TRAIN_4K)
    from repro_torch.kernels.delay_ring import kernel as ring_kernel
    from repro_torch.kernels.dual_update import kernel as update_kernel
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("amb-linreg")
    rc = RunConfig(model=cfg, shape=TRAIN_4K, mesh=MeshConfig(1, 1, 1),
                   ambdg=AmbdgConfig(tau=2, b_bar=800.0, proximal="l2_ball",
                                     radius_C=1.05 * 128 ** 0.5,
                                     pod_compression=compression))
    loop = LoopConfig(n_steps=8, n_workers=8, samples_per_worker=16,
                      log_every=1)
    n0 = (update_kernel.KERNEL.launches, ring_kernel.KERNEL.launches)
    gpu = train(build_model(cfg, device=cuda), rc, loop, device=cuda)
    n1 = (update_kernel.KERNEL.launches, ring_kernel.KERNEL.launches)
    assert n1[0] - n0[0] == 8
    assert n1[1] - n0[1] == (8 if compression == "int8" else 0)
    cpu = train(build_model(cfg, device="cpu"), rc, loop, device="cpu")
    for a, b in zip(gpu["history"], cpu["history"]):
        assert a["applied_count"] == b["applied_count"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    wg = gpu["state"].params["w"].cpu().numpy()
    wc = cpu["state"].params["w"].numpy()
    tol = 1e-5 * np.abs(wc).max()
    if compression == "int8":
        tol += max(float(s.max()) for s in cpu["state"].arena.scales) / min(
            h["applied_count"] for h in cpu["history"][2:])
    np.testing.assert_allclose(wg, wc, rtol=0, atol=tol)


# -- flash attention --------------------------------------------------------
FLASH_CASES = [   # B, Hq, Hkv, Sq, Skv, D, causal, window
    (2, 4, 4, 256, 256, 64, True, None),
    (1, 8, 2, 192, 192, 128, True, None),     # GQA, a ragged last tile
    (2, 4, 1, 256, 512, 64, True, None),      # MQA, right-aligned q
    (1, 4, 2, 320, 320, 64, True, 96),        # sliding window
    (1, 2, 2, 128, 256, 128, False, None),    # bidirectional
    (1, 2, 2, 256, 128, 64, True, None),      # rows with no valid key
    (1, 4, 4, 1024, 1024, 64, False, None),   # the encoder: multi-tile
    (1, 4, 4, 320, 1152, 128, False, None),   # the cross-attention
    (1, 4, 4, 256, 256, 80, True, None),      # zamba2's head dim
    (1, 8, 2, 192, 192, 80, True, 96),        # ragged GQA, a window
    (1, 2, 2, 128, 320, 80, False, None),     # non-causal
    (1, 8, 1, 256, 256, 256, True, None),     # paligemma's head layout
    (1, 4, 2, 200, 200, 256, True, 64),       # ragged GQA, a window
    (1, 2, 2, 100, 70, 256, False, None),     # non-causal, ragged
]


def _flash_inputs(case, dtype, device, seed=0):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    rng = np.random.default_rng(seed)
    shapes = [(B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
              (B, Hq, Sq, D)]
    return [_t(rng.standard_normal(s).astype(np.float32), device).to(dtype)
            for s in shapes]


def _close(got, want, ulp):
    """Each element on its own: |got - want| <= ulp * |want| + 1e-5 *
    max|want| (f32 compare)."""
    got, want = got.float().cpu(), want.float().cpu()
    limit = ulp * want.abs() + 1e-5 * (float(want.abs().max()) or 1.0)
    excess = float(((got - want).abs() / limit).max())
    assert excess <= 1.0, excess


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, case, dtype):
    """The forward (with and without lse), dq and dk/dv kernels against
    their plain versions on the card and on the CPU. Both compute in
    f32 and round the outputs once, so each element agrees to 1e-5 of
    the tensor's largest element (summation order) plus, in bf16, one
    ulp of the element (2^-7 of it: one rounding can land on either
    side). Two launches give the same bits."""
    from repro_torch.kernels.flash_attention import kernel, ref
    td = getattr(torch, dtype)
    causal, window = case[6], case[7]
    kw = dict(causal=causal, window=window, scale=case[5] ** -0.5)
    ulp = 0.0 if dtype == "float32" else 2.0 ** -7
    q, k, v, do = _flash_inputs(case, td, cuda)
    n0 = [c.launches for c in (kernel.FWD, kernel.FWD_LSE, kernel.DQ,
                               kernel.DKV)]
    o = kernel.flash_attention_fwd(q, k, v, **kw)
    o2, lse = kernel.flash_fwd_lse(q, k, v, **kw)
    assert torch.equal(o, o2)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    dq = kernel.flash_bwd_dq(q, k, v, lse, delta, do, **kw)
    dk, dv = kernel.flash_bwd_dkv(q, k, v, lse, delta, do, **kw)
    torch.cuda.synchronize()
    assert [c.launches for c in (kernel.FWD, kernel.FWD_LSE, kernel.DQ,
                                 kernel.DKV)] == [n + 1 for n in n0]
    for dev in (cuda, "cpu"):
        args = [x.to(dev) for x in (q, k, v)]
        o_ref, lse_ref = ref.flash_fwd_lse_ref(*args, **kw)
        _close(o, o_ref, ulp)
        _close(o, ref.attention_ref(*args, causal=causal, window=window),
               ulp)
        # lse: f32 in both; rows with no valid key hold -1e30 exactly
        assert torch.allclose(lse.cpu(), lse_ref.cpu(), rtol=1e-5,
                              atol=1e-4)
        bargs = args + [lse.to(dev), delta.to(dev), do.to(dev)]
        _close(dq, ref.flash_bwd_dq_ref(*bargs, **kw), ulp)
        for a, b in zip((dk, dv), ref.flash_bwd_dkv_ref(*bargs, **kw)):
            _close(a, b, ulp)
    # bitwise repeatable: no atomics
    assert torch.equal(kernel.flash_attention_fwd(q, k, v, **kw), o)
    assert torch.equal(kernel.flash_bwd_dq(q, k, v, lse, delta, do, **kw),
                       dq)
    dk2, dv2 = kernel.flash_bwd_dkv(q, k, v, lse, delta, do, **kw)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def test_flash_train_autograd_on_cuda_matches_cpu(cuda):
    """``flash_attention_train`` on CUDA tensors (the kernels through
    ``FlashAttentionTrain``) against autograd of the plain version on
    the CPU, f32, with JAX's cotangent sum(o cos o)."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention_train
    case = (1, 4, 2, 256, 256, 64, True, None)
    q, k, v, _ = _flash_inputs(case, torch.float32, "cpu", seed=3)

    def grads(device):
        ts = [x.to(device).requires_grad_(True) for x in (q, k, v)]
        o = flash_attention_train(*ts, True, None, 64, 64)
        torch.sum(o * torch.cos(o)).backward()
        return [t.grad.cpu() for t in ts]

    n0 = kernel.DQ.launches
    got = grads(cuda)
    assert kernel.DQ.launches == n0 + 1
    for a, b in zip(got, grads("cpu")):
        assert torch.allclose(a, b, atol=2e-4, rtol=2e-3)


def test_lm_on_cuda_matches_cpu(cuda):
    """Three AMB-DG steps (tau 2, int8) of a small qwen1.5-style model
    with head dim 64 (the kernels' width), f32 compute, attn_impl
    "flash": the card (the kernels) against the CPU (the plain
    version); counts exact, loss to 1e-4, w to 1e-4 of its largest
    element plus one quantization step; one dq launch per layer and
    microbatch."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (AmbdgConfig, MeshConfig,
                                          RunConfig, TRAIN_4K)
    from repro_torch.core.arena import tree_flatten
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), d_model=128,
                              n_heads=2, n_kv_heads=2, head_dim=64,
                              compute_dtype="float32", attn_impl="flash")
    rc = RunConfig(model=cfg, shape=dataclasses.replace(TRAIN_4K, seq_len=128),
                   mesh=MeshConfig(1, 1, 1),
                   ambdg=AmbdgConfig(tau=2, n_microbatches=2, b_bar=8.0,
                                     pod_compression="int8"))
    loop = LoopConfig(n_steps=3, n_workers=2, samples_per_worker=2,
                      log_every=1)
    n0 = kernel.DQ.launches
    gpu = train(build_model(cfg, device=cuda), rc, loop, device=cuda)
    assert kernel.DQ.launches - n0 == cfg.n_layers * 2 * 3
    cpu = train(build_model(cfg, device="cpu"), rc, loop, device="cpu")
    for a, b in zip(gpu["history"], cpu["history"]):
        assert a["applied_count"] == b["applied_count"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    step = max(float(s.max()) for s in cpu["state"].arena.scales) / \
        cpu["history"][-1]["applied_count"]
    for wg, wc in zip(tree_flatten(gpu["state"].params)[0],
                      tree_flatten(cpu["state"].params)[0]):
        wg, wc = wg.cpu().numpy(), wc.numpy()
        np.testing.assert_allclose(wg, wc, rtol=0,
                                   atol=1e-4 * np.abs(wc).max() + step)


# -- the linear scan and the pytree dual update (the hybrid slice) ----------
SCAN_CASES = [   # BH, BHG, S, ds, hd, chunk, q/k dtype, v dtype, decay
    (4, 4, 256, 32, 64, 128, "float32", "float32", 0.1),
    (6, 2, 256, 16, 32, 64, "float32", "float32", 0.1),      # grouped
    (2, 2, 512, 64, 64, 128, "bfloat16", "bfloat16", 0.1),
    (8, 2, 512, 64, 64, 256, "bfloat16", "float32", 0.1),    # the mapping's
    (3, 1, 90, 128, 16, 45, "float32", "float32", 5.0),      # ragged chunk
    (4, 1, 512, 64, 64, 64, "float32", "float32", 2.0),      # 8 chunks
]


def _scan_inputs(case, device, seed=0):
    BH, BHG, S, ds, hd, _, qd, vd, decay = case
    rng = np.random.default_rng(seed)
    g = -np.abs(rng.standard_normal((BH, S))) * decay
    q = rng.standard_normal((BHG, S, ds))
    k = rng.standard_normal((BHG, S, ds)) * 0.1
    v = rng.standard_normal((BH, S, hd))
    return (_t(g.astype(np.float32), device),
            _t(q.astype(np.float32), device).to(getattr(torch, qd)),
            _t(k.astype(np.float32), device).to(getattr(torch, qd)),
            _t(v.astype(np.float32), device).to(getattr(torch, vd)))


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_linear_scan_kernel_matches_plain(cuda, case, strict):
    """The scan kernel (forward, and the strict form of the backward's
    dq and dk calls), with its inter-chunk part, against the plain
    recurrence on the card and on the CPU. Both keep an f32 state and
    round y once: each element agrees to 5e-5 of the tensor's largest
    element (the chunked form sums in another order) plus, for a bf16 y,
    one ulp of the element. Two launches give the same bits."""
    from repro_torch.kernels.linear_scan import kernel
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref
    chunk = case[5]
    g, q, k, v = _scan_inputs(case, cuda)
    n0 = kernel.FWD.launches
    y = kernel.linear_scan_fwd(g, q, k, v, chunk=chunk, strict=strict)
    torch.cuda.synchronize()
    assert kernel.FWD.launches == n0 + 1
    assert y.dtype == v.dtype and y.shape == v.shape
    ulp = 2.0 ** -7 if v.dtype == torch.bfloat16 else 0.0
    y2, y_inter = kernel.linear_scan_fwd(g, q, k, v, chunk=chunk,
                                         strict=strict, with_inter=True)
    assert torch.equal(y2, y) and y_inter.dtype == torch.float32
    for dev in (cuda, "cpu"):
        want, want_inter = linear_scan_ref(*(x.to(dev) for x in (g, q, k, v)),
                                           strict, chunk)
        for a, b, u in ((y, want, ulp), (y_inter, want_inter, 0.0)):
            a, b = a.float().cpu(), b.float().cpu()
            limit = u * b.abs() + 5e-5 * float(b.abs().max() or 1.0)
            assert bool(((a - b).abs() <= limit).all())
    assert torch.equal(kernel.linear_scan_fwd(g, q, k, v, chunk=chunk,
                                              strict=strict), y)


def test_linear_scan_takes_unaligned_views(cuda):
    """Contiguous views that do not start on 16 bytes (the kernels load
    by 16-byte ``cp.async``) give the same bits as aligned copies."""
    from repro_torch.kernels.linear_scan import kernel
    g, q, k, v = _scan_inputs((2, 1, 128, 16, 32, 32, "float32", "float32",
                               0.5), cuda)
    shifted = [torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(
        x.shape) for x in (q, k, v)]
    assert all(x.data_ptr() % 16 for x in shifted)
    assert torch.equal(kernel.linear_scan_fwd(g, *shifted, chunk=32),
                       kernel.linear_scan_fwd(g, q, k, v, chunk=32))


def test_linear_scan_carries_a_nan(cuda):
    """A NaN in v (the bits the card's own arithmetic gives, 0x7fffffff)
    reaches every later output of its column, as in the recurrence."""
    from repro_torch.kernels.linear_scan import kernel
    g, q, k, v = _scan_inputs((2, 1, 128, 16, 32, 32, "float32", "float32",
                               0.1), cuda)
    v[0, 5, 0] = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(
        torch.float32)
    y = kernel.linear_scan_fwd(g, q, k, v, chunk=32)
    assert bool(torch.isnan(y[0, 5:, 0]).all())
    assert bool(torch.isfinite(y[1]).all())


def test_linear_scan_train_on_cuda_matches_cpu(cuda):
    """``linear_scan_train`` on CUDA tensors (the kernel, three backward
    launches) against the CPU's plain recurrence through the same
    Function, f32, rep 3, with the cotangent sum(y cos y)."""
    from repro_torch.kernels.linear_scan import kernel
    from repro_torch.kernels.linear_scan.ops import linear_scan_train
    case = (6, 2, 128, 16, 32, 32, "float32", "float32", 0.5)
    inputs = _scan_inputs(case, "cpu", seed=3)

    def grads(device):
        ts = [x.to(device).requires_grad_(True) for x in inputs]
        y = linear_scan_train(*ts, chunk=32)
        torch.sum(y * torch.cos(y)).backward()
        return [t.grad.cpu() for t in ts]

    n0 = kernel.BWD.launches
    got = grads(cuda)
    assert kernel.BWD.launches == n0 + 3
    for a, b in zip(got, grads("cpu")):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_dual_update_pytree_kernel_matches_plain_bitwise(cuda):
    from repro_torch.kernels.dual_update import kernel
    from repro_torch.kernels.dual_update.ops import dual_update
    rng = np.random.default_rng(1)
    shapes = [(10, 100), (77,), (3, 5, 7)]
    z = {f"p{i}": rng.standard_normal(s).astype(np.float32)
         for i, s in enumerate(shapes)}
    g = {f"p{i}": (rng.standard_normal(s) * 300).astype(np.float32)
         for i, s in enumerate(shapes)}
    n0 = kernel.UPDATE.launches
    got = dual_update({k: _t(v, cuda) for k, v in z.items()},
                      {k: _t(v, cuda) for k, v in g.items()}, 0.37)
    assert kernel.UPDATE.launches == n0 + 1
    for dev in (cuda, "cpu"):
        want = dual_update({k: _t(v, dev) for k, v in z.items()},
                           {k: _t(v, dev) for k, v in g.items()}, 0.37,
                           impl="ref")
        for a, b in zip(got, want):
            for k in z:
                assert torch.equal(a[k].cpu(), b[k].cpu())


@pytest.mark.parametrize("scan_impl", ["kernel", "xla"])
def test_hybrid_on_cuda_matches_cpu(cuda, scan_impl):
    """Three AMB-DG steps (tau 2, int8) of zamba2 SMOKE in f32 compute
    on a 45-token sequence (padded to 64 inside the Mamba2 layers), the
    card against the CPU; with scan_impl "kernel" the scan kernel
    launches twice (forward and its recomputation) and its backward
    forms three times per layer and microbatch."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (AmbdgConfig, MeshConfig,
                                          RunConfig, TRAIN_4K)
    from repro_torch.core.arena import tree_flatten
    from repro_torch.kernels.linear_scan import kernel
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"),
                              compute_dtype="float32", scan_impl=scan_impl)
    rc = RunConfig(model=cfg, shape=dataclasses.replace(TRAIN_4K, seq_len=45),
                   mesh=MeshConfig(1, 1, 1),
                   ambdg=AmbdgConfig(tau=2, n_microbatches=2, b_bar=8.0,
                                     pod_compression="int8"))
    loop = LoopConfig(n_steps=3, n_workers=2, samples_per_worker=2,
                      log_every=1)
    n0 = (kernel.FWD.launches, kernel.BWD.launches)
    gpu = train(build_model(cfg, device=cuda), rc, loop, device=cuda)
    per = cfg.n_layers * 2 * 3 if scan_impl == "kernel" else 0
    assert (kernel.FWD.launches - n0[0], kernel.BWD.launches - n0[1]) == (
        2 * per, 3 * per)
    cpu = train(build_model(cfg, device="cpu"), rc, loop, device="cpu")
    for a, b in zip(gpu["history"], cpu["history"]):
        assert a["applied_count"] == b["applied_count"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    step = max(float(s.max()) for s in cpu["state"].arena.scales) / \
        cpu["history"][-1]["applied_count"]
    for wg, wc in zip(tree_flatten(gpu["state"].params)[0],
                      tree_flatten(cpu["state"].params)[0]):
        wg, wc = wg.cpu().numpy(), wc.numpy()
        np.testing.assert_allclose(wg, wc, rtol=0,
                                   atol=1e-4 * np.abs(wc).max() + step)


def test_zamba2_shared_block_flash_on_cuda_matches_cpu(cuda):
    """zamba2 SMOKE with its shared block at the full config's head dim
    of 80 under ``attn_impl="flash"``, f32, TF32 off: the worker's
    gradient on the card (the flash kernels, D = 80) against the CPU's
    (the plain version), each leaf within 1e-4 of its largest element,
    the loss to 1e-5; dq launches once per shared-block application."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"), head_dim=80,
                              attn_impl="flash", compute_dtype="float32")
    assert cfg.resolved_head_dim == 80
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(4))
    batch = build_model(cfg, device="cpu").dummy_batch(
        2, 128, torch.Generator().manual_seed(5))
    n0 = kernel.DQ.launches
    got, loss = _grads(cfg, params, batch, cuda)
    assert kernel.DQ.launches - n0 == cfg.n_layers // cfg.shared_attn_every
    want, want_loss = _grads(cfg, params, batch, "cpu")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _linreg64():
    from repro_torch.configs.base import LINREG, ModelConfig
    return ModelConfig(name="linreg", family=LINREG, n_layers=0, d_model=0,
                       n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
                       linreg_dim=64)


@pytest.mark.parametrize("golden,scheme", [
    ("sim_trace", "ambdg"), ("sim_trace", "amb"),
    ("stochastic_trace", "ambdg"), ("stochastic_trace", "kbatch")])
def test_sim_golden_traces_on_cuda(cuda, golden, scheme):
    """The simulator's golden traces with the gradients on the card: the
    bookkeeping columns exactly, the errors at rtol 1e-4, atol 1e-7
    (``tests/test_torch_sim.py`` runs the same on the CPU)."""
    import json
    import os
    from repro_torch.configs.base import AmbdgConfig, DelayConfig
    from repro_torch.core.delay_process import make_delay_process
    from repro_torch.data.timing import ShiftedExponential
    from repro_torch.sim import SimProblem, simulate_anytime, simulate_kbatch
    torch.backends.cuda.matmul.allow_tf32 = False
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", golden + ".json")
    with open(path) as f:
        want = json.load(f)[scheme]
    opt = AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                      b_bar=180.0, proximal="l2_ball",
                      radius_C=float(1.05 * np.sqrt(64)))
    kw = dict(t_c=10.0, total_time=60.0, opt_cfg=opt, rng_seed=11,
              timing=ShiftedExponential(lam=2 / 3, xi=1.0, b=60))
    if golden == "stochastic_trace":
        kw["delay_process"] = make_delay_process(
            DelayConfig(process="heavy_tail", tau_max=6, seed=13),
            opt.staleness)
    problem = SimProblem(_linreg64(), n_workers=3, seed=7, b_max=128,
                         device=cuda)
    if scheme == "kbatch":
        tr = simulate_kbatch(problem, b_per_msg=32, K=3, t_p=2.5, **kw)
    else:
        tr = simulate_anytime(problem, t_p=2.5, scheme=scheme, **kw)
    assert tr.final_params["w"].device.type == "cuda"
    got = {"times": [round(t, 9) for t in tr.times],
           "epochs": list(tr.epochs), "delays": list(tr.delays),
           "minibatches": list(tr.minibatches),
           "staleness": list(tr.staleness)}
    for k in want:
        if k != "errors":
            assert got[k] == want[k], k
    np.testing.assert_allclose(tr.errors, want["errors"], rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("n_pods", [1, 4])
@pytest.mark.parametrize("tau", [0, 1, 4])
def test_pytree_master_equals_arena_master_on_cuda(cuda, tau, n_pods,
                                                   compression):
    """The pytree master against the arena master (the CUDA kernels) on
    the card, ten steps of odd leaf shapes: params and z bit for bit;
    the arena launches the dual update once a step and, for tau > 0
    under int8, the slot rotate once a step; the pytree master launches
    nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import AmbdgConfig, MeshConfig, RunConfig
    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.core import ambdg, arena, delayed
    from repro_torch.core.arena import tree_flatten
    from repro_torch.kernels.delay_ring import kernel as ring_kernel
    from repro_torch.kernels.dual_update import kernel as update_kernel
    from repro_torch.optim import make_arena_optimizer, make_optimizer
    rc = RunConfig(model=get_smoke_config("amb-linreg"), shape=TRAIN_4K,
                   mesh=MeshConfig(1, 1, 1),
                   ambdg=AmbdgConfig(tau=tau, b_bar=8.0, smoothness_L=2.0,
                                     pod_compression=compression))
    shapes = {"a": (7,), "b": {"c": (3, 5), "d": (130,)}, "e": (257,)}
    rng = np.random.default_rng(tau + 10 * n_pods)

    def tree(lead=()):
        def leaf(s):
            return _t(rng.standard_normal(lead + s).astype(np.float32), cuda)
        return {"a": leaf(shapes["a"]), "e": leaf(shapes["e"]),
                "b": {k: leaf(s) for k, s in shapes["b"].items()}}

    params = tree()
    layout = arena.make_layout(params)
    opt_p, opt_a = make_optimizer(rc), make_arena_optimizer(rc, layout, cuda)
    p_ref, o_ref = params, opt_p.init(params)
    buf = delayed.init_buffer(params, tau, n_pods, compression)
    p_ar, o_ar = params, opt_a.init()
    ar = arena.init_arena(layout, tau, n_pods, compression, device=cuda)
    counters = (update_kernel.KERNEL, ring_kernel.KERNEL)
    for t in range(10):
        grads, counts = tree((n_pods,)), torch.full((n_pods,), 3.0 + t,
                                                   device=cuda)
        n0 = [k.launches for k in counters]
        p_ref, o_ref, buf, _, _ = ambdg.pytree_master_update(
            opt_p, p_ref, o_ref, buf, grads, counts, compression)
        assert [k.launches for k in counters] == n0
        p_ar, o_ar, ar, _, _ = ambdg.arena_master_update(
            layout, opt_a, p_ar, o_ar, ar, grads, counts, compression)
        rotates = int(compression == "int8" and tau > 0)
        assert [k.launches - n for k, n in zip(counters, n0)] == [1, rotates]
        z_ar = arena.unflatten_tree(layout, o_ar.z, cast=False)
        for a, b in zip(tree_flatten(p_ref)[0] + tree_flatten(o_ref.z)[0],
                        tree_flatten(p_ar)[0] + tree_flatten(z_ar)[0]):
            assert torch.equal(a, b), t


def test_kbatch_step_is_the_amb_step_on_cuda(cuda):
    """The K-batch strategy's device step on the card: ref_epoch counts
    the steps, the staleness is 0, the dual update launches once a step,
    and the params equal the 'amb' strategy's bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import AmbdgConfig, MeshConfig, RunConfig
    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.kernels.dual_update import kernel
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    cfg = get_smoke_config("amb-linreg")
    loop = LoopConfig(n_steps=4, n_workers=4, samples_per_worker=8,
                      log_every=1)
    out = {}
    for strategy in ("kbatch", "amb"):
        rc = RunConfig(model=cfg, shape=TRAIN_4K, mesh=MeshConfig(1, 1, 1),
                       ambdg=AmbdgConfig(tau=2, b_bar=32.0),
                       strategy=strategy)
        n0 = kernel.KERNEL.launches
        out[strategy] = train(build_model(cfg, device=cuda), rc, loop,
                              device=cuda)
        assert kernel.KERNEL.launches == n0 + 4
    kb = out["kbatch"]
    assert int(kb["state"].ref_epoch) == 5
    assert [h["staleness"] for h in kb["history"]] == [0.0] * 4
    assert torch.equal(kb["state"].base.params["w"],
                       out["amb"]["state"].params["w"])


def _scenario_rc(cfg, compression="none", **kw):
    from repro_torch.configs.base import AmbdgConfig, MeshConfig, RunConfig
    from repro_torch.configs.base import TRAIN_4K
    return RunConfig(model=cfg, shape=TRAIN_4K, mesh=MeshConfig(1, 1, 1),
                     ambdg=AmbdgConfig(t_p=10.0, t_c=10.0, tau=1,
                                       smoothness_L=4.0, b_bar=240.0,
                                       n_microbatches=2,
                                       pod_compression=compression), **kw)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_cnn_on_cuda_matches_cpu(cuda, compression):
    """amb-cnn SMOKE through ``train`` on the card (TF32 off: cuDNN's
    default would round the f32 convolutions to TF32) against the CPU, 3
    steps of 2 workers x 8 images, tau 1: applied counts exact, losses
    to rtol 1e-4, weights to 1e-4 of each leaf's largest element plus
    one int8 step; the dual update launches once a step, and under int8
    the slot rotate once a step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.delay_ring import kernel as ring_kernel
    from repro_torch.kernels.dual_update import kernel as update_kernel
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config("amb-cnn")
    rc = _scenario_rc(cfg, compression)
    loop = LoopConfig(n_steps=3, n_workers=2, samples_per_worker=8,
                      log_every=1)
    n0 = (update_kernel.KERNEL.launches, ring_kernel.KERNEL.launches)
    gpu = train(build_model(cfg, device=cuda), rc, loop, device=cuda)
    assert (update_kernel.KERNEL.launches - n0[0],
            ring_kernel.KERNEL.launches - n0[1]) == (
                3, 3 if compression == "int8" else 0)
    cpu = train(build_model(cfg, device="cpu"), rc, loop, device="cpu")
    for a, b in zip(gpu["history"], cpu["history"]):
        assert a["applied_count"] == b["applied_count"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    step = 0.0
    if compression == "int8":
        step = max(float(s.max()) for s in cpu["state"].arena.scales) / 8.0
    for k, w in cpu["state"].params.items():
        got = gpu["state"].params[k].cpu().numpy()
        np.testing.assert_allclose(got, w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()) + step)


def test_batch_schedule_golden_on_cuda(cuda):
    """Both halves of ``tests/golden/batch_schedule_trace.json`` with the
    gradients on the card: bookkeeping exact, errors at rtol 1e-4."""
    import json
    import os
    from repro_torch.configs.base import (AmbdgConfig, BatchScheduleConfig,
                                          DelayConfig)
    from repro_torch.core.batch_schedule import make_batch_schedule
    from repro_torch.core.delay_process import make_delay_process
    from repro_torch.data.timing import ShiftedExponential
    from repro_torch.sim import SimProblem, simulate_anytime, simulate_kbatch
    torch.backends.cuda.matmul.allow_tf32 = False
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "batch_schedule_trace.json")
    with open(path) as f:
        want = json.load(f)
    opt = AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                      b_bar=180.0, proximal="l2_ball",
                      radius_C=float(1.05 * np.sqrt(64)))
    kw = dict(t_c=10.0, total_time=60.0, opt_cfg=opt, rng_seed=11, t_p=2.5,
              timing=ShiftedExponential(lam=2 / 3, xi=1.0, b=60))
    ada = BatchScheduleConfig(schedule="adadamp", b0=12, b_cap=96,
                              growth_factor=2.0, ema=0.3, seed=5)
    lin = BatchScheduleConfig(schedule="linear", b0=16, b_cap=128,
                              growth_rate=2.0, seed=5)

    def problem():
        return SimProblem(_linreg64(), n_workers=3, seed=7, b_max=128,
                          device=cuda)

    traces = {
        "ambdg": simulate_anytime(
            problem(), scheme="ambdg",
            delay_process=make_delay_process(DelayConfig(
                process="heavy_tail", tau_max=6, seed=13), opt.staleness),
            batch_schedule=make_batch_schedule(ada, opt.b_bar, opt.staleness),
            **kw),
        "kbatch": simulate_kbatch(
            problem(), b_per_msg=32, K=3,
            batch_schedule=make_batch_schedule(lin, opt.b_bar, opt.staleness),
            **kw)}
    for scheme, tr in traces.items():
        w = want[scheme]
        assert [round(t, 9) for t in tr.times] == w["times"], scheme
        assert list(tr.targets) == w["targets"], scheme
        assert list(tr.staleness) == w["staleness"], scheme
        assert list(tr.clamps) == w["clamps"], scheme
        if "minibatches" in w:
            assert list(tr.minibatches) == w["minibatches"]
            assert list(tr.delays) == w["delays"]
        np.testing.assert_allclose(tr.errors, w["errors"], rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("process", ["churn", "crash_restart"])
def test_restart_on_cuda_is_bitwise(cuda, process, tmp_path):
    """amb-linreg SMOKE under an elastic process with int8 on the card:
    stopped at step 6 and restarted from its checkpoint, it ends where
    the uninterrupted 12-step run ends, every state leaf bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.models.api import build_model
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import LoopConfig, train
    cfg = get_smoke_config("amb-linreg")
    elastic = (dict(process="churn", p_fail=0.25, p_recover=0.3, seed=1)
               if process == "churn" else
               dict(process="crash_restart", mttf=4.0, mttr=3.0, seed=2))
    rc = _scenario_rc(cfg, "int8", elastic=ElasticConfig(**elastic))

    def run(n, d):
        return train(build_model(cfg, device=cuda), rc, LoopConfig(
            n_steps=n, n_workers=4, samples_per_worker=16, log_every=1,
            ckpt_dir=str(d), ckpt_every=6, eviction_misses=2), device=cuda)

    whole = run(12, tmp_path / "a")
    run(6, tmp_path / "b")
    rest = run(12, tmp_path / "b")
    la = checkpoint._flatten_with_paths(whole["state"])
    lb = checkpoint._flatten_with_paths(rest["state"])
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.device.type == "cuda" and torch.equal(x, y), k
    assert whole["remesh_events"]


# -- the decentralized gossip ---------------------------------------------------
@pytest.mark.parametrize("topology,n", [("ring", 8), ("torus", 4),
                                        ("torus", 16), ("complete", 6)])
def test_gossip_folds_on_cuda_match_cpu_bitwise(cuda, topology, n):
    """The int8 fold (values and residual) and the masked fold, 3 rounds,
    on the card against the CPU: every product is its own op and every
    int8 term is exact, so the two devices agree bit for bit."""
    from repro_torch.core import consensus
    rng = np.random.default_rng(n)
    v = (rng.standard_normal((n, 6, 128)) * 3).astype(np.float32)
    res = (rng.standard_normal((n, 6, 128)) * 1e-2).astype(np.float32)
    active = (rng.uniform(size=n) < 0.6).astype(np.float32)
    active[0] = 1.0
    outs = {}
    for dev in (cuda, "cpu"):
        z, r = consensus.run_consensus_fold_int8(_t(v, dev), _t(res, dev),
                                                 topology, 3)
        m = consensus.run_consensus_fold_masked(_t(v, dev), topology, 3,
                                                _t(active, dev))
        ones = consensus.run_consensus_fold_masked(
            _t(v, dev), topology, 3, torch.ones(n, device=dev))
        plain = consensus.run_consensus_fold(_t(v, dev), topology, 3)
        assert torch.equal(ones, plain)
        outs[str(dev)] = [x.cpu().numpy() for x in (z, r, m)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_decentralized_linreg_step_on_cuda_matches_cpu(cuda, compression):
    """One decentralized step of linreg (8 workers, ring, eq. 24's
    rounds) on integer-valued data, whose gradient sums are exact in
    any order: z, the residual and the weights on the card equal the
    CPU's bit for bit, and the step reads nothing back to the host."""
    from repro_torch import api
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (ConsensusConfig, RunConfig,
                                          TRAIN_4K)
    from repro_torch.models.api import build_model
    cfg = get_smoke_config("amb-linreg")
    rc = RunConfig(model=cfg, shape=TRAIN_4K, strategy="decentralized",
                   consensus=ConsensusConfig(topology="ring", n_workers=8,
                                             gossip_impl="dense",
                                             compression=compression))
    rng = np.random.default_rng(0)
    batch = {"x": rng.integers(-2, 3, (64, cfg.linreg_dim)).astype(
                 np.float32),
             "y": rng.integers(-9, 10, (64,)).astype(np.float32),
             "weights": (rng.uniform(size=64) < 0.8).astype(np.float32)}
    out = {}
    for dev in (cuda, "cpu"):
        s = api.build(build_model(cfg, device=dev), rc, device=dev)
        state = s.init_state()
        b = {k: _t(v, dev) for k, v in batch.items()}
        if dev == cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = s.train_step(state, b)
        finally:
            if dev == cuda:
                torch.cuda.set_sync_debug_mode("default")
        out[str(dev)] = (state, m)
    (g, gm), (c, cm) = out["cuda"], out["cpu"]
    assert s.rounds > 10
    for x, y in ((g.z, c.z), (g.residual, c.residual),
                 (g.params["w"], c.params["w"])):
        np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
    assert gm["applied_count"].item() == cm["applied_count"].item()
    np.testing.assert_allclose(gm["loss"].item(), cm["loss"].item(),
                               rtol=1e-6)


# -- train-while-serve --------------------------------------------------------
def _serve_model(arch, device, **kw):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import build_model
    return build_model(dataclasses.replace(get_smoke_config(arch), **kw),
                       device=device)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b"])
def test_engine_on_cuda_matches_cpu(cuda, arch):
    """``generate`` in f32 (TF32 off, f32 KV cache) on the card gives the
    CPU's tokens from the same weights, ragged prompts in 3 slots."""
    from repro_torch.core.arena import tree_map
    from repro_torch.serve import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for device in ("cpu", cuda):
        model = _serve_model(arch, device, compute_dtype="float32")
        engine = Engine(model, 3, 32)
        for name in ("cache", "_cache0"):
            setattr(engine, name, model.init_decode_state(
                3, 32, torch.float32)[0])
        rng = np.random.default_rng(0)
        prompts = [list(rng.integers(1, 256, size=n)) for n in (4, 7, 5)]
        out[str(device)] = (engine.generate(prompts, max_new=8),
                            tree_map(lambda a: a.cpu(), engine.cache))
    (tok_cpu, cache_cpu), (tok_gpu, cache_gpu) = out["cpu"], out["cuda"]
    assert tok_gpu == tok_cpu
    from repro_torch.core.arena import tree_flatten
    for a, b in zip(tree_flatten(cache_gpu)[0], tree_flatten(cache_cpu)[0]):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-4 * scale


def serve_golden_trace(device):
    """``tests/test_serve.py::_golden_trace`` through the port on
    ``device``: publish every 3 master steps, refresh every 5, Poisson
    arrivals, 40 steps. Returns (rows, engine, serve config)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.arena import make_layout
    from repro_torch.serve import Engine, RequestQueue, WeightPublisher
    model = _serve_model("qwen1.5-0.5b", device)
    sc = ServeConfig(slots=3, max_len=32, max_new=4, arrival="poisson",
                     arrival_rate=0.7, publish_period=3, staleness_bound=6,
                     prompt_len_min=2, prompt_len_max=6, seed=5)
    engine = Engine(model, sc.slots, sc.max_len)
    queue = RequestQueue(sc, model.cfg.vocab_size)
    pub = WeightPublisher(make_layout(engine.params), sc, device=device)
    engine.attach_publisher(pub)
    rows = []
    for t in range(40):
        slot = pub.publish(engine.params, t) \
            if t % sc.publish_period == 0 else -1
        stale = engine.refresh_weights(t) if t % 5 == 0 else None
        arrived = queue.step()
        ev = engine.step(queue)
        rows.append({"step": t, "arrived": arrived, "admits": ev["admits"],
                     "evicts": ev["evicts"], "active": ev["active"],
                     "queued": ev["queued"], "publish_slot": slot,
                     "staleness": stale})
    return rows, engine, sc


def assert_serve_golden(rows, engine, sc):
    """The rows, ``completed`` and ``admitted`` equal
    ``tests/golden/serve_trace.json``; every served staleness is within
    the bound and one is above 0."""
    import json
    import os
    served = [r["staleness"] for r in rows if r["staleness"] is not None]
    assert served and all(0 <= s <= sc.staleness_bound for s in served)
    assert any(s > 0 for s in served)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "serve_trace.json")
    with open(path) as f:
        want = json.load(f)
    assert rows == want["trace"]
    assert (engine.stats.completed, engine.stats.admitted) == \
        (want["completed"], want["admitted"])


def test_serve_golden_trace_on_cuda(cuda):
    """The golden serve trace with the engine and the publisher on the
    card: every row exact."""
    assert_serve_golden(*serve_golden_trace(cuda))


def test_publisher_on_cuda_matches_cpu_bitwise(cuda):
    """The ring's int8 bytes, the bf16 scale bits and the popped tree of
    a publisher on the card equal the CPU's on the same params."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.arena import make_layout, tree_flatten, tree_map
    from repro_torch.serve import WeightPublisher
    params = _serve_model("zamba2-2.7b", "cpu").init()
    sc = ServeConfig(publish_period=1, staleness_bound=1)
    pubs = {}
    for device in ("cpu", cuda):
        pub = WeightPublisher(make_layout(params), sc, device=device)
        p = tree_map(lambda a: a.to(device), params)
        pub.publish(p, 0)
        pub.publish(tree_map(lambda a: 3 * a, p), 1)
        pubs[str(device)] = pub
    a, b = pubs["cuda"], pubs["cpu"]
    assert torch.equal(a.ring.cpu(), b.ring)
    assert torch.equal(a.scales.cpu().view(torch.int16),
                       b.scales.view(torch.int16))
    (ta, sa), (tb, sb) = a.pop(1), b.pop(1)
    assert sa == sb == 0
    for x, y in zip(tree_flatten(ta)[0], tree_flatten(tb)[0]):
        assert torch.equal(x.cpu(), y)


# -- the MoE slice: mixtral's MoE dispatch and the windowed flash route -------
def _moe_model(moe_impl, attn_impl="flash"):
    """mixtral-8x7b SMOKE widened to head dim 64 (the flash kernels'),
    window 32, f32 compute."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("mixtral-8x7b"), d_model=128,
                               n_heads=4, n_kv_heads=2, head_dim=64,
                               compute_dtype="float32", attn_impl=attn_impl,
                               moe_impl=moe_impl)


def _grads(cfg, params, batch, device):
    from repro_torch.core.anytime import accumulate_scan
    from repro_torch.core.arena import tree_flatten, tree_map
    from repro_torch.models.api import build_model
    g, _, m = accumulate_scan(
        build_model(cfg, device=device).loss,
        tree_map(lambda a: a.to(device), params),
        {k: v.to(device) for k, v in batch.items()}, 1)
    return [x.cpu() for x in tree_flatten(g)[0]], float(m["loss_sum"])


@pytest.mark.parametrize("moe_impl", ["einsum", "gather"])
def test_moe_model_on_cuda_matches_cpu(cuda, moe_impl):
    """The MoE model with the windowed flash route (S = 128, window 32),
    f32, TF32 off: the worker's gradient and loss on the card (the flash
    kernels, the MoE dispatch in PyTorch's CUDA kernels) against the CPU
    (the plain versions), each leaf within 1e-4 of its largest element,
    the loss to 1e-5; the training flash kernels launch once per layer
    (dq); the gather route repeats bit for bit on the card."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_model(moe_impl)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = build_model(cfg, device="cpu").dummy_batch(
        2, 128, torch.Generator().manual_seed(1))
    n0 = kernel.DQ.launches
    got, loss = _grads(cfg, params, batch, cuda)
    assert kernel.DQ.launches - n0 == cfg.n_layers
    again, _ = _grads(cfg, params, batch, cuda)
    if moe_impl == "gather":
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    want, want_loss = _grads(cfg, params, batch, "cpu")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_windowed_flash_matches_plain_attention_on_cuda(cuda):
    """On the card, the model's flash route with a window of 32 (the
    kernels) against its plain route (``gqa_attend`` under the windowed
    mask), f32, TF32 off: the gradient within 1e-4 of each leaf's largest
    element, the loss to 1e-5."""
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    flash, plain = _moe_model("einsum"), _moe_model("einsum", "xla")
    params = build_model(flash, device="cpu").init(
        torch.Generator().manual_seed(2))
    batch = build_model(flash, device="cpu").dummy_batch(
        2, 128, torch.Generator().manual_seed(3))
    got, loss = _grads(flash, params, batch, cuda)
    want, want_loss = _grads(plain, params, batch, cuda)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# -- the xLSTM slice ----------------------------------------------------------
def _xlstm_params(cfg):
    """The SMOKE model's init with the sLSTM's ``w_h`` rescaled from
    fan-in n_heads to fan-in head_dim (at the init's fan-in the f32
    gradient of the recurrence is chaotic, ROADMAP C.16)."""
    from repro_torch.models.api import build_model
    from repro_torch.models.xlstm import slstm_dims
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    nh, hd, _ = slstm_dims(cfg)
    params["slstm_layers"]["slstm"]["w_h"].mul_((nh / hd) ** 0.5)
    return params


def test_xlstm_on_cuda_matches_cpu(cuda):
    """xlstm-125m SMOKE, f32, TF32 off, S = 128 over chunks of 64
    (conv_width 1: the mLSTM carry runs): the worker's gradient on the
    card against the CPU, each leaf within 1e-4 of its largest element,
    the loss to 1e-5; one AMB-DG step (tau 0) launches the dual update
    once and agrees; 8 decode steps' logits and states within 1e-4 of
    the largest."""
    import dataclasses
    from repro_torch import api
    from repro_torch.configs import base, get_smoke_config
    from repro_torch.core.arena import tree_flatten, tree_map
    from repro_torch.kernels.dual_update import kernel
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = get_smoke_config("xlstm-125m")
    cfg = dataclasses.replace(smoke, compute_dtype="float32",
                              xlstm=dataclasses.replace(smoke.xlstm,
                                                        conv_width=1))
    params = _xlstm_params(cfg)
    batch = build_model(cfg, device="cpu").dummy_batch(
        2, 128, torch.Generator().manual_seed(1))
    got, loss = _grads(cfg, params, batch, cuda)
    want, want_loss = _grads(cfg, params, batch, "cpu")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    rc = base.RunConfig(model=cfg, shape=dataclasses.replace(
        base.TRAIN_4K, seq_len=128, global_batch=2),
        ambdg=base.AmbdgConfig(tau=0, b_bar=2.0, n_microbatches=1))
    metrics = {}
    for device in ("cpu", cuda):
        s = api.build(build_model(cfg, device=device), rc, device=device)
        state = s.init_state()._replace(params=tree_map(
            lambda a: a.to(device), params))
        n0 = kernel.KERNEL.launches
        state, m = s.train_step(state, {k: v.to(device)
                                        for k, v in batch.items()})
        if device != "cpu":
            assert kernel.KERNEL.launches - n0 == 1
        metrics[str(device)] = float(m["loss"])
    assert metrics["cuda"] == pytest.approx(metrics["cpu"], rel=1e-5)
    caches, logits = {}, {}
    for device in ("cpu", cuda):
        model = build_model(cfg, device=device)
        p = tree_map(lambda a: a.to(device), params)
        cache, _ = model.init_decode_state(3, 8)
        out = []
        for t in range(8):
            tok = torch.full((3, 1), 3 * t + 1, dtype=torch.int64,
                             device=device)
            with torch.no_grad():
                lg, cache = model.decode_step(p, cache, tok, t)
            out.append(lg.cpu())
        caches[str(device)] = [x.cpu() for x in tree_flatten(cache)[0]]
        logits[str(device)] = torch.stack(out)
    for a, b in zip(caches["cuda"] + [logits["cuda"]],
                    caches["cpu"] + [logits["cpu"]]):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-4 * scale


# -- the encoder-decoder slice ------------------------------------------------
def test_encdec_on_cuda_matches_cpu(cuda):
    """seamless-m4t-large-v2 SMOKE widened to the kernels' head dim (d 128,
    2 heads of 64), f32, TF32 off, ``attn_impl="flash"``, a 256-frame
    source and a 128-token target: the worker's gradient on the card (the
    kernels: the encoder's and the cross-attention's non-causal, the
    decoder's causal) against the CPU (their plain version), each leaf
    within 1e-4 of its largest element, the loss to 1e-5, one dq and one
    dk/dv launch per attention and two of the forward with lse (the
    forward and its recomputation under the config's full block remat);
    then three AMB-DG steps (tau 2, int8) through ``train`` on both
    devices, phase 3's checks."""
    import dataclasses
    from repro_torch.configs import base, get_smoke_config
    from repro_torch.core.anytime import accumulate_scan
    from repro_torch.core.arena import tree_flatten, tree_map
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("seamless-m4t-large-v2"),
                              d_model=128, n_heads=2, n_kv_heads=2,
                              head_dim=64, compute_dtype="float32",
                              attn_impl="flash")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, size=(2, 128)).astype(np.int32)),
             "frames": torch.from_numpy(rng.standard_normal(
                 (2, 256, cfg.d_model)).astype(np.float32)),
             "weights": torch.ones(2)}

    def grads(device):
        model = build_model(cfg, device=device)
        g, count, m = accumulate_scan(
            model.loss, tree_map(lambda a: a.to(device), params),
            {k: v.to(device) for k, v in batch.items()}, 1)
        return ([x.cpu() for x in tree_flatten(g)[0]],
                float(m["loss_sum"]) / float(count))

    n0 = [c.launches for c in (kernel.FWD_LSE, kernel.DQ, kernel.DKV)]
    got, loss = grads(cuda)
    per = cfg.n_encoder_layers + 2 * cfg.n_layers
    assert cfg.block_remat == "full"
    assert [c.launches for c in (kernel.FWD_LSE, kernel.DQ, kernel.DKV)] \
        == [n0[0] + 2 * per, n0[1] + per, n0[2] + per]
    want, want_loss = grads("cpu")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    rc = base.RunConfig(model=cfg, shape=dataclasses.replace(
        base.TRAIN_4K, seq_len=128), mesh=base.MeshConfig(1, 1, 1),
        ambdg=base.AmbdgConfig(tau=2, n_microbatches=2, b_bar=8.0,
                               pod_compression="int8"))
    loop = LoopConfig(n_steps=3, n_workers=2, samples_per_worker=2,
                      log_every=1)
    n0 = kernel.DQ.launches
    gpu = train(build_model(cfg, device=cuda), rc, loop, device=cuda)
    assert kernel.DQ.launches - n0 == per * 2 * 3
    cpu = train(build_model(cfg, device="cpu"), rc, loop, device="cpu")
    for a, b in zip(gpu["history"], cpu["history"]):
        assert a["applied_count"] == b["applied_count"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    step = max(float(s.max()) for s in cpu["state"].arena.scales) / \
        cpu["history"][-1]["applied_count"]
    for wg, wc in zip(tree_flatten(gpu["state"].params)[0],
                      tree_flatten(cpu["state"].params)[0]):
        wg, wc = wg.cpu().numpy(), wc.numpy()
        np.testing.assert_allclose(wg, wc, rtol=0,
                                   atol=1e-4 * np.abs(wc).max() + step)


# -- the sharded wrappers at world size 1 on NCCL ---------------------------
@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-rank NCCL world and its ("pod", "data", "model") DeviceMesh:
    every sharded wrapper's collective runs through NCCL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    init = tmp_path_factory.mktemp("nccl") / "init"
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1, 1),
                               mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["dual_update", "slot_rotate",
                                  "variable_pop_f32", "variable_pop_int8"])
def test_sharded_wrappers_on_nccl_match_off_mesh_bitwise(nccl_mesh, kind):
    """Each sharded wrapper at world size 1 (the kernel on the rank's
    whole shard, then its NCCL collective) against the off-mesh route
    on the same inputs, bit for bit, one kernel launch a call."""
    from repro_torch.dist.context import use_device_mesh
    from repro_torch.kernels.delay_ring import kernel as rk
    from repro_torch.kernels.delay_ring.ops import (
        ring_slot_rotate_int8_sharded, ring_variable_pop_sharded)
    from repro_torch.kernels.dual_update import kernel as uk
    from repro_torch.kernels.dual_update.ops import \
        dual_update_arena_sharded
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = 1024

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    with use_device_mesh(nccl_mesh):
        if kind == "dual_update":
            z, g = randn(rows, 128), randn(rows, 128, scale=300)
            c, a = torch.tensor(1500.0, device=dev), \
                torch.tensor(0.0123, device=dev)
            n0 = uk.KERNEL.launches
            got = dual_update_arena_sharded(z.clone(), g, c, a)
            assert uk.KERNEL.launches == n0 + 1
            want = dual_update_arena(z.clone(), g, c, a)
        elif kind == "slot_rotate":
            args = [int8(1, rows, 128), randn(1, rows).abs() * 1e-2,
                    int8(1, rows, 128), randn(1, rows).abs() * 1e-2,
                    randn(1, rows, 128)]
            args.append(args[4].abs().amax(-1) / 127)
            n0 = rk.KERNEL.launches
            got = ring_slot_rotate_int8_sharded(
                *[x.clone() for x in args])
            assert rk.KERNEL.launches == n0 + 1
            popped, *rest = ring_slot_rotate_int8(*[x.clone() for x in args])
            want = (popped[0], *rest)
        else:
            q = kind.endswith("int8")
            ring = int8(6, 1, rows, 128) if q else randn(6, 1, rows, 128)
            scales = randn(6, 1, rows).abs() * 1e-2 if q else None
            mask = torch.tensor([1, 0, 1, 1, 0, 0], dtype=torch.bool,
                                device=dev)
            cs = torch.stack([torch.arange(6.0, device=dev),
                              torch.ones(6, device=dev)])
            n0 = rk.VARIABLE_POP_KERNEL.launches
            got = ring_variable_pop_sharded(ring, mask, scales=scales,
                                            counts_stale=cs)
            assert rk.VARIABLE_POP_KERNEL.launches == n0 + 1
            part, meta = ring_variable_pop(ring, mask, scales=scales,
                                           counts_stale=cs)
            want = (part[0], meta)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- the sharded wrappers on rows over data x model (1x2x2) ------------------
_MESH_ROWS = 1024


def _mesh_wrapper_inputs():
    """Every wrapper's whole inputs (one pod), from a seed, on the CPU."""
    gen = torch.Generator().manual_seed(27)
    rows = _MESH_ROWS

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8)

    fed = torch.randn((1, rows, 128), generator=gen)
    return {
        "z": torch.randn((rows, 128), generator=gen),
        "g": torch.randn((rows, 128), generator=gen) * 300,
        "count": torch.tensor(1500.0), "alpha": torch.tensor(0.0123),
        "slot_pop": int8(1, rows, 128), "slot_push": int8(1, rows, 128),
        "scales_pop": torch.rand((1, rows), generator=gen) * 1e-2 + 1e-3,
        "scales_push": torch.rand((1, rows), generator=gen) * 1e-2 + 1e-3,
        "fed": fed, "scale_new": fed.abs().amax(-1) / 127,
        "ring_f32": torch.randn((6, 1, rows, 128), generator=gen),
        "ring_int8": int8(6, 1, rows, 128),
        "ring_scales": torch.rand((6, 1, rows), generator=gen) * 1e-2,
        "mask": torch.tensor([1, 0, 1, 1, 0, 0], dtype=torch.bool),
        "counts_stale": torch.stack([torch.arange(6.0), torch.ones(6)]),
    }


def _mesh_wrapper_rank(rank, init, out_dir):
    """One of four gloo ranks sharing the card on 1x2x2: each wrapper on
    the rank's rows (its kernel on the card); saves the outputs, the
    coordinates and the launches."""
    import pickle

    import torch.distributed as dist

    from repro_torch.configs.base import MeshConfig
    from repro_torch.dist.sharding import (arena_ring_specs,
                                           arena_slot_specs, local_shard)
    from repro_torch.kernels.delay_ring import kernel as rk
    from repro_torch.kernels.delay_ring.ops import (
        ring_slot_rotate_int8_sharded, ring_variable_pop_sharded)
    from repro_torch.kernels.dual_update import kernel as uk
    from repro_torch.kernels.dual_update.ops import \
        dual_update_arena_sharded
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=4)
    try:
        cfg = MeshConfig(1, 2, 2)
        mesh = make_mesh(cfg, "cuda")
        x = _mesh_wrapper_inputs()
        slot, scales, row = arena_slot_specs(cfg, _MESH_ROWS)
        ring, rscales, _ = arena_ring_specs(cfg, _MESH_ROWS)

        def cut(name, spec):
            return local_shard(x[name], spec, cfg, mesh.coords).to("cuda")

        def whole(name):
            return x[name].to("cuda")
        out = {"coords": mesh.coords}
        n0 = (uk.KERNEL.launches, rk.KERNEL.launches,
              rk.VARIABLE_POP_KERNEL.launches)
        with mesh:
            out["dual_update"] = dual_update_arena_sharded(
                cut("z", row), cut("g", row), whole("count"),
                whole("alpha"))
            out["slot_rotate"] = ring_slot_rotate_int8_sharded(
                cut("slot_pop", slot), cut("scales_pop", scales),
                cut("slot_push", slot), cut("scales_push", scales),
                cut("fed", slot), cut("scale_new", scales))
            for kind in ("f32", "int8"):
                out[f"variable_pop_{kind}"] = ring_variable_pop_sharded(
                    cut(f"ring_{kind}", ring), whole("mask"),
                    scales=(cut("ring_scales", rscales) if kind == "int8"
                            else None), counts_stale=whole("counts_stale"))
        out["launches"] = (uk.KERNEL.launches - n0[0],
                           rk.KERNEL.launches - n0[1],
                           rk.VARIABLE_POP_KERNEL.launches - n0[2])
        out = {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
                   and torch.is_tensor(v[0]) else v) for k, v in out.items()}
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_wrapper_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import pickle

    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh1x2x2")
    mp.spawn(_mesh_wrapper_rank, args=(str(tmp / "init"), str(tmp)),
             nprocs=4)
    runs = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.mark.parametrize("kind", ["dual_update", "slot_rotate",
                                  "variable_pop_f32", "variable_pop_int8"])
def test_sharded_wrappers_on_data_x_model_rows_on_cuda(mesh_wrapper_ranks,
                                                       kind):
    """The three sharded wrappers on 1x2x2 (four gloo ranks sharing the
    card, the rows of one pod over data x model): each rank's outputs
    are its block of the off-mesh route's on the card, bit for bit, and
    each wrapper launched its kernel once a rank."""
    from repro_torch.configs.base import MeshConfig
    from repro_torch.dist.sharding import arena_slot_specs, local_shard
    cfg = MeshConfig(1, 2, 2)
    x = {k: v.to("cuda") for k, v in _mesh_wrapper_inputs().items()}
    slot, scales, row = arena_slot_specs(cfg, _MESH_ROWS)
    if kind == "dual_update":
        want = dual_update_arena(x["z"].clone(), x["g"], x["count"],
                                 x["alpha"])
        specs = (row, row)
    elif kind == "slot_rotate":
        popped, *rest = ring_slot_rotate_int8(
            x["slot_pop"], x["scales_pop"], x["slot_push"].clone(),
            x["scales_push"].clone(), x["fed"].clone(), x["scale_new"])
        want = (popped[0], *rest)
        specs = (row, slot, scales, slot)
    else:
        q = kind.endswith("int8")
        part, meta = ring_variable_pop(
            x["ring_int8"] if q else x["ring_f32"], x["mask"],
            scales=x["ring_scales"] if q else None,
            counts_stale=x["counts_stale"])
        want = (part[0], meta)
        specs = (row, ())
    coords = set()
    for out in mesh_wrapper_ranks:
        assert out["launches"] == (1, 1, 2)
        for got, full, spec in zip(out[kind], want, specs):
            block = local_shard(full.cpu(), spec, cfg, out["coords"])
            assert torch.equal(got, block)
        coords.add((out["coords"]["data"], out["coords"]["model"]))
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
