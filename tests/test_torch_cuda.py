"""The port's CUDA kernels on the card, held bitwise against their plain
PyTorch versions (on the card and on the CPU), and the slice's main
path on the card against the CPU.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode):
they carry the ``cuda`` marker and skip without a card. The module
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.delay_ring.ops import ring_slot_rotate_int8
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
