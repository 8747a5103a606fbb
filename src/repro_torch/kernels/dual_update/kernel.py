"""Binding of the dual-averaging CUDA kernels (``csrc/dual_update.cu``):
the fused arena update, the port of the Pallas ``dual_update_fused_fwd``
(``repro/kernels/dual_update/kernel.py:38``), and the unnormalized one,
the port of ``dual_update_fwd`` (``:73``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_tensor

LANES = 128

# count the launches of each kernel (read by chip_smoke.py)
KERNEL = CudaKernel("dual_update", "dual_update_fused",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int64])
UPDATE = CudaKernel("dual_update", "dual_update",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int64])


def _check_arena(name, z, g, scal_shape, scal):
    if z.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {z.device}")
    if z.dim() != 2 or z.shape[1] != LANES:
        raise ValueError(f"z: expected (rows, {LANES}), got {tuple(z.shape)}")
    shape, dev = tuple(z.shape), z.device
    check_tensor("z", z, shape, torch.float32, dev, 16)
    check_tensor("g", g, shape, torch.float32, dev, 16)
    check_tensor("scal", scal, scal_shape, torch.float32, dev, 4)
    if g.data_ptr() == z.data_ptr():
        raise ValueError("g must not alias z")


def dual_update_fused_fwd(z, g_sum, scal):
    """z, g_sum: (rows, 128) f32 CUDA tensors; scal: (2,) f32 on the same
    device, {alpha, denom}. Updates z in place (z += g_sum / denom) and
    returns (z, w) with w = -alpha * z a new tensor."""
    _check_arena("dual_update_fused_fwd", z, g_sum, (2,), scal)
    w = torch.empty_like(z)
    KERNEL.launch(z.device, z.data_ptr(), g_sum.data_ptr(), w.data_ptr(),
                  scal.data_ptr(), z.shape[0])
    return z, w


def dual_update_fwd(z, g, alpha):
    """z, g: (rows, 128) f32 CUDA tensors; alpha: () f32 on the same
    device. Updates z in place (z += g) and returns (z, w) with
    w = -alpha * z a new tensor."""
    _check_arena("dual_update_fwd", z, g, (), alpha)
    w = torch.empty_like(z)
    UPDATE.launch(z.device, z.data_ptr(), g.data_ptr(), w.data_ptr(),
                  alpha.data_ptr(), z.shape[0])
    return z, w
