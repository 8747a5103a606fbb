"""Binding of the fused dual-averaging CUDA kernel
(``csrc/dual_update.cu``), the port of the Pallas ``dual_update_fused_fwd``
(``repro/kernels/dual_update/kernel.py:38``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_tensor

LANES = 128

# counts the launches of this kernel (read by chip_smoke.py)
KERNEL = CudaKernel("dual_update", "dual_update_fused",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int64])


def dual_update_fused_fwd(z, g_sum, scal):
    """z, g_sum: (rows, 128) f32 CUDA tensors; scal: (2,) f32 on the same
    device, {alpha, denom}. Updates z in place (z += g_sum / denom) and
    returns (z, w) with w = -alpha * z a new tensor."""
    if z.device.type != "cuda":
        raise ValueError(f"dual_update_fused_fwd runs on CUDA tensors, "
                         f"got {z.device}")
    if z.dim() != 2 or z.shape[1] != LANES:
        raise ValueError(f"z: expected (rows, {LANES}), got {tuple(z.shape)}")
    shape, dev = tuple(z.shape), z.device
    check_tensor("z", z, shape, torch.float32, dev, 16)
    check_tensor("g_sum", g_sum, shape, torch.float32, dev, 16)
    check_tensor("scal", scal, (2,), torch.float32, dev, 4)
    if g_sum.data_ptr() == z.data_ptr():
        raise ValueError("g_sum must not alias z")
    w = torch.empty_like(z)
    KERNEL.launch(dev, z.data_ptr(), g_sum.data_ptr(), w.data_ptr(),
                  scal.data_ptr(), shape[0])
    return z, w
