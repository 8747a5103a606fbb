"""Binding of the flash-attention CUDA kernels
(``csrc/flash_attention.cu``), the port of the Pallas
``flash_attention_fwd`` (``repro/kernels/flash_attention/kernel.py:79``),
``flash_fwd_lse`` (``bwd.py:82``) and ``flash_attention_bwd``
(``bwd.py:199``: ``_dq_kernel`` and ``_dkv_kernel`` with the GQA group
sum).

The wrappers check device, dtype (f32 or bf16, the same for every
input), shapes (head dim 64, 80, 128 or 256, Hq a multiple of Hkv), contiguity
and 16-byte alignment (TMA reads the bf16 tiles, and lse and delta in
dk/dv), allocate the outputs, launch on PyTorch's current stream and
raise on a non-zero ``cudaError_t``. Each entry takes both types: bf16
runs the Hopper kernels (wgmma on TMA-loaded tiles), f32 the exact
CUDA-core kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_tensor

HEAD_DIMS = (64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_SHAPE_ARGS = [_I] * 9 + [_F]   # B Hq Hkv Sq Skv D dtype causal window, scale

# launch counters (read by chip_smoke.py). FWD and FWD_LSE are the one
# templated kernel ``flash_fwd`` without and with lse (B.6 and B.7a)
FWD = CudaKernel("flash_attention", "flash_fwd", [_P] * 4 + _SHAPE_ARGS)
FWD_LSE = CudaKernel("flash_attention", "flash_fwd_lse",
                     [_P] * 5 + _SHAPE_ARGS)
DQ = CudaKernel("flash_attention", "flash_bwd_dq", [_P] * 7 + _SHAPE_ARGS)
DKV = CudaKernel("flash_attention", "flash_bwd_dkv", [_P] * 9 + _SHAPE_ARGS)


def _check(q, k, v):
    """Raise unless q, k, v are what the kernels take; returns the shape
    arguments (B, Hq, Hkv, Sq, Skv, D, dtype code)."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention kernels run on CUDA tensors, "
                         f"got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v: expected (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype}: the kernels take float32 or "
                         "bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernels take {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} q heads do not group over {Hkv} kv heads")
    check_tensor("q", q, (B, Hq, Sq, D), q.dtype, q.device, 16)
    check_tensor("k", k, (B, Hkv, Skv, D), q.dtype, q.device, 16)
    check_tensor("v", v, (B, Hkv, Skv, D), q.dtype, q.device, 16)
    return B, Hq, Hkv, Sq, Skv, D, _DTYPES[q.dtype]


def _window(window):
    if window is not None and window <= 0:
        raise ValueError(f"window {window}: expected a positive int or None")
    return 0 if window is None else int(window)


def flash_attention_fwd(q, k, v, *, causal: bool, window, scale: float):
    """o (B, Hq, Sq, D) in q.dtype (B.6: the forward without lse)."""
    shape = _check(q, k, v)
    o = torch.empty_like(q)
    FWD.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               o.data_ptr(), *shape, int(causal), _window(window),
               float(scale))
    return o


def flash_fwd_lse(q, k, v, *, causal: bool, window, scale: float):
    """(o in q.dtype, lse (B, Hq, Sq) f32) (B.7a: the training forward)."""
    shape = _check(q, k, v)
    B, Hq, _, Sq = shape[:4]
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    FWD_LSE.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   o.data_ptr(), lse.data_ptr(), *shape, int(causal),
                   _window(window), float(scale))
    return o, lse


def _check_bwd(q, k, v, lse, delta, do):
    shape = _check(q, k, v)
    B, Hq, _, Sq = shape[:4]
    check_tensor("do", do, tuple(q.shape), q.dtype, q.device, 16)
    check_tensor("lse", lse, (B, Hq, Sq), torch.float32, q.device, 16)
    check_tensor("delta", delta, (B, Hq, Sq), torch.float32, q.device, 16)
    return shape


def flash_bwd_dq(q, k, v, lse, delta, do, *, causal: bool, window,
                 scale: float):
    """dq (B, Hq, Sq, D) in q.dtype (B.7b's ``_dq_kernel``)."""
    shape = _check_bwd(q, k, v, lse, delta, do)
    dq = torch.empty_like(q)
    DQ.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
              do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
              *shape, int(causal), _window(window), float(scale))
    return dq


def flash_bwd_dkv(q, k, v, lse, delta, do, *, causal: bool, window,
                  scale: float):
    """(dk, dv) (B, Hkv, Skv, D) in k's dtype (B.7b's ``_dkv_kernel``
    with the GQA group sum, taken in f32 inside the kernel; the bf16
    kernel sums the group's heads in an f32 scratch it is given)."""
    shape = _check_bwd(q, k, v, lse, delta, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scratch = None
    if q.dtype == torch.bfloat16 and q.shape[1] > k.shape[1]:
        scratch = torch.empty((2, *k.shape), dtype=torch.float32,
                              device=q.device)
    DKV.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dk.data_ptr(), dv.data_ptr(),
               0 if scratch is None else scratch.data_ptr(), *shape,
               int(causal), _window(window), float(scale))
    return dk, dv


def flash_attention_bwd(q, k, v, lse, delta, do, *, causal: bool, window,
                        scale: float):
    """(dq, dk, dv) in the inputs' dtype (B.7b): the dq kernel, then the
    dk/dv kernel."""
    kw = dict(causal=causal, window=window, scale=scale)
    dq = flash_bwd_dq(q, k, v, lse, delta, do, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, lse, delta, do, **kw))
