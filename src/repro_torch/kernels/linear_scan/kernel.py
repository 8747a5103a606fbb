"""Binding of the linear-scan CUDA kernel (``csrc/linear_scan.cu``), the
port of the Pallas ``linear_scan_fwd``
(``repro/kernels/linear_scan/kernel.py:68``).

The wrapper checks device, dtypes (g f32; q and k f32 or bf16; v f32,
or bf16 with bf16 q and k), shapes (ds and hd in 16, 32, 64, 128; BH a
multiple of BHG; ``chunk`` dividing S) and contiguity, copies an input
whose data is not 16-byte aligned (the kernels' ``cp.async`` loads need
it), allocates y and the scratch of the chunk-parallel form (the chunk
states, (BH, nc - 1, ds, hd) f32, and their decays), launches on
PyTorch's current stream and raises on a non-zero ``cudaError_t``. One C
entry serves the forward and the three backward forms of
``ops.LinearScanTrain``; they count their launches apart. A launch is
one call: ``kernels_per_call`` device kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_tensor

DIMS = (16, 32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 8 + [_I] * 9

# launch counters (read by chip_smoke.py): the forward, and the
# backward's three calls (dv, dk and dq forms)
FWD = CudaKernel("linear_scan", "linear_scan", _ARGS)
BWD = CudaKernel("linear_scan", "linear_scan", _ARGS)


def kernels_per_call(S: int, chunk: int) -> int:
    """Device kernels one call launches: the chunk states, the state pass
    and the outputs; the outputs alone when the chunk is the whole
    sequence."""
    return 3 if S // chunk > 1 else 1


def _aligned(t):
    return t if t.data_ptr() % 16 == 0 else t.clone()


def linear_scan_fwd(g, q, k, v, *, chunk: int = 128, strict: bool = False,
                    with_inter: bool = False, counter: CudaKernel = FWD):
    """g (BH, S) f32; q, k (BHG, S, ds); v (BH, S, hd) -> y (BH, S, hd)
    in v's dtype. ``strict`` leaves each step's own term out of its
    output (the backward's dq and dk forms). ``with_inter``: return
    (y, y_inter), y_inter (BH, S, hd) f32 the part of y that comes from
    the steps before each step's chunk. ``counter``: FWD, or BWD for the
    backward's calls."""
    if g.device.type != "cuda":
        raise ValueError(f"linear_scan_fwd runs on CUDA tensors, got "
                         f"{g.device}")
    if g.dim() != 2 or q.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected g (BH, S), q/k (BHG, S, ds), v (BH, S, "
                         f"hd); got {tuple(g.shape)}, {tuple(q.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S = g.shape
    BHG, ds, hd = q.shape[0], q.shape[2], v.shape[2]
    if ds not in DIMS or hd not in DIMS:
        raise ValueError(f"ds={ds}, hd={hd}: the kernel takes {DIMS}")
    if BHG == 0 or BH % BHG:
        raise ValueError(f"{BH} heads do not group over {BHG}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    if q.dtype not in (torch.float32, torch.bfloat16) or v.dtype not in (
            torch.float32, torch.bfloat16) or (
            v.dtype == torch.bfloat16 and q.dtype != torch.bfloat16):
        raise ValueError(f"dtypes q/k {q.dtype}, v {v.dtype}: the kernel "
                         "takes f32 or bf16 q/k with an f32 v, or all bf16")
    dev = g.device
    check_tensor("g", g, (BH, S), torch.float32, dev, 4)
    q, k, v = (_aligned(t) for t in (q, k, v))
    check_tensor("q", q, (BHG, S, ds), q.dtype, dev, 16)
    check_tensor("k", k, (BHG, S, ds), q.dtype, dev, 16)
    check_tensor("v", v, (BH, S, hd), v.dtype, dev, 16)
    y = torch.empty_like(v)
    y_inter = (torch.empty((BH, S, hd), dtype=torch.float32, device=dev)
               if with_inter else None)
    n_states = S // chunk - 1
    states = torch.empty((BH, n_states, ds, hd), dtype=torch.float32,
                         device=dev) if n_states else None
    decay = torch.empty((BH, n_states), dtype=torch.float32,
                        device=dev) if n_states else None
    ptr = lambda t: None if t is None else t.data_ptr()
    counter.launch(dev, g.data_ptr(), q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), y.data_ptr(), ptr(y_inter), ptr(states),
                   ptr(decay), BH, BHG, S, ds, hd, chunk,
                   int(q.dtype == torch.bfloat16),
                   int(v.dtype == torch.bfloat16), int(strict))
    return (y, y_inter) if with_inter else y
