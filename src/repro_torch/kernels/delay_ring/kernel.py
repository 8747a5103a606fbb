"""Binding of the int8 slot-rotate CUDA kernel (``csrc/delay_ring.cu``),
the port of the Pallas ``delay_ring_slot_fwd``
(``repro/kernels/delay_ring/kernel.py:77``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_tensor

LANES = 128

# counts the launches of this kernel (read by chip_smoke.py)
KERNEL = CudaKernel("delay_ring", "slot_rotate_int8",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int64])


def delay_ring_slot_fwd(slot_pop, scales_pop, slot_push, scales_push, fed,
                        scale_new):
    """Ring layout v2 int8 rotate on CUDA tensors, in one pass:
    dequantize ``slot_pop`` into a new ``popped``; quantize ``fed``
    into ``slot_push`` and copy ``scale_new`` into ``scales_push`` (both
    in place); write the error-feedback residual over ``fed`` (in
    place). slot_*: (P, rows, 128) int8; fed: (P, rows, 128) f32;
    scales_*, scale_new: (P, rows) f32.
    Returns (popped, slot_push, scales_push, fed)."""
    if fed.device.type != "cuda":
        raise ValueError(f"delay_ring_slot_fwd runs on CUDA tensors, got "
                         f"{fed.device}")
    if fed.dim() != 3 or fed.shape[2] != LANES:
        raise ValueError(f"fed: expected (P, rows, {LANES}), got "
                         f"{tuple(fed.shape)}")
    shape, dev = tuple(fed.shape), fed.device
    check_tensor("slot_pop", slot_pop, shape, torch.int8, dev, 4)
    check_tensor("slot_push", slot_push, shape, torch.int8, dev, 4)
    check_tensor("fed", fed, shape, torch.float32, dev, 16)
    for name, t in (("scales_pop", scales_pop), ("scales_push", scales_push),
                    ("scale_new", scale_new)):
        check_tensor(name, t, shape[:2], torch.float32, dev, 4)
    if slot_pop.data_ptr() == slot_push.data_ptr():
        raise ValueError("the pop and push slots must be different buffers "
                         "(ring layout v2)")
    popped = torch.empty_like(fed)
    KERNEL.launch(dev, slot_pop.data_ptr(), scales_pop.data_ptr(),
                  slot_push.data_ptr(), scales_push.data_ptr(),
                  fed.data_ptr(), scale_new.data_ptr(), popped.data_ptr(),
                  shape[0] * shape[1])
    return popped, slot_push, scales_push, fed
