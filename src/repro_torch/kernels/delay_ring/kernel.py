"""Bindings of the delay-ring CUDA kernels, the ports of the Pallas
kernels in ``repro/kernels/delay_ring/kernel.py``:

  ``delay_ring_slot_fwd``  (``csrc/delay_ring.cu``) the v2 int8 slot
      rotate, port of ``delay_ring_slot_fwd`` (``:77``);
  ``delay_ring_fwd``       (``csrc/delay_ring.cu``) the v1 stacked-ring
      rotate, f32 and int8, port of ``delay_ring_fwd`` (``:231``);
  ``variable_pop_fwd``     (``csrc/variable_pop.cu``) the masked pop of
      the stacked delay-tolerant ring (v3), f32 and int8, with the fused
      (count, stale_sum) epilogue, port of ``variable_pop_fwd`` (``:159``).

Each ``CudaKernel`` counts its own launches (read by ``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_tensor

LANES = 128
MAX_SLOTS = 256     # csrc/variable_pop.cu kMaxSlots

KERNEL = CudaKernel("delay_ring", "slot_rotate_int8",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int64])
RING_KERNEL = CudaKernel("delay_ring", "ring_rotate",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                  ctypes.c_int64])
VARIABLE_POP_KERNEL = CudaKernel("variable_pop", "variable_pop",
                                 [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                          ctypes.c_int64])


def _check_cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {t.device}")


def delay_ring_slot_fwd(slot_pop, scales_pop, slot_push, scales_push, fed,
                        scale_new):
    """Ring layout v2 int8 rotate on CUDA tensors, in one pass:
    dequantize ``slot_pop`` into a new ``popped``; quantize ``fed``
    into ``slot_push`` and copy ``scale_new`` into ``scales_push`` (both
    in place); write the error-feedback residual over ``fed`` (in
    place). slot_*: (P, rows, 128) int8; fed: (P, rows, 128) f32;
    scales_*, scale_new: (P, rows) f32.
    Returns (popped, slot_push, scales_push, fed)."""
    _check_cuda("delay_ring_slot_fwd", fed)
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


def delay_ring_fwd(ring, g, head, scales=None, scale_new=None):
    """Ring layout v1 rotate on CUDA tensors: pop ``ring[head]`` into a
    new ``popped`` and push into the same slot, in place. f32: the slot
    takes ``g``. int8 (``scales`` given): ``g`` is the error-fed
    gradient fed; the slot takes q = clip(round(fed / s), -127, 127),
    ``scales[head]`` takes ``scale_new``, and the residual fed - q * s
    is written over ``g``. ring: (tau, P, rows, 128) f32 or int8; g:
    (P, rows, 128) f32; head: () int32, read on the card; scales:
    (tau, P, rows) f32; scale_new: (P, rows) f32.
    Returns (popped, ring, scales, residual), residual being ``g``
    under int8 and None under f32."""
    _check_cuda("delay_ring_fwd", ring)
    if ring.dim() != 4 or ring.shape[3] != LANES:
        raise ValueError(f"ring: expected (tau, P, rows, {LANES}), got "
                         f"{tuple(ring.shape)}")
    tau, dev = ring.shape[0], ring.device
    shape = tuple(ring.shape[1:])
    check_tensor("g", g, shape, torch.float32, dev, 16)
    check_tensor("head", head, (), torch.int32, dev, 4)
    int8 = scales is not None
    check_tensor("ring", ring, (tau,) + shape,
                 torch.int8 if int8 else torch.float32, dev, 4 if int8 else 16)
    if int8:
        check_tensor("scales", scales, (tau,) + shape[:2], torch.float32,
                     dev, 4)
        check_tensor("scale_new", scale_new, shape[:2], torch.float32, dev,
                     4)
    elif scale_new is not None:
        raise ValueError("scale_new is given without scales")
    popped = torch.empty(shape, dtype=torch.float32, device=dev)
    RING_KERNEL.launch(dev, ring.data_ptr(),
                       scales.data_ptr() if int8 else None, g.data_ptr(),
                       scale_new.data_ptr() if int8 else None,
                       head.data_ptr(), popped.data_ptr(), tau,
                       shape[0] * shape[1])
    return popped, ring, scales, (g if int8 else None)


def variable_pop_fwd(ring, mask, scales=None, counts_stale=None):
    """Masked pop of the stacked delay-tolerant ring on CUDA tensors:
    fold the due slots (``mask``) in ascending order from zero, int8
    dequantized in the same pass. ring: (S, P, rows, 128) f32 or int8;
    mask: (S,) bool; scales: (S, P, rows) f32 under int8; counts_stale:
    (2, S) f32 or None. A pure read. Returns the per-pod partial sums
    (P, rows, 128) f32 (the pod fold is the caller's), and with
    ``counts_stale`` also meta = (count, stale_sum) as a (2,) f32."""
    _check_cuda("variable_pop_fwd", ring)
    if ring.dim() != 4 or ring.shape[3] != LANES:
        raise ValueError(f"ring: expected (S, P, rows, {LANES}), got "
                         f"{tuple(ring.shape)}")
    n_slots, dev = ring.shape[0], ring.device
    if n_slots > MAX_SLOTS:
        raise ValueError(f"{n_slots} ring slots: the kernel takes at most "
                         f"{MAX_SLOTS}")
    shape = tuple(ring.shape[1:])
    int8 = scales is not None
    check_tensor("ring", ring, (n_slots,) + shape,
                 torch.int8 if int8 else torch.float32, dev, 4 if int8 else 16)
    check_tensor("mask", mask, (n_slots,), torch.bool, dev, 1)
    if int8:
        check_tensor("scales", scales, (n_slots,) + shape[:2],
                     torch.float32, dev, 4)
    if counts_stale is not None:
        check_tensor("counts_stale", counts_stale, (2, n_slots),
                     torch.float32, dev, 4)
    popped = torch.empty(shape, dtype=torch.float32, device=dev)
    meta = torch.empty((2,), dtype=torch.float32, device=dev)
    VARIABLE_POP_KERNEL.launch(
        dev, ring.data_ptr(), scales.data_ptr() if int8 else None,
        mask.data_ptr(),
        None if counts_stale is None else counts_stale.data_ptr(),
        popped.data_ptr(), meta.data_ptr(), n_slots, shape[0] * shape[1])
    return popped if counts_stale is None else (popped, meta)
