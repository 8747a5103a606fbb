"""Device resolution shared by the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is
absent: a run asked of the card never carries on on the CPU. Only a
caller that asks for the CPU (the tests) gets it.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
