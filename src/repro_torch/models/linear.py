"""The paper's linear-regression problem (Sec. VI-A).

F(w) = E[0.5 (zeta^T w - y)^2], data zeta ~ N(0, I_d), y = zeta^T w* + eps.
Workers stream (zeta, y) pairs; the per-sample gradient is
(zeta^T w - y) zeta, the paper's eq. (27) (the 1/2-scaled convention).
The gradient is autograd over one ``torch.matmul``, as the JAX package
leaves the same product to XLA.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


class LinearRegression(nn.Module):
    """w in R^d. ``forward`` returns the SUM of per-sample squared
    errors, weighted by the anytime mask (AMB-DG normalizes by the
    global count), and the count."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cfg.linreg_dim,
                                          dtype=torch.float32,
                                          device=resolve_device(device)))
        # paper: w(1) = 0

    def forward(self, batch) -> Tuple[torch.Tensor, Dict]:
        """batch: {"x": (B, d), "y": (B,), "weights": (B,)}."""
        x, y = batch["x"], batch["y"]
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones(x.shape[0], dtype=torch.float32,
                                 device=x.device)
        resid = x @ self.w - y
        loss_sum = torch.sum(0.5 * torch.square(resid) * weights)
        count = torch.sum(weights)
        return loss_sum, {"count": count, "loss_sum": loss_sum}


def init(cfg: ModelConfig, device) -> Dict:
    return {"w": torch.zeros(cfg.linreg_dim, dtype=torch.float32,
                             device=device)}   # paper: w(1)=0


AXES = {"w": ("embed",)}     # the logical axes of ``init``'s tree
