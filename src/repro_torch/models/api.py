"""Unified model API of the port.

``build_model(cfg, device)`` returns a ``Model`` with the JAX package's
interface (``repro/models/api.py``), so the strategies never special-
case architectures:

    params         = model.init(generator)
    loss_sum, aux  = model.loss(params, batch)       # SUM + counts

``params`` is a dict of tensors on ``model.device``; ``model.loss``
evaluates the ``nn.Module`` at those tensors (``functional_call``), so
autograd differentiates with respect to them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import LINREG, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import linear as linear_mod


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    module: nn.Module
    device: torch.device
    init: Callable[[Optional[torch.Generator]], Dict]

    def loss(self, params: Dict, batch: Dict):
        return torch.func.functional_call(self.module, params, (batch,))


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model for ``cfg`` on ``device`` ("cuda" unless the caller
    asks for the CPU; raises when CUDA is asked for and absent)."""
    device = resolve_device(device)
    if cfg.family == LINREG:
        # w(1) = 0 in the paper: the generator draws nothing
        return Model(cfg, linear_mod.LinearRegression(cfg, device), device,
                     init=lambda generator=None: linear_mod.init(cfg, device))
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP A.8 for "
        "the CNN, A.13 for the LLM zoo)")
