"""``repro_torch.api``: the front end of the port.

    import repro_torch.api as api
    from repro_torch.models.api import build_model

    model    = build_model(cfg, device="cuda")
    strategy = api.build(model, rc, device="cuda")   # rc.strategy picks it
    state    = strategy.init_state()
    state, metrics = strategy.train_step(state, batch)

Registered strategies: "ambdg" (the paper) and "amb" (the synchronous
baseline). ``device`` defaults to "cuda" and raises when CUDA is absent;
only a caller that asks for the CPU runs there.
"""
from __future__ import annotations

from repro_torch.configs.base import RunConfig
from repro_torch.core.strategy import (  # noqa: F401  (re-exports)
    Strategy, get_strategy, register)
from repro_torch.device import resolve_device
from repro_torch.models.api import Model


def build(model: Model, rc: RunConfig, device="cuda") -> Strategy:
    """Construct the strategy named by ``rc.strategy`` on ``device``
    (the device ``model`` was built for)."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, the strategy "
                         f"was asked for {device}")
    return get_strategy(rc.strategy)(model, rc)


__all__ = ["Strategy", "build", "get_strategy", "register"]
