"""Parameter trees of the port's models (``repro/models/common.py``).

Models are functions over nested dicts of tensors. Every leaf is made
through a ``ParamFactory`` with the JAX package's init distributions
(``normal`` scaled by 1/sqrt(fan_in), ``zeros``, ``ones``), and the
factory records each leaf's logical sharding axes beside it, as JAX's
does (``factory.axes``, read by ``repro_torch.dist``: "embed" d_model-like
dims, "mlp" ffn hidden dims, "heads" flattened head dims, "vocab",
"expert", "layers" the stacked dim, None replicated). Stacked layers
lie along a leading ``n_layers`` dimension, as JAX's
``vmapped_children`` lays them out, so the arena's sorted-key flatten
gives the JAX arena row for row.

Draws come from a CPU ``torch.Generator`` and are then moved to the
device, so a run on the card and one on the CPU from the same seed start
from the same weights. On the ``meta`` device nothing is drawn: the
tree carries shapes and dtypes only (the arena layout is built from it,
as JAX builds it from ``eval_shape``). A ``cut`` hook (tensor
parallelism, ``dist.tensor_parallel.param_cutter``) takes each leaf
after its whole draw and before it moves to the device, so the same
seed gives the same whole tree at every mesh shape and a rank's device
receives only its block.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, object]


class ParamFactory:
    """Creates parameters in a fixed order from one generator and
    records their logical axes in lockstep. ``lead`` is the shape of the
    stacking dims every leaf gets in front (each a "layers" axis);
    ``cut(name, whole leaf, its axes)`` returns the leaf to keep."""

    def __init__(self, generator: Optional[torch.Generator], dtype,
                 device, lead: Tuple[int, ...] = (),
                 cut: Optional[Callable] = None):
        device = torch.device(device)
        if device.type != "meta" and (generator is None or
                                      generator.device.type != "cpu"):
            raise ValueError("ParamFactory draws from a CPU torch.Generator "
                             "(the weights are the same on every device)")
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.lead = tuple(lead)
        self.cut = cut
        self.params: Params = {}
        self.axes: Dict[str, object] = {}

    def param(self, name: str, shape: Tuple[int, ...],
              axes: Tuple[Optional[str], ...], init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        if len(shape) != len(axes):
            raise ValueError(f"{name}: axes {axes} do not match shape "
                             f"{shape}")
        full = self.lead + tuple(shape)
        axes = ("layers",) * len(self.lead) + tuple(axes)
        if self.device.type == "meta":
            value = torch.empty(full, dtype=self.dtype, device="meta")
        elif init == "zeros":
            value = torch.zeros(full)
        elif init == "ones":
            value = torch.ones(full)
        elif init == "normal":
            if scale is None:
                # fan_in of the per-layer shape, never of the stacked one
                fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            value = scale * torch.randn(full, generator=self.generator,
                                        dtype=torch.float32)
        else:
            raise ValueError(f"unknown init {init!r}")
        if self.cut is not None:
            value = self.cut(name, value, axes)
        value = value.to(dtype=self.dtype, device=self.device)
        self.params[name] = value
        self.axes[name] = axes
        return value

    def child(self, name: str) -> "ParamFactory":
        sub = ParamFactory(self.generator, self.dtype, self.device, self.lead,
                           self.cut)
        self.params[name] = sub.params
        self.axes[name] = sub.axes
        return sub

    def stacked_children(self, name: str, n: int,
                         build: Callable[["ParamFactory"], None]) -> None:
        """``n`` identically-structured children stacked along a leading
        "layers" dim (JAX's ``vmapped_children``)."""
        sub = ParamFactory(self.generator, self.dtype, self.device,
                           self.lead + (n,), self.cut)
        build(sub)
        self.params[name] = sub.params
        self.axes[name] = sub.axes
