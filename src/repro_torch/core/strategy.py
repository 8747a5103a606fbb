"""The Strategy protocol of the port (``repro/core/strategy.py``): one
surface for every algorithm variant, registered by name and built
through ``repro_torch.api.build(model, rc, device)`` from
``rc.strategy``:

    strategy = repro_torch.api.build(model, rc, device="cuda")
    state    = strategy.init_state(generator)
    state, metrics = strategy.train_step(state, batch)

The port registers AMB-DG and its synchronous degenerate AMB; K-batch
and the decentralized gossip come in later slices, and the schedule
probes (``staleness_schedule``, ``timeline_model``) with the simulator
(ROADMAP A.6).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Type

from repro_torch.configs.base import RunConfig
from repro_torch.core import ambdg
from repro_torch.models.api import Model


class Strategy:
    """Base class: subclasses assign ``init_state`` / ``train_step`` in
    ``__init__``."""

    name: str = "?"

    def __init__(self, model: Model, rc: RunConfig):
        if rc.elastic.process != "static":
            raise NotImplementedError(
                f"rc.elastic.process={rc.elastic.process!r}: elastic "
                "workers are not ported yet (ROADMAP A.9)")
        self.model = model
        self.rc = rc

    def delay_process(self):
        """The seeded ``core.delay_process`` instance this strategy's
        ``rc.delay`` configures, or None under the fixed process. The
        host loop draws each step's ``batch["delay"]`` from it."""
        if self.rc.delay.process == "fixed":
            return None
        from repro_torch.core.delay_process import make_delay_process
        return make_delay_process(self.rc.delay, self.rc.ambdg.tau)


_REGISTRY: Dict[str, Type[Strategy]] = {}
# registered in the JAX package, ported in a later slice
_LATER = {"kbatch": "ROADMAP A.8", "decentralized": "ROADMAP A.10"}


def register(cls: Type[Strategy]) -> Type[Strategy]:
    """Class decorator: make ``cls`` constructible by name."""
    if cls.name in _REGISTRY:
        raise ValueError(f"strategy {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    return cls


def get_strategy(name: str) -> Type[Strategy]:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _LATER:
        raise NotImplementedError(
            f"strategy {name!r} is not ported yet ({_LATER[name]}); the "
            f"port runs {sorted(_REGISTRY)}")
    raise ValueError(f"unknown strategy {name!r}; registered: "
                     f"{sorted(_REGISTRY)}")


@register
class AmbdgStrategy(Strategy):
    """Anytime minibatch with delayed gradients: anytime accumulation
    -> tau-deep delay ring -> dual averaging, on the arena master. A
    stochastic ``rc.delay`` runs the delay-tolerant ring."""

    name = "ambdg"

    def __init__(self, model: Model, rc: RunConfig):
        super().__init__(model, rc)
        self.init_state, self.train_step = ambdg.build_step_fns(model, rc)


@register
class AmbStrategy(Strategy):
    """Synchronous AMB (Ferdinand et al.): the AMB-DG step with tau = 0
    on the device (its idle round trips cost wall time, not device
    work)."""

    name = "amb"

    def __init__(self, model: Model, rc: RunConfig):
        if rc.delay.process != "fixed":
            raise ValueError(
                f"strategy 'amb' does not support the stochastic delay "
                f"process {rc.delay.process!r}: the synchronous baseline "
                "blocks on every round trip")
        rc = rc.replace(ambdg=dataclasses.replace(rc.ambdg, tau=0))
        super().__init__(model, rc)
        self.init_state, self.train_step = ambdg.build_step_fns(model, rc)
