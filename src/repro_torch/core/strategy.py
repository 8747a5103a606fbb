"""The Strategy protocol of the port (``repro/core/strategy.py``): one
surface for every algorithm variant, registered by name and built
through ``repro_torch.api.build(model, rc, device)`` from
``rc.strategy``:

    strategy = repro_torch.api.build(model, rc, device="cuda")
    state    = strategy.init_state(generator)
    state, metrics = strategy.train_step(state, batch)
    strategy.staleness_schedule()   # how stale applied gradients are
    Strategy.timeline_model()       # wall-clock algebra of the simulator

The port registers AMB-DG, its synchronous degenerate AMB and the
K-batch baseline; the decentralized gossip comes later (ROADMAP A.10).
``repro_torch.api.simulate`` runs a strategy's cluster simulator engine
(``Strategy.sim_engine``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Type

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import ambdg
from repro_torch.models.api import Model


class StalenessSchedule(NamedTuple):
    """How stale the gradients applied by each master update are."""
    kind: str          # "delayed" | "sync" | "random"
    tau: int           # deterministic delay in epochs (0 = fresh)
    description: str


class TimelineModel(NamedTuple):
    """Wall-clock algebra of a scheme (paper Sec. III / Fig. 1), used by
    the cluster simulator. The closed forms are the EXACT float
    expressions the golden traces pin: keep them literally as the JAX
    package writes them.

    ``event_driven`` schemes (k-batch) have no closed form: their update
    times come out of the simulator's arrival heap."""
    scheme: str
    event_driven: bool
    # (t_p, t_c) -> wall time of one epoch
    epoch_duration: Optional[Callable[[float, float], float]] = None
    # (t, t_p, t_c) -> wall time of the master's t-th update
    update_time: Optional[Callable[[int, float, float], float]] = None
    # (total_time, t_p, t_c) -> number of updates fitting the budget
    n_updates: Optional[Callable[[float, float, float], int]] = None


class Strategy:
    """Base class: subclasses assign ``init_state`` / ``train_step`` in
    ``__init__`` and implement the two schedule probes."""

    name: str = "?"
    # the simulator engine that runs this scheme: "anytime" (epoch
    # timeline) or "kbatch" (event-driven arrival heap)
    sim_engine: Optional[str] = None
    # does the device step read the elastic active mask as
    # batch["active"]? The master-ful strategies do not (a dead worker's
    # samples carry weight 0 in the anytime weights and eq. (5) stays
    # exact); only the decentralized gossip does (ROADMAP A.10)
    consumes_active_mask: bool = False

    def __init__(self, model: Model, rc: RunConfig):
        from repro_torch.core.batch_schedule import resolve_targets
        from repro_torch.core.worker_process import validate_elastic
        # every strategy reads rc.elastic and rc.batch_schedule: a bad
        # config raises at build time, not at the first draw
        validate_elastic(rc.elastic)
        resolve_targets(rc.batch_schedule, rc.ambdg.b_bar)
        self.model = model
        self.rc = rc

    def staleness_schedule(self) -> StalenessSchedule:
        raise NotImplementedError

    @classmethod
    def timeline_model(cls) -> TimelineModel:
        raise NotImplementedError

    def delay_process(self):
        """The seeded ``core.delay_process`` instance this strategy's
        ``rc.delay`` configures, or None under the fixed process. The
        host loop draws each step's ``batch["delay"]`` from it, and
        ``api.simulate`` feeds it to the simulator engine."""
        if self.rc.delay.process == "fixed":
            return None
        from repro_torch.core.delay_process import make_delay_process
        return make_delay_process(self.rc.delay, self.rc.ambdg.tau)

    def worker_process(self, n_workers: int):
        """The seeded ``core.worker_process`` instance this strategy's
        ``rc.elastic`` configures for ``n_workers`` workers, or None
        under the static process. The host loop folds one draw per step
        into the anytime weights; ``api.simulate`` feeds it to the
        engine (per-epoch draws for the anytime schemes, epoch-indexed
        churn on the K-batch arrival heap)."""
        if self.rc.elastic.process == "static":
            return None
        from repro_torch.core.worker_process import make_worker_process
        return make_worker_process(self.rc.elastic, n_workers)

    def batch_schedule(self):
        """The seeded ``core.batch_schedule`` controller this strategy's
        ``rc.batch_schedule`` configures, or None under the fixed
        schedule. The host loop draws one target per step (shipped as
        ``batch["b_sched"]``); ``api.simulate`` feeds the same sequence
        to the engine (per-epoch targets, per-job sizes for K-batch)."""
        if self.rc.batch_schedule.schedule == "fixed":
            return None
        from repro_torch.core.batch_schedule import make_batch_schedule
        return make_batch_schedule(self.rc.batch_schedule,
                                   self.rc.ambdg.b_bar, self.rc.ambdg.tau)


_REGISTRY: Dict[str, Type[Strategy]] = {}
# registered in the JAX package, ported in a later slice
_LATER = {"decentralized": "ROADMAP A.10"}


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


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@register
class AmbdgStrategy(Strategy):
    """Anytime minibatch with delayed gradients: anytime accumulation
    -> tau-deep delay ring -> dual averaging, on the arena master (or
    the pytree reference). A stochastic ``rc.delay`` runs the
    delay-tolerant ring."""

    name = "ambdg"
    sim_engine = "anytime"

    def __init__(self, model: Model, rc: RunConfig):
        super().__init__(model, rc)
        self.init_state, self.train_step = ambdg.build_step_fns(model, rc)

    def staleness_schedule(self) -> StalenessSchedule:
        from repro_torch.core.delay_process import resolve_bounds
        dc = self.rc.delay
        if dc.process != "fixed":
            lo, hi = resolve_bounds(dc, self.rc.ambdg.tau)
            adaptive = ("delay-adaptive alpha" if dc.adaptive_alpha
                        else "worst-case alpha")
            return StalenessSchedule(
                "random", hi,
                f"stochastic tau_t in [{lo}, {hi}] from the seeded "
                f"{dc.process!r} delay process (delay-tolerant ring, "
                f"{adaptive})")
        tau = self.rc.ambdg.tau
        return StalenessSchedule(
            "delayed" if tau else "sync", tau,
            "deterministic tau = ceil(T_c / T_p) after pipeline fill")

    @classmethod
    def timeline_model(cls) -> TimelineModel:
        # workers never idle: epochs tile at T_p; the t-th update lands
        # half a round trip after epoch t ends (paper Fig. 1)
        return TimelineModel(
            scheme=cls.name, event_driven=False,
            epoch_duration=lambda t_p, t_c: t_p,
            update_time=lambda t, t_p, t_c: t * t_p + 0.5 * t_c,
            n_updates=lambda total, t_p, t_c:
                max(int((total - 0.5 * t_c) // t_p), 0))


@register
class AmbStrategy(Strategy):
    """Synchronous AMB (Ferdinand et al.): the AMB-DG step with tau = 0
    on the device; the wall-clock penalty (workers idle through the
    round trip) lives in the timeline model."""

    name = "amb"
    sim_engine = "anytime"

    def __init__(self, model: Model, rc: RunConfig):
        if rc.delay.process != "fixed":
            raise ValueError(
                f"strategy 'amb' does not support the stochastic delay "
                f"process {rc.delay.process!r}: the synchronous baseline "
                "blocks on every round trip")
        rc = rc.replace(ambdg=dataclasses.replace(rc.ambdg, tau=0))
        super().__init__(model, rc)
        self.init_state, self.train_step = ambdg.build_step_fns(model, rc)

    def staleness_schedule(self) -> StalenessSchedule:
        return StalenessSchedule("sync", 0, "fresh gradients every epoch")

    @classmethod
    def timeline_model(cls) -> TimelineModel:
        return TimelineModel(
            scheme=cls.name, event_driven=False,
            epoch_duration=lambda t_p, t_c: t_p + t_c,
            update_time=lambda t, t_p, t_c: t * t_p + (t - 0.5) * t_c,
            n_updates=lambda total, t_p, t_c:
                max(int((total - t_p - 0.5 * t_c) // (t_p + t_c)) + 1, 0))


class KBatchState(NamedTuple):
    """The on-device step's state: the master-pipeline state plus the
    parameter version ``ref_epoch`` the next gradients refer to, so the
    staleness comes from the state, never from arrival order."""
    base: ambdg.TrainState
    ref_epoch: torch.Tensor    # () int32


@register
class KBatchStrategy(Strategy):
    """Fixed per-message minibatch. The K arrivals per update and the
    random staleness are event-driven and live in the simulator
    (``core.kbatch.KBatchMaster`` in ``sim.simulate_kbatch``, K from
    ``AmbdgConfig.kbatch_K``); the on-device step is its synchronous
    degenerate: every worker's message arrives together, the staleness
    is 0, and the step is the tau = 0 master pipeline on fixed-size
    minibatches. A stochastic ``rc.delay`` is validated here and
    consumed by the simulator (per-message uplink jitter)."""

    name = "kbatch"
    sim_engine = "kbatch"

    def __init__(self, model: Model, rc: RunConfig):
        from repro_torch.core.delay_process import resolve_bounds
        resolve_bounds(rc.delay, rc.ambdg.tau)
        self.delay_cfg = rc.delay
        self._nominal_tau = rc.ambdg.tau
        rc = rc.replace(ambdg=dataclasses.replace(rc.ambdg, tau=0),
                        delay=dataclasses.replace(rc.delay, process="fixed",
                                                  tau_max=0))
        super().__init__(model, rc)
        init_base, step_base = ambdg.build_step_fns(model, rc)
        device = model.device

        def init_state(generator=None) -> KBatchState:
            return KBatchState(base=init_base(generator),
                               ref_epoch=torch.ones((), dtype=torch.int32,
                                                    device=device))

        def train_step(state: KBatchState, batch):
            base, metrics = step_base(state.base, batch)
            metrics["staleness"] = metrics["step"] - state.ref_epoch
            return KBatchState(base=base,
                               ref_epoch=state.ref_epoch + 1), metrics

        self.init_state = init_state
        self.train_step = train_step

    def delay_process(self):
        # the on-device step stripped rc.delay to fixed; the simulator's
        # process comes from the configured one, with the nominal tau
        if self.delay_cfg.process == "fixed":
            return None
        from repro_torch.core.delay_process import make_delay_process
        return make_delay_process(self.delay_cfg, self._nominal_tau)

    def batch_schedule(self):
        # the device step runs the tau = 0 degenerate, but the
        # delay-aware schedule refers to the configured nominal
        # staleness (the event-driven simulator's regime)
        if self.rc.batch_schedule.schedule == "fixed":
            return None
        from repro_torch.core.batch_schedule import make_batch_schedule
        return make_batch_schedule(self.rc.batch_schedule,
                                   self.rc.ambdg.b_bar, self._nominal_tau)

    def staleness_schedule(self) -> StalenessSchedule:
        extra = ""
        if self.delay_cfg.process != "fixed":
            extra = (f"; uplink times jittered by the seeded "
                     f"{self.delay_cfg.process!r} delay process in the "
                     f"event-driven simulator")
        return StalenessSchedule(
            "random", 0,
            "random per-message staleness (update t applies messages "
            "with ref_epoch <= t; distribution from the arrival heap)"
            + extra)

    @classmethod
    def timeline_model(cls) -> TimelineModel:
        return TimelineModel(scheme=cls.name, event_driven=True)
