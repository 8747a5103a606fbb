"""Elastic-worker processes: time-varying active sets and speed skew
(the port's own copy of ``repro/core/worker_process.py``: numpy only
and seeded, so both packages draw the same sequences).

Exploiting stragglers is the founding premise of the AMB line
(Ferdinand et al., "Anytime MiniBatch: Exploiting Stragglers"), and
AMB-DG's aggregation rule makes worker failure cheap by construction:
a dead worker contributes b_i(t) = 0 and the eq. (5) normalization
stays exact (paper Sec. IV-C). This module is the single source of
seeded churn/straggler/crash scenarios for every layer — the elastic
twin of ``core.delay_process``:

  * the HOST training loop draws one ``(active_mask, speeds)`` pair
    per step and folds it into ``batch["weights"]`` (via
    ``train.fault``), heartbeating ``WorkerHealth`` on the way so
    eviction / elastic re-mesh / readmission run against the same
    seeded sequence;
  * the cluster simulator draws per-epoch masks for the anytime
    engine and epoch-indexed masks for the k-batch arrival heap, so
    golden traces pin the sequences exactly;
  * the decentralized strategy (``core.strategy.DecentralizedStrategy``)
    gets the mask in its device step as ``batch["active"]`` and
    renormalizes its gossip stencil around dead neighbours.

Every process is seeded (``numpy.random.default_rng``), emits one
boolean ``(n_workers,)`` active mask plus one float64 ``(n_workers,)``
speed vector per epoch, and checkpoints its full state
(``state_dict``/``load_state_dict``) so restarts reproduce the exact
remaining sequence — the same restart-exactness contract the data
pipeline and the delay processes keep.

Four processes (``ElasticConfig.process``):

  static         everyone alive at speed 1.0 — the degenerate case:
                 the host loop and the strategies route it to the
                 pre-existing no-churn path, pinned bit-identical by
                 the regression suites.
  heterogeneous  persistent per-worker speed skew: multipliers drawn
                 once from lognormal(-sigma^2/2, sigma) (mean 1.0),
                 floored at ``speed_min``; all workers stay alive.
  churn          per-worker Gilbert-Elliott up/down chain (the
                 BurstyDelay precedent, one chain per worker):
                 up -> down with p_fail, down -> up with p_recover —
                 geometric dwell times, join/leave membership.
  crash_restart  exponential MTTF/MTTR in epoch units: each worker
                 alternates Exp(mttf)-long lives with Exp(mttr)-long
                 outages (fail-stop and restart), timers redrawn on
                 every transition.
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np

from repro_torch.configs.base import ElasticConfig


def validate_elastic(cfg: ElasticConfig) -> None:
    """Validate ``cfg`` (the ``resolve_bounds`` twin — every consumer
    goes through here via ``make_worker_process``; strategies call it
    at build time so a bad config fails before any step runs)."""
    if cfg.process not in WORKER_PROCESSES:
        raise ValueError(f"unknown elastic worker process "
                         f"{cfg.process!r}; registered: "
                         f"{sorted(WORKER_PROCESSES)}")
    if not 0.0 <= cfg.p_fail <= 1.0 or not 0.0 <= cfg.p_recover <= 1.0:
        raise ValueError("churn transition probabilities must be in "
                         f"[0, 1], got p_fail={cfg.p_fail}, "
                         f"p_recover={cfg.p_recover}")
    if cfg.process == "churn" and cfg.p_fail > 0 and cfg.p_recover == 0:
        raise ValueError("churn with p_recover=0 permanently drains "
                         "the worker set; use crash_restart semantics "
                         "or a nonzero p_recover")
    if cfg.mttf <= 0.0 or cfg.mttr <= 0.0:
        raise ValueError(f"mttf/mttr must be > 0 epochs, got "
                         f"mttf={cfg.mttf}, mttr={cfg.mttr}")
    if cfg.speed_sigma < 0.0:
        raise ValueError(f"speed_sigma must be >= 0, got "
                         f"{cfg.speed_sigma}")
    if not 0.0 < cfg.speed_min <= 1.0:
        raise ValueError(f"speed_min must be in (0, 1], got "
                         f"{cfg.speed_min}")


class WorkerProcess:
    """One seeded per-epoch ``(active_mask, speeds)`` sequence.
    Subclasses implement ``_draw()`` -> (bool (n,), float (n,)); the
    base class owns seeding, sanitization and checkpointable state."""

    name: str = "?"

    def __init__(self, cfg: ElasticConfig, n_workers: int):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        validate_elastic(cfg)
        self.cfg = cfg
        self.n_workers = int(n_workers)
        self._rng = np.random.default_rng(cfg.seed)
        self._t = 0

    def _draw(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def step(self) -> Tuple[np.ndarray, np.ndarray]:
        """Draw the next epoch's (active bool (n,), speeds f64 (n,))
        pair (advances the seeded state). Speeds are clipped to >= 0;
        a dead worker's speed is still emitted (the mask governs)."""
        active, speeds = self._draw()
        self._t += 1
        active = np.asarray(active, bool).reshape(self.n_workers)
        speeds = np.maximum(
            np.asarray(speeds, np.float64).reshape(self.n_workers), 0.0)
        return active, speeds

    def sequence(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """The next ``n`` epochs as stacked (n, n_workers) mask/speed
        arrays (advances state)."""
        pairs = [self.step() for _ in range(n)]
        return (np.stack([a for a, _ in pairs]),
                np.stack([s for _, s in pairs]))

    # -- restart exactness -------------------------------------------------
    def state_dict(self) -> Dict:
        return {"rng": self._rng.bit_generator.state, "t": self._t}

    def load_state_dict(self, s: Dict):
        self._rng.bit_generator.state = s["rng"]
        self._t = int(s.get("t", 0))

    def __repr__(self):
        return (f"{type(self).__name__}(n_workers={self.n_workers}, "
                f"seed={self.cfg.seed})")


class StaticWorkers(WorkerProcess):
    """Everyone alive at speed 1.0 — the degenerate process the host
    loop and every strategy route to the exact pre-existing no-churn
    path (regression-pinned bit-identical)."""

    name = "static"

    def _draw(self):
        return (np.ones(self.n_workers, bool),
                np.ones(self.n_workers, np.float64))


class HeterogeneousWorkers(WorkerProcess):
    """Persistent per-worker speed skew: multipliers drawn ONCE from
    lognormal(-sigma^2/2, sigma) (unit mean before the floor), floored
    at ``speed_min`` — the paper's SciNet observation that straggling
    is persistent, as a speed process. All workers stay alive."""

    name = "heterogeneous"

    def __init__(self, cfg: ElasticConfig, n_workers: int):
        super().__init__(cfg, n_workers)
        sig = cfg.speed_sigma
        self._speeds = np.maximum(
            self._rng.lognormal(-0.5 * sig * sig, sig, n_workers)
            if sig > 0 else np.ones(n_workers, np.float64),
            cfg.speed_min)

    def _draw(self):
        return np.ones(self.n_workers, bool), self._speeds.copy()

    def state_dict(self) -> Dict:
        s = super().state_dict()
        # speeds are derivable from the seed, but a restore must not
        # depend on the restoring instance having drawn them the same
        # way — carry them explicitly (restart exactness by value)
        s["speeds"] = self._speeds.tolist()
        return s

    def load_state_dict(self, s: Dict):
        super().load_state_dict(s)
        if "speeds" in s:
            self._speeds = np.asarray(s["speeds"], np.float64)


class ChurnWorkers(WorkerProcess):
    """Join/leave membership: one Gilbert-Elliott up/down chain per
    worker (the BurstyDelay precedent vectorized across the fleet).
    Transitions are drawn BEFORE the emission, so a worker that fails
    at epoch t already contributes b_i(t) = 0. Dwell times are
    geometric: mean uptime 1/p_fail, mean downtime 1/p_recover."""

    name = "churn"

    def __init__(self, cfg: ElasticConfig, n_workers: int):
        super().__init__(cfg, n_workers)
        self._up = np.ones(n_workers, bool)

    def _draw(self):
        u = self._rng.random(self.n_workers)
        fail = self._up & (u < self.cfg.p_fail)
        recover = ~self._up & (u < self.cfg.p_recover)
        self._up = (self._up & ~fail) | recover
        return self._up.copy(), np.ones(self.n_workers, np.float64)

    def state_dict(self) -> Dict:
        s = super().state_dict()
        s["up"] = self._up.tolist()
        return s

    def load_state_dict(self, s: Dict):
        super().load_state_dict(s)
        if "up" in s:
            self._up = np.asarray(s["up"], bool)


class CrashRestartWorkers(WorkerProcess):
    """Fail-stop with restart: each worker alternates Exp(mttf)-long
    lives and Exp(mttr)-long outages (continuous-time two-state
    renewal process sampled on the epoch grid). Per-worker countdown
    timers are redrawn on every transition; ceil to >= 1 epoch so a
    transition is always observable."""

    name = "crash_restart"

    def __init__(self, cfg: ElasticConfig, n_workers: int):
        super().__init__(cfg, n_workers)
        self._up = np.ones(n_workers, bool)
        self._timer = self._draw_timers(self._up)

    def _draw_timers(self, up: np.ndarray) -> np.ndarray:
        mean = np.where(up, self.cfg.mttf, self.cfg.mttr)
        return np.maximum(
            np.ceil(self._rng.exponential(mean)).astype(np.int64), 1)

    def _draw(self):
        self._timer -= 1
        expired = self._timer <= 0
        if expired.any():
            self._up = self._up ^ expired
            fresh = self._draw_timers(self._up)
            self._timer = np.where(expired, fresh, self._timer)
        return self._up.copy(), np.ones(self.n_workers, np.float64)

    def state_dict(self) -> Dict:
        s = super().state_dict()
        s["up"] = self._up.tolist()
        s["timer"] = self._timer.tolist()
        return s

    def load_state_dict(self, s: Dict):
        super().load_state_dict(s)
        if "up" in s:
            self._up = np.asarray(s["up"], bool)
        if "timer" in s:
            self._timer = np.asarray(s["timer"], np.int64)


WORKER_PROCESSES: Dict[str, Type[WorkerProcess]] = {
    c.name: c for c in (StaticWorkers, HeterogeneousWorkers,
                        ChurnWorkers, CrashRestartWorkers)}


def make_worker_process(cfg: ElasticConfig, n_workers: int
                        ) -> WorkerProcess:
    """Construct the process named by ``cfg.process`` (validates the
    config — every consumer goes through here)."""
    validate_elastic(cfg)         # raise early with the full message
    return WORKER_PROCESSES[cfg.process](cfg, n_workers)
