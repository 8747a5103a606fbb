"""Adaptive minibatch schedules: a batch-size controller b(t) (the
port's own copy of ``repro/core/batch_schedule.py``: numpy only and
seeded, so both packages draw the same targets).

The paper's per-epoch minibatch b(t) is *anytime* — whatever the
workers finished inside T_p — so its size is driven purely by the
timeline model. Two lines of follow-up work argue the target itself
should adapt: AdaDamp-style controllers grow b(t) to damp gradient
noise as the loss decreases (small noisy batches early, large precise
ones near the optimum), and Attia, Gaash & Koren ("Faster Stochastic
Optimization with Arbitrary Delays via Asynchronous Mini-Batching")
scale the accumulated minibatch with the observed delay so stale
updates carry proportionally more signal. This module is the single
source of those targets for every layer:

  * the HOST training loop draws one target per step, folds it into
    the anytime weights mask, and ships it to the device step as
    ``batch["b_sched"]`` — where it replaces the static ``b_bar``
    inside the dual-averaging step size
    alpha(t)^-1 = L + sqrt((t + tau) / b(t));
  * the cluster simulator draws the same seeded sequence per epoch
    (anytime) or per job (k-batch) via ``Strategy.batch_schedule()``
    and ``api.simulate``, so golden traces pin the targets exactly;
  * ``observe(loss=..., tau_obs=...)`` feeds the training signal back
    after each update (closed loop for adadamp / delay_aware; a no-op
    for the open-loop schedules).

Every schedule is seeded (``numpy.random.default_rng``), emits integer
targets in ``[b_min, b_cap]``, and checkpoints its full state
(``state_dict``/``load_state_dict``) so restarts reproduce the exact
remaining sequence — the same restart-exactness contract the delay and
worker processes keep.

Four schedules (``BatchScheduleConfig.schedule``):

  fixed        b(t) = b0. The degenerate case: strategies return no
               controller and every consumer routes to the
               pre-existing timing-driven path, pinned bit-identical
               by the regression suites.
  linear       b(t) = b0 + floor(growth_rate * (t - 1)): a
               deterministic warmup ramp.
  adadamp      b(t) = b0 * loss(1) / ema_loss(t), monotone
               non-decreasing with per-step growth capped at
               growth_factor: batch grows inversely with the
               (EMA-smoothed) loss, damping gradient noise exactly
               when it starts to dominate the signal.
  delay_aware  b(t) = b0 * (1 + ema_tau(t)) / (1 + tau_ref): batch
               scales with the observed staleness of applied
               gradients, composing with the Agarwal-Duchi
               delay-adaptive alpha (``rc.delay.adaptive_alpha``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np

from repro_torch.configs.base import BatchScheduleConfig


def resolve_targets(cfg: BatchScheduleConfig, b_bar: float) -> Tuple[int, int, int]:
    """Validate ``cfg`` against the nominal minibatch ``b_bar`` and
    return the resolved ``(b0, b_min, b_cap)``. ``b0=0`` resolves to
    ``round(b_bar)`` (the static target alpha already assumes);
    ``b_cap=0`` resolves to ``16 * b0``."""
    if cfg.schedule not in BATCH_SCHEDULES:
        raise ValueError(f"unknown batch schedule {cfg.schedule!r}; "
                         f"registered: {sorted(BATCH_SCHEDULES)}")
    b0 = cfg.b0 or int(round(b_bar))
    if b0 < 1:
        raise ValueError(f"batch schedule base b0 must be >= 1, got {b0} "
                         f"(b0={cfg.b0}, b_bar={b_bar})")
    if cfg.b_min < 1:
        raise ValueError(f"b_min must be >= 1, got {cfg.b_min}")
    b_cap = cfg.b_cap or 16 * b0
    if b_cap < b0 or cfg.b_min > b_cap:
        raise ValueError(f"need b_min <= b0 <= b_cap, got b_min={cfg.b_min}, "
                         f"b0={b0}, b_cap={b_cap}")
    if cfg.schedule == "linear" and cfg.growth_rate < 0.0:
        raise ValueError(f"growth_rate must be >= 0, got {cfg.growth_rate}")
    if cfg.schedule == "adadamp" and cfg.growth_factor <= 1.0:
        raise ValueError(f"adadamp growth_factor must be > 1, "
                         f"got {cfg.growth_factor}")
    if not 0.0 < cfg.ema <= 1.0:
        raise ValueError(f"ema weight must be in (0, 1], got {cfg.ema}")
    return b0, cfg.b_min, b_cap


class BatchSchedule:
    """One seeded per-step minibatch-target sequence. Subclasses
    implement ``_draw()`` -> int (reading any feedback recorded by
    ``observe``); the base class owns seeding, clipping to
    ``[b_min, b_cap]``, the step counter, and checkpointable state."""

    name: str = "?"

    def __init__(self, cfg: BatchScheduleConfig, b_bar: float, tau: int):
        self.cfg = cfg
        self.b_bar = float(b_bar)
        self.tau = int(tau)
        self.b0, self.b_min, self.b_cap = resolve_targets(cfg, b_bar)
        self._rng = np.random.default_rng(cfg.seed)
        self._t = 0          # steps drawn so far
        self._last = self.b0  # most recent emitted target

    def _draw(self) -> int:
        raise NotImplementedError

    def target(self) -> int:
        """Draw the next target b(t) (advances the step counter)."""
        self._t += 1
        self._last = int(np.clip(self._draw(), self.b_min, self.b_cap))
        return self._last

    def observe(self, *, loss: Optional[float] = None,
                tau_obs: Optional[float] = None):
        """Feed back the post-update training signal (the loss and the
        observed staleness ``metrics["tau_applied"]``). Open-loop
        schedules ignore it."""

    def sequence(self, n: int) -> np.ndarray:
        """The next ``n`` targets as an int64 array (advances state;
        no feedback, so closed-loop schedules hold their base)."""
        return np.asarray([self.target() for _ in range(n)], np.int64)

    # -- restart exactness -------------------------------------------------
    def state_dict(self) -> Dict:
        return {"rng": self._rng.bit_generator.state,
                "t": self._t, "last": self._last}

    def load_state_dict(self, s: Dict):
        self._rng.bit_generator.state = s["rng"]
        self._t = int(s["t"])
        self._last = int(s["last"])

    def __repr__(self):
        return (f"{type(self).__name__}(b0={self.b0}, "
                f"bounds=[{self.b_min}, {self.b_cap}], "
                f"seed={self.cfg.seed})")


class FixedBatch(BatchSchedule):
    """The static target — the degenerate schedule every consumer
    routes to the pre-existing timing-driven path."""

    name = "fixed"

    def _draw(self) -> int:
        return self.b0


class LinearBatch(BatchSchedule):
    """Deterministic warmup ramp: b0 + floor(growth_rate * (t-1))."""

    name = "linear"

    def _draw(self) -> int:
        return self.b0 + int(np.floor(self.cfg.growth_rate * (self._t - 1)))


class AdadampBatch(BatchSchedule):
    """Grow the batch inversely with the (EMA-smoothed) loss: early
    steps run small noisy batches (cheap progress while the signal
    dominates), late steps run large ones (noise damping when the
    gradient shrinks). b(t) = b0 * loss(1)/ema_loss(t), monotone
    non-decreasing, per-step growth capped at ``growth_factor``x so a
    lucky loss spike down can't explode the target."""

    name = "adadamp"

    def __init__(self, cfg: BatchScheduleConfig, b_bar: float, tau: int):
        super().__init__(cfg, b_bar, tau)
        self._loss0: Optional[float] = None   # first observed loss
        self._ema_loss: Optional[float] = None

    def observe(self, *, loss: Optional[float] = None,
                tau_obs: Optional[float] = None):
        if loss is None or not np.isfinite(loss) or loss <= 0.0:
            return
        if self._loss0 is None:
            self._loss0 = float(loss)
            self._ema_loss = float(loss)
        else:
            w = self.cfg.ema
            self._ema_loss = (1.0 - w) * self._ema_loss + w * float(loss)

    def _draw(self) -> int:
        if self._loss0 is None:
            return self.b0
        want = self.b0 * self._loss0 / max(self._ema_loss, 1e-12)
        capped = min(want, self._last * self.cfg.growth_factor)
        return max(int(np.floor(capped)), self._last)  # monotone

    def state_dict(self) -> Dict:
        s = super().state_dict()
        s["loss0"] = self._loss0
        s["ema_loss"] = self._ema_loss
        return s

    def load_state_dict(self, s: Dict):
        super().load_state_dict(s)
        self._loss0 = None if s.get("loss0") is None else float(s["loss0"])
        self._ema_loss = (None if s.get("ema_loss") is None
                          else float(s["ema_loss"]))


class DelayAwareBatch(BatchSchedule):
    """Scale the batch with the observed staleness (Attia-Gaash-Koren:
    an update that waited tau steps should carry ~tau steps' worth of
    samples). b(t) = b0 * (1 + ema_tau(t)) / (1 + tau_ref), where
    tau_ref is the nominal staleness the base b0 was sized for and
    ema_tau tracks ``observe(tau_obs=...)`` — the same tau_applied the
    delay-adaptive alpha consumes, so the two adaptations compose."""

    name = "delay_aware"

    def __init__(self, cfg: BatchScheduleConfig, b_bar: float, tau: int):
        super().__init__(cfg, b_bar, tau)
        self._ema_tau = float(tau)

    def observe(self, *, loss: Optional[float] = None,
                tau_obs: Optional[float] = None):
        if tau_obs is None or not np.isfinite(tau_obs) or tau_obs < 0.0:
            return
        w = self.cfg.ema
        self._ema_tau = (1.0 - w) * self._ema_tau + w * float(tau_obs)

    def _draw(self) -> int:
        return int(round(self.b0 * (1.0 + self._ema_tau)
                         / (1.0 + self.tau)))

    def state_dict(self) -> Dict:
        s = super().state_dict()
        s["ema_tau"] = self._ema_tau
        return s

    def load_state_dict(self, s: Dict):
        super().load_state_dict(s)
        self._ema_tau = float(s["ema_tau"])


BATCH_SCHEDULES: Dict[str, Type[BatchSchedule]] = {
    c.name: c for c in (FixedBatch, LinearBatch, AdadampBatch,
                        DelayAwareBatch)}


def make_batch_schedule(cfg: BatchScheduleConfig, b_bar: float,
                        tau: int) -> BatchSchedule:
    """Construct the schedule named by ``cfg.schedule`` (validates the
    config — every consumer goes through here)."""
    resolve_targets(cfg, b_bar)   # raise early with the full message
    return BATCH_SCHEDULES[cfg.schedule](cfg, b_bar, tau)
