"""Stochastic delay processes: time-varying staleness ``tau_t`` (the
port's own copy of ``repro/core/delay_process.py``: numpy only and
seeded, so both packages draw the same sequences).

The paper fixes ``tau = ceil(T_c / T_p)``; its whole point, though, is
wall-clock robustness on real networks, where round trips jitter,
burst, and heavy-tail. Agarwal & Duchi ("Distributed Delayed
Stochastic Optimization") and Attia et al. ("Faster Stochastic
Optimization with Arbitrary Delays") show the interesting regime is
exactly time-varying ``tau_t`` with delay-adaptive step sizes. The
host training loop (``train/loop.py``) draws one delay per step and
ships it to the device step as ``batch["delay"]``; the delay-tolerant
arena ring consumes it (``core.arena.push_pop_variable``).

Every process is seeded (``numpy.random.default_rng``), emits integer
delays in ``[delay_min, tau_max]``, and checkpoints its full state
(``state_dict``/``load_state_dict``) so restarts reproduce the exact
remaining sequence — the same restart-exactness contract the data
pipeline keeps.

Four processes (``DelayConfig.process``):

  fixed        tau_t = tau. The degenerate case: strategies route it
               to the static-phase (ring layout v2) master path.
  jitter       tau_t = clip(tau + U{-jitter..+jitter}): bounded
               symmetric wobble around the nominal round trip.
  heavy_tail   tau_t = clip(delay_min + floor(Pareto(tail_alpha))):
               mostly-fast with rare very-late stragglers (the
               Agarwal-Duchi regime; smaller alpha = fatter tail).
  bursty       2-state Gilbert-Elliott chain: ``delay_min`` .. nominal
               tau in the normal state, ``tau_max`` inside a burst
               (congestion episodes with geometric dwell times).
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np

from repro_torch.configs.base import DelayConfig


def resolve_bounds(cfg: DelayConfig, tau: int) -> Tuple[int, int]:
    """Validate ``cfg`` against the nominal staleness ``tau`` and
    return the resolved ``(delay_min, tau_max)`` bounds. ``tau_max=0``
    resolves to ``tau`` for the fixed process (the ring depth the
    static schedule already uses); stochastic processes must set an
    explicit cap — the ring allocates tau_max+1 slots."""
    if cfg.process not in DELAY_PROCESSES:
        raise ValueError(f"unknown delay process {cfg.process!r}; "
                         f"registered: {sorted(DELAY_PROCESSES)}")
    if cfg.delay_min < 0:
        raise ValueError(f"delay_min must be >= 0, got {cfg.delay_min}")
    tau_max = cfg.tau_max
    if cfg.process == "fixed":
        tau_max = tau_max or tau
        if tau_max < tau:
            raise ValueError(f"fixed process: tau_max={tau_max} < "
                             f"tau={tau}")
        return min(cfg.delay_min, tau), tau_max
    if tau_max < 1:
        raise ValueError(
            f"stochastic delay process {cfg.process!r} needs an explicit "
            f"tau_max >= 1 (the staleness cap sizing the ring), got "
            f"{cfg.tau_max}")
    if cfg.delay_min > tau_max:
        raise ValueError(f"delay_min={cfg.delay_min} > tau_max={tau_max}")
    if not 0.0 <= cfg.p_burst <= 1.0 or not 0.0 <= cfg.p_exit <= 1.0:
        raise ValueError("bursty transition probabilities must be in "
                         f"[0, 1], got p_burst={cfg.p_burst}, "
                         f"p_exit={cfg.p_exit}")
    if cfg.tail_alpha <= 0.0:
        raise ValueError(f"tail_alpha must be > 0, got {cfg.tail_alpha}")
    if cfg.jitter < 0:
        raise ValueError(f"jitter must be >= 0, got {cfg.jitter}")
    return cfg.delay_min, tau_max


class DelayProcess:
    """One seeded per-step delay sequence. Subclasses implement
    ``_draw()`` -> int; the base class owns seeding, clipping to
    ``[delay_min, tau_max]``, and checkpointable state."""

    name: str = "?"

    def __init__(self, cfg: DelayConfig, tau: int):
        self.cfg = cfg
        self.tau = int(tau)
        self.delay_min, self.tau_max = resolve_bounds(cfg, tau)
        self._rng = np.random.default_rng(cfg.seed)

    def _draw(self) -> int:
        raise NotImplementedError

    def next(self) -> int:
        """Draw the next delay (advances the seeded state)."""
        return int(np.clip(self._draw(), self.delay_min, self.tau_max))

    def sequence(self, n: int) -> np.ndarray:
        """The next ``n`` delays as an int64 array (advances state)."""
        return np.asarray([self.next() for _ in range(n)], np.int64)

    # -- restart exactness -------------------------------------------------
    def state_dict(self) -> Dict:
        return {"rng": self._rng.bit_generator.state}

    def load_state_dict(self, s: Dict):
        self._rng.bit_generator.state = s["rng"]

    def __repr__(self):
        return (f"{type(self).__name__}(tau={self.tau}, "
                f"bounds=[{self.delay_min}, {self.tau_max}], "
                f"seed={self.cfg.seed})")


class FixedDelay(DelayProcess):
    """The paper's constant staleness — the degenerate process every
    strategy routes to the pre-existing static-phase path."""

    name = "fixed"

    def _draw(self) -> int:
        return self.tau


class JitterDelay(DelayProcess):
    """Symmetric integer wobble: tau + U{-jitter..+jitter}, clipped."""

    name = "jitter"

    def _draw(self) -> int:
        j = self.cfg.jitter
        return self.tau + int(self._rng.integers(-j, j + 1))


class HeavyTailDelay(DelayProcess):
    """delay_min + floor(Pareto(tail_alpha)), clipped to tau_max:
    mostly delay_min with rare very-late stragglers. tail_alpha <= 1
    has infinite mean before clipping — the cap is what keeps the ring
    finite, exactly the role tau_max plays on device."""

    name = "heavy_tail"

    def _draw(self) -> int:
        return self.delay_min + int(np.floor(
            self._rng.pareto(self.cfg.tail_alpha)))


class BurstyDelay(DelayProcess):
    """Gilbert-Elliott congestion: a 2-state Markov chain with
    geometric dwell times. Normal state emits the nominal delay
    (clip(tau)), burst state pins the cap tau_max. Transitions are
    drawn BEFORE the emission, so a burst entered at step t already
    delays step t's gradient."""

    name = "bursty"

    def __init__(self, cfg: DelayConfig, tau: int):
        super().__init__(cfg, tau)
        self._in_burst = False

    def _draw(self) -> int:
        u = float(self._rng.random())
        if self._in_burst:
            self._in_burst = u >= self.cfg.p_exit
        else:
            self._in_burst = u < self.cfg.p_burst
        return self.tau_max if self._in_burst else self.tau

    def state_dict(self) -> Dict:
        s = super().state_dict()
        s["in_burst"] = bool(self._in_burst)
        return s

    def load_state_dict(self, s: Dict):
        super().load_state_dict(s)
        self._in_burst = bool(s.get("in_burst", False))


DELAY_PROCESSES: Dict[str, Type[DelayProcess]] = {
    c.name: c for c in (FixedDelay, JitterDelay, HeavyTailDelay,
                        BurstyDelay)}


def make_delay_process(cfg: DelayConfig, tau: int) -> DelayProcess:
    """Construct the process named by ``cfg.process`` (validates the
    config — every consumer goes through here)."""
    resolve_bounds(cfg, tau)      # raise early with the full message
    return DELAY_PROCESSES[cfg.process](cfg, tau)
