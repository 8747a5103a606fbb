"""Timeline algebra for AMB-DG (paper Sec. III, Fig. 1): the port's own
copy of ``repro/core/staleness.py``.

Pure-Python bookkeeping. The delivery schedule and the observed
staleness are the host-side oracles the delay-tolerant ring is held to. All times in seconds; epochs are 1-indexed like the paper.

Worked example from the paper (T_c = 3*T_p): tau = 3; gradients for
epochs 1..tau+1 are computed w.r.t. w(1); for t >= tau+2 the master's
t-th update uses gradients computed w.r.t. w(t - tau) — e.g. w(6) is
computed from gradients w.r.t. w(2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence


def _as_epoch(t, name: str = "t", minimum: int = 1) -> int:
    """Validate an epoch/staleness index: integral (ints, or floats
    carrying an exact integer — a 2.0 from float timeline algebra is
    fine, a 2.5 is a bug) and >= ``minimum``. These helpers used to
    accept t=2.5 silently and hand back fractional epochs."""
    if isinstance(t, bool):
        raise ValueError(f"{name} must be an integer epoch index, "
                         f"got {t!r}")
    try:
        ti = int(t)
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be an integer epoch index, "
                         f"got {t!r}") from None
    if ti != t:
        raise ValueError(f"{name} must be an integral epoch index, "
                         f"got non-integer {t!r}")
    if ti < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {t!r}"
                         + (" (epochs are 1-indexed)" if minimum == 1
                            else ""))
    return ti


def staleness(t_c: float, t_p: float) -> int:
    """tau = ceil(T_c / T_p) (paper's staleness parameter)."""
    if t_p <= 0:
        raise ValueError("T_p must be positive")
    if t_c < 0:
        raise ValueError("T_c must be non-negative")
    return int(math.ceil(t_c / t_p))


def gradient_reference_epoch(t: int, tau: int) -> int:
    """Which parameter version w(r) the gradients of epoch t are computed
    against. Paper: r = 1 for 1 <= t <= tau+1, else r = t - tau."""
    t = _as_epoch(t)
    tau = _as_epoch(tau, "tau", minimum=0)
    return max(1, t - tau)


# ---------------------------------------------------------------------------
# Variable-delay (stochastic tau_t) timeline algebra
# ---------------------------------------------------------------------------
def reference_epoch_sequence(delays: Sequence[int]) -> List[int]:
    """Per-update reference epochs under a delay sequence: the
    simulator's downlink model — the master's t-th update applies
    gradients computed w.r.t. w(max(1, t - tau_t)). With a constant
    sequence this is exactly ``gradient_reference_epoch`` per t."""
    return [gradient_reference_epoch(t, d)
            for t, d in enumerate(delays, start=1)]


def delivery_schedule(delays: Sequence[int]) -> Dict[int, List[int]]:
    """The delay-tolerant ring's uplink model: the gradient pushed at
    step s (1-indexed) with delay tau_s is applied at step s + tau_s.
    Returns {applied_step: sorted push steps} — late/out-of-order
    arrivals from different push epochs may share one applied step,
    and some steps receive nothing. The delay-tolerant ring
    (``core.arena.push_pop_variable``) pops exactly these sets."""
    out: Dict[int, List[int]] = {}
    for s, d in enumerate(delays, start=1):
        d = _as_epoch(d, "delay", minimum=0)
        out.setdefault(s + d, []).append(s)
    return {u: sorted(ss) for u, ss in sorted(out.items())}


def observed_staleness(delays: Sequence[int], horizon: int,
                       empty_fallback: float = 0.0) -> List[float]:
    """Mean staleness of the gradients applied at each step 1..horizon
    under ``delivery_schedule`` (equal per-push weights) — the
    host-side twin of the ring's ``tau_obs`` that feeds the
    delay-adaptive step size.

    ``empty_fallback`` is what a zero-arrival step observes. The
    default 0.0 keeps the raw algebra (nothing arrived, nothing is
    stale); to mirror the DEVICE contract — where a stall step must
    feed the ring cap into the adaptive alpha, never a fresh-looking 0
    (see ``core/ambdg.py``) — pass ``empty_fallback=tau_max`` and the sequence matches
    ``metrics["tau_applied"]`` step for step."""
    sched = delivery_schedule(delays)
    out = []
    for u in range(1, _as_epoch(horizon, "horizon") + 1):
        pushes = sched.get(u, [])
        out.append(sum(u - s for s in pushes) / len(pushes)
                   if pushes else float(empty_fallback))
    return out


def worker_receives_update_at(t: int, t_p: float, t_c: float) -> float:
    """Time at which workers receive w(t+1) (paper: t*T_p + T_c)."""
    return t * t_p + t_c


def master_update_time(t: int, t_p: float, t_c: float) -> float:
    """Time of the master's t-th update (paper: t*T_p + T_c/2)."""
    return t * t_p + 0.5 * t_c


def amb_epoch_duration(t_p: float, t_c: float) -> float:
    """Synchronous AMB: workers idle through the round trip each epoch."""
    return t_p + t_c


def ambdg_epoch_duration(t_p: float, t_c: float) -> float:
    """AMB-DG: workers never idle — epochs tile at T_p."""
    return t_p


@dataclass(frozen=True)
class Timeline:
    """Convenience bundle used by the simulator & launcher."""
    t_p: float
    t_c: float

    @property
    def tau(self) -> int:
        return staleness(self.t_c, self.t_p)

    def reference(self, t: int) -> int:
        return gradient_reference_epoch(t, self.tau)

    def epochs_until(self, wall_time: float, scheme: str = "ambdg") -> int:
        """Number of master updates completed by ``wall_time``."""
        dur = (ambdg_epoch_duration if scheme == "ambdg"
               else amb_epoch_duration)(self.t_p, self.t_c)
        first = master_update_time(1, self.t_p, self.t_c)
        if wall_time < first:
            return 0
        return 1 + int((wall_time - first) // dur)
