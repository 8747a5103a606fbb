"""Failure detection & elastic membership for the anytime scheme (the
port's own copy of ``repro/train/fault.py``: numpy only).

AMB-DG's aggregation rule makes fault tolerance cheap: a worker that
misses an epoch simply contributes b_i(t) = 0 and the weighted
normalization stays exact (paper Sec. IV-C — the cost appears only in
the b_bar/b_hat straggler ratio). This module tracks liveness and
converts it into the per-epoch anytime mask; persistent failures
trigger an elastic re-mesh request (handled by the host loop, which
records the plan, checkpoints, and readmits workers the elastic
process brings back — see ``train.loop`` and
``core.worker_process``).

The port's loop builds a ``WorkerHealth`` only under an elastic worker
process, on its virtual epoch clock (``t0=0.0``, ``at=float(step)``).
Without one it builds none: a wall-clock tracker that nothing feeds
would mask every worker once a run passes ``heartbeat_timeout``
seconds, as the JAX loop's does (ROADMAP C.2).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

import numpy as np

log = logging.getLogger(__name__)


@dataclass
class WorkerHealth:
    n_workers: int
    heartbeat_timeout: float = 30.0
    eviction_misses: int = 3
    # Epoch the clock starts at. Callers driving liveness on a virtual
    # clock (``at=float(step)`` — the elastic host loop) MUST set this,
    # otherwise the wall-clock seed makes never-heard-from workers look
    # infinitely fresh against small virtual times.
    t0: Optional[float] = None

    def __post_init__(self):
        now = time.monotonic() if self.t0 is None else self.t0
        self.last_seen = {i: now for i in range(self.n_workers)}
        self.missed: Dict[int, int] = {i: 0 for i in range(self.n_workers)}
        self.evicted: Set[int] = set()
        # heartbeats received from already-evicted workers: ignored
        # (eviction is explicit — a zombie heartbeat must not silently
        # resurrect a worker the re-mesh plan already dropped), but
        # counted and logged so the launcher can see them
        self.ignored_heartbeats: int = 0

    def heartbeat(self, worker: int, at: Optional[float] = None) -> bool:
        """Record a liveness signal. Returns True if accepted; a
        heartbeat from an EVICTED worker is ignored (readmission is
        the explicit ``readmit`` path the elastic re-mesh drives, not
        a side effect of a late packet)."""
        if worker in self.evicted:
            self.ignored_heartbeats += 1
            log.info("ignored heartbeat from evicted worker %d "
                     "(%d ignored so far)", worker,
                     self.ignored_heartbeats)
            return False
        self.last_seen[worker] = time.monotonic() if at is None else at
        self.missed[worker] = 0
        return True

    def readmit(self, worker: int, at: Optional[float] = None):
        """Elastic re-mesh: bring an evicted worker back into the
        fleet (fresh liveness state). The recovery half of the
        eviction -> re-mesh plan -> checkpoint-restore cycle."""
        self.evicted.discard(worker)
        self.missed[worker] = 0
        self.last_seen[worker] = time.monotonic() if at is None else at

    def tick(self, at: Optional[float] = None) -> List[int]:
        """Returns workers newly considered failed this epoch."""
        now = time.monotonic() if at is None else at
        newly = []
        for i in range(self.n_workers):
            if i in self.evicted:
                continue
            if now - self.last_seen[i] > self.heartbeat_timeout:
                self.missed[i] += 1
                newly.append(i)
                if self.missed[i] >= self.eviction_misses:
                    self.evicted.add(i)
        return newly

    def anytime_mask(self, b: np.ndarray, at: Optional[float] = None
                     ) -> np.ndarray:
        """Zero out the contributions of failed workers: they are
        indistinguishable from infinitely slow ones to the aggregation."""
        now = time.monotonic() if at is None else at
        out = b.copy()
        for i in range(self.n_workers):
            if i in self.evicted or now - self.last_seen[i] > self.heartbeat_timeout:
                out[i] = 0
        return out

    @property
    def needs_rescale(self) -> bool:
        """Persistent failures -> ask the launcher for an elastic
        re-mesh (drop evicted workers, rebuild, restore checkpoint)."""
        return len(self.evicted) > 0

    def rescale_plan(self) -> Dict:
        alive = [i for i in range(self.n_workers) if i not in self.evicted]
        return {"alive": alive, "n_workers": len(alive)}

    # -- restart exactness -------------------------------------------------
    def state_dict(self) -> Dict:
        return {"last_seen": dict(self.last_seen),
                "missed": dict(self.missed),
                "evicted": sorted(self.evicted),
                "ignored_heartbeats": self.ignored_heartbeats}

    def load_state_dict(self, s: Dict):
        self.last_seen = {int(k): float(v)
                          for k, v in s["last_seen"].items()}
        self.missed = {int(k): int(v) for k, v in s["missed"].items()}
        self.evicted = set(int(w) for w in s["evicted"])
        self.ignored_heartbeats = int(s.get("ignored_heartbeats", 0))


def fold_anytime_weights(weights: np.ndarray, active: np.ndarray,
                         speeds: np.ndarray, n_workers: int,
                         samples_per_worker: int) -> np.ndarray:
    """Fold one elastic ``(active, speeds)`` draw into the pipeline's
    per-sample anytime weights: worker i's effective count becomes
    b'_i = floor(b_i * speed_i) clipped to [0, samples_per_worker],
    zeroed when inactive — a dead worker contributes b_i = 0 and the
    eq. (5) normalization stays exact (paper Sec. IV-C).

    Under the all-alive/speed-1.0 draw the static process emits,
    floor(b_i * 1.0) == b_i exactly (b_i is a small integer), so the
    returned weights are bit-identical to the input — the static ≡
    no-churn regression contract ``tests/test_elastic.py`` pins."""
    w = weights.reshape(n_workers, samples_per_worker)
    b = w.sum(axis=1)                       # per-worker counts (exact
    #                                         small ints as f32/f64)
    b_eff = np.floor(b * np.asarray(speeds, np.float64))
    b_eff = np.clip(b_eff, 0, samples_per_worker).astype(np.int64)
    b_eff = np.where(np.asarray(active, bool), b_eff, 0)
    out = np.zeros_like(w)
    for i, bi in enumerate(b_eff):
        out[i, :bi] = 1.0
    return out.reshape(-1)
