"""Worker compute-time model (paper Sec. VI-A.3), seeded numpy, the
same draws as ``repro/data/timing.py``.

The time for a worker to produce ``b`` gradients is shifted
exponential: f(tau) = lambda * exp(-lambda (tau - xi)), tau >= xi, with
linear progress within an epoch, so in a window T_p worker i completes
b_i(t) = b * T_p / T_i(t) gradients. Paper constants: lambda = 2/3,
xi = 1, b = 60, T_p = 2.5, n = 10. ``PersistentWorkerSpeeds`` draws each
worker's T_i once and keeps it (persistent stragglers).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ShiftedExponential:
    lam: float = 2.0 / 3.0
    xi: float = 1.0
    b: int = 60          # reference minibatch the time is quoted for

    def sample_times(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """T_i: time to compute ``b`` gradients, one draw per worker."""
        return self.xi + rng.exponential(1.0 / self.lam, size=n)

    def minibatch_in(self, rng: np.random.Generator, n: int,
                     t_p: float) -> np.ndarray:
        """b_i(t) for an epoch of length t_p (linear-progress model)."""
        times = self.sample_times(rng, n)
        return np.maximum((self.b * t_p / times).astype(np.int64), 0)

    def time_for(self, rng: np.random.Generator, n: int,
                 k: int) -> np.ndarray:
        """Time for each of n workers to compute exactly k gradients
        (K-batch async): k * T_i / b."""
        times = self.sample_times(rng, n)
        return k * times / self.b

    @property
    def mean_minibatch_rate(self) -> float:
        """E[b_i per unit time] = b * E[1/T], by Monte Carlo (no closed
        form for the shifted exponential)."""
        rng = np.random.default_rng(0)
        t = self.sample_times(rng, 200_000)
        return float(self.b * np.mean(1.0 / t))


@dataclass
class PersistentWorkerSpeeds:
    """Heterogeneous cluster: each worker's speed T_i is drawn ONCE and
    persists (the paper's SciNet workers straggle persistently, which
    gives Fig. 4 its heavier staleness tail)."""
    base: ShiftedExponential
    n_workers: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._times = self.base.sample_times(rng, self.n_workers)

    @property
    def b(self) -> int:
        return self.base.b

    def sample_times(self, rng, n: int) -> np.ndarray:
        if n > self.n_workers:
            raise ValueError(f"{n} workers asked of a fleet of "
                             f"{self.n_workers}")
        return self._times[:n]

    def minibatch_in(self, rng, n: int, t_p: float) -> np.ndarray:
        return np.maximum(
            (self.base.b * t_p / self.sample_times(rng, n)).astype(np.int64),
            0)

    def time_for(self, rng, n: int, k: int) -> np.ndarray:
        """The whole fleet's times for k gradients. A partial call
        (n < n_workers) would lose which worker asks, so it raises: one
        worker's time is ``per_worker_time(worker, k)``."""
        if n != self.n_workers:
            raise ValueError(
                f"PersistentWorkerSpeeds.time_for is fleet-wide "
                f"(n_workers={self.n_workers}, got n={n}); a partial "
                f"call loses the worker identity: use "
                f"per_worker_time(worker, k) for one worker's time")
        return k * self._times / self.base.b

    def per_worker_time(self, worker: int, k: int) -> float:
        return float(k * self._times[worker] / self.base.b)
