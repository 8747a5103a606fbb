"""Worker compute-time model (paper Sec. VI-A.3), seeded numpy, the
same draws as ``repro/data/timing.py``.

The time for a worker to produce ``b`` gradients is shifted
exponential: f(tau) = lambda * exp(-lambda (tau - xi)), tau >= xi, with
linear progress within an epoch, so in a window T_p worker i completes
b_i(t) = b * T_p / T_i(t) gradients. Paper constants: lambda = 2/3,
xi = 1, b = 60, T_p = 2.5, n = 10.
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
