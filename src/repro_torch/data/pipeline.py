"""Host-side data pipeline with anytime masking, seeded numpy: the same
batches as ``repro/data/pipeline.py`` for the same seed.

Given per-worker minibatch sizes b_i(t) (the shifted-exponential model,
or every worker full), it emits a fixed-shape global batch whose
per-sample ``weights`` zero out the samples slower workers did not
finish. ``state_dict``/``load_state_dict`` carry the stream cursor and
the timing draw's generator, so a restart is sample-exact;
``apply_batch_target`` caps the weights at a batch schedule's target.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import make_stream
from repro_torch.data.timing import ShiftedExponential


@dataclass
class AnytimePipeline:
    cfg: ModelConfig
    n_workers: int
    samples_per_worker: int          # max samples a worker may contribute
    seq_len: int = 0                 # LM families: tokens per sample
    seed: int = 0
    timing: Optional[ShiftedExponential] = None
    t_p: float = 2.5

    def __post_init__(self):
        self.stream = make_stream(self.cfg, self.seed)
        self._rng = np.random.default_rng(self.seed + 17)
        self.b_history = []

    def _draw_b(self) -> np.ndarray:
        """Per-worker completed sample counts for this epoch."""
        if self.timing is None:
            return np.full((self.n_workers,), self.samples_per_worker,
                           np.int64)
        b = self.timing.minibatch_in(self._rng, self.n_workers, self.t_p)
        return np.minimum(b, self.samples_per_worker)

    def next_global_batch(self) -> Dict[str, np.ndarray]:
        """Fixed-shape (n_workers * samples_per_worker, ...) batch with
        anytime weights. Worker i's samples occupy the contiguous slice
        [i*spw, (i+1)*spw); the first b_i(t) carry weight 1."""
        total = self.n_workers * self.samples_per_worker
        if self.seq_len:
            batch = self.stream.next_batch(total, self.seq_len)
        else:
            batch = self.stream.next_batch(total)
        b = self._draw_b()
        self.b_history.append(b.copy())
        w = np.zeros((self.n_workers, self.samples_per_worker), np.float32)
        for i, bi in enumerate(b):
            w[i, :bi] = 1.0
        batch["weights"] = w.reshape(-1)
        return batch

    def state_dict(self):
        return {"stream": self.stream.state_dict(),
                "rng": self._rng.bit_generator.state}

    def load_state_dict(self, s):
        self.stream.load_state_dict(s["stream"])
        self._rng.bit_generator.state = s["rng"]


def apply_batch_target(weights: np.ndarray, b_target: int, n_workers: int,
                       samples_per_worker: int) -> np.ndarray:
    """Cap the anytime weights at a batch schedule's global target b(t):
    the target splits evenly across workers (remainder to the lowest
    ranks) and worker i keeps the first min(b_i, share_i) of its drawn
    samples. A worker never contributes samples it did not finish; the
    schedule bounds the total the step aggregates (alpha meanwhile takes
    the schedule's b(t), shipped separately as ``batch["b_sched"]``)."""
    w = np.asarray(weights, np.float32).reshape(n_workers, samples_per_worker)
    share, rem = divmod(int(b_target), n_workers)
    out = np.zeros_like(w)
    for i in range(n_workers):
        cap = min(share + (1 if i < rem else 0), samples_per_worker)
        drawn = int(round(float(np.count_nonzero(w[i]))))
        keep = min(drawn, cap)
        if keep > 0:
            out[i, :keep] = w[i, :keep]
    return out.reshape(-1)
