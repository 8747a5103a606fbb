"""K-batch async baseline (Dutta et al., AISTATS'18; paper Sec. VI),
ported from ``repro/core/kbatch.py``.

Fixed per-message minibatch: each worker repeatedly computes exactly
b/K gradients and ships the sum; the master updates as soon as any K
messages have arrived (not necessarily from distinct workers), so the
staleness is random (the paper's Fig. 4). The arrival order lives in the
simulator (``repro_torch.sim``); this module is the master's update rule
and its staleness bookkeeping.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple

import torch

from repro_torch.configs.base import AmbdgConfig
from repro_torch.core import anytime
from repro_torch.core import dual_averaging as da
from repro_torch.core.arena import tree_sum


class Message(NamedTuple):
    grad_sum: Any      # tree: the sum of b/K per-sample gradients
    count: float       # = b/K
    ref_epoch: int     # parameter version the gradients were taken at
    worker: int = -1   # sender: the canonical tie-break among messages
    #                    of one epoch


class KBatchMaster:
    """Collects messages; updates via pytree dual averaging on every
    K-th.

    Each triggering batch of K messages is processed in the canonical
    ``(ref_epoch, worker)`` order, not in arrival order: the gradient
    sum (a left fold) and the staleness log then depend only on which
    messages arrived, never on how the event heap broke ties.

    ``adaptive_b`` (adaptive batch schedules): the step size takes each
    triggering batch's total count in place of the static ``cfg.b_bar``;
    under a schedule the K message counts are the drawn targets, so
    alpha tracks the batch the controller asked for (the K-batch twin
    of ``batch["b_sched"]``)."""

    def __init__(self, params, cfg: AmbdgConfig, K: int,
                 adaptive_b: bool = False):
        self.cfg = cfg
        self.K = K
        self.adaptive_b = adaptive_b
        self.state = da.init(params)
        self.params = params
        self.pending: List[Message] = []
        self.update_count = 0
        self.staleness_log: List[int] = []

    def receive(self, msg: Message) -> bool:
        """Returns True if this message triggered a parameter update."""
        self.pending.append(msg)
        if len(self.pending) < self.K:
            return False
        batch = sorted(self.pending, key=lambda m: (m.ref_epoch, m.worker))
        self.pending = []
        total = sum(m.count for m in batch)
        g = anytime.normalize(
            tree_sum([m.grad_sum for m in batch]),
            torch.full((), total, dtype=torch.float32,
                       device=self.state.t.device))
        for m in batch:
            self.staleness_log.append(self.update_count + 1 - m.ref_epoch)
        self.params, self.state = da.update(
            self.state, g, self.cfg,
            b=float(total) if self.adaptive_b else None)
        self.update_count += 1
        return True
