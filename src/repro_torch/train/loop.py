"""Host training loop of the port (``repro/train/loop.py``): fixed-time
(anytime) epochs for a registered strategy. Each iteration:

  1. the data pipeline draws per-worker anytime counts b_i(t) (the
     shifted-exponential model) and emits the masked global batch
     (seeded numpy: the JAX loop sees the same batches);
  2. under a stochastic ``rc.delay`` the host draws this step's delay
     from the seeded process (``Strategy.delay_process``) into
     ``batch["delay"]``;
  3. the batch moves to the device and the strategy's step runs
     (AMB-DG: anytime accumulate -> delayed pod exchange -> dual-
     averaging update).

The JAX loop's host-side ``WorkerHealth`` masking is left out: as the
reference stands, its wall-clock heartbeat masks every worker once a
run passes 30 s (ROADMAP C.2). Checkpoints, the weight-publication
channel and the elastic process are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import LM_FAMILIES, RunConfig
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.data.timing import ShiftedExponential
from repro_torch.device import resolve_device
from repro_torch.models.api import Model


@dataclasses.dataclass
class LoopConfig:
    n_steps: int = 100
    ckpt_dir: Optional[str] = None      # not ported yet: raises
    log_every: int = 10
    n_workers: int = 8                  # logical anytime workers
    samples_per_worker: int = 8
    use_timing_model: bool = True


def train(model: Model, rc: RunConfig, loop: LoopConfig,
          log_fn: Callable[[Dict], None] = None, device="cuda") -> Dict:
    """Run ``loop.n_steps`` steps of ``rc.strategy`` on ``device``.
    Returns {"state", "history", "b_history"}: ``history`` holds the
    metrics (as floats) every ``log_every`` steps and at the last step,
    with host-clock seconds: ``wall_s`` since the loop began, and for
    that step ``batch_s`` (the host batch), ``h2d_s`` (its copy to the
    device) and ``step_s`` (the step, up to its metrics read back).
    The split is exact where every step is logged (``log_every=1``):
    otherwise a step's device work can finish inside the next one's."""
    from repro_torch import api
    device = resolve_device(device)
    if loop.ckpt_dir:
        raise NotImplementedError("checkpoint/restore is not ported yet "
                                  "(ROADMAP A.5: train/checkpoint.py)")
    if rc.serve.publish_period > 0:
        raise NotImplementedError("the weight-publication channel is not "
                                  "ported yet (ROADMAP A.12)")
    strategy = api.build(model, rc, device=device)
    pipeline = AnytimePipeline(
        cfg=rc.model, n_workers=loop.n_workers,
        samples_per_worker=loop.samples_per_worker,
        seq_len=rc.shape.seq_len if rc.model.family in LM_FAMILIES else 0,
        seed=rc.seed,
        timing=ShiftedExponential() if loop.use_timing_model else None,
        t_p=rc.ambdg.t_p)

    # the host owns the seeded delay process and ships one draw per step
    # (ambdg has the master delay ring; amb refuses a stochastic one)
    delay_proc = strategy.delay_process() if rc.strategy == "ambdg" else None

    # a CPU generator: the model's weights are drawn on the host, so the
    # card and the CPU start from the same ones
    generator = torch.Generator().manual_seed(rc.seed)
    state = strategy.init_state(generator)
    history = []
    t_start = time.monotonic()
    for step in range(loop.n_steps):
        t0 = time.monotonic()
        host = pipeline.next_global_batch()
        if delay_proc is not None:
            host["delay"] = np.asarray(delay_proc.next(), np.int32)
        t1 = time.monotonic()
        # a copy from pageable host memory returns once it has landed
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        t2 = time.monotonic()
        state, metrics = strategy.train_step(state, batch)
        if (step + 1) % loop.log_every == 0 or step == loop.n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}  # waits on the step
            t3 = time.monotonic()
            m.update(wall_s=t3 - t_start, batch_s=t1 - t0, h2d_s=t2 - t1,
                     step_s=t3 - t2)
            history.append(m)
            if log_fn:
                log_fn(m)
    return {"state": state, "history": history,
            "b_history": pipeline.b_history}
