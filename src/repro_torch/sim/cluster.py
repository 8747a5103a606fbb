"""Event-driven cluster simulator (paper Sec. VI), ported from
``repro/sim/cluster.py``.

Runs AMB-DG, AMB and K-batch async with real gradients computed on the
problem's device inside a simulated wall clock: worker speeds follow the
paper's shifted exponential (eq. (29)), communication takes a
deterministic T_c split half and half between the two legs, and the
master updates by pytree dual averaging. Reproduces Fig. 2 (AMB vs
AMB-DG), Fig. 3/4 (K-batch async and its staleness histogram) and
Fig. 5 (the CNN, AMB-DG against K-batch; ``Trace.final_params`` carries
the weights a held-out loss is taken at).

  * AMB-DG and AMB epochs are time-aligned across workers (the paper's
    synchronized network), so their simulation advances epoch by epoch;
    K-batch async is event-driven (a heap of message arrivals).
  * Every gradient goes through one fixed shape: a worker's batch is
    padded to ``b_max`` rows and masked with the anytime weights.
  * The bookkeeping (times, epochs, minibatches, delays, staleness,
    alive workers, batch targets, clamps) is Python floats and seeded
    numpy, the same draws in the same order as the JAX package, so it
    equals the golden traces exactly. The errors go through the
    device's f32 arithmetic.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import AmbdgConfig, ModelConfig
from repro_torch.core import anytime
from repro_torch.core import dual_averaging as da
from repro_torch.core.arena import tree_map
from repro_torch.core.arena import tree_sum as _tree_sum
from repro_torch.core.kbatch import KBatchMaster, Message
from repro_torch.core.staleness import Timeline
from repro_torch.data.synthetic import make_stream
from repro_torch.data.timing import ShiftedExponential
from repro_torch.device import resolve_device


@dataclass
class SimProblem:
    """Couples a model on ``device``, a data stream per worker, and an
    error metric. ``params0`` comes from the port's own init (a CPU
    generator seeded by ``seed``; the linear regression's w(1) = 0)."""
    cfg: ModelConfig
    n_workers: int
    seed: int = 0
    seq_len: int = 0           # LM families only
    b_max: int = 4096          # per-worker per-epoch padding bound
    device: Any = "cuda"

    def __post_init__(self):
        from repro_torch.models.api import build_model
        self.device = resolve_device(self.device)
        self.model = build_model(self.cfg, device=self.device)
        self.params0 = self.model.init(
            torch.Generator().manual_seed(self.seed))
        self.streams = [make_stream(self.cfg, seed=self.seed,
                                    sample_seed=self.seed + 100 + i)
                        for i in range(self.n_workers)]
        # requests above b_max, clamped and counted (trace.clamps)
        self.clamp_events = 0

    def worker_grad(self, worker: int, params, b_i: int,
                    strict: bool = False):
        """(sum of gradients, count) for worker ``worker`` computing b_i
        samples: the paper's message m_i(t). Draws one batch of ``b_max``
        rows whatever b_i is (the stream's cursor moves as in JAX). A
        request above ``b_max`` is clamped and counted, or raises under
        ``strict``, which the engines set when a batch schedule drives
        the sizes: a silent cap would leave alpha assuming a b(t) that
        never ran."""
        b_i = int(b_i)
        if b_i > self.b_max:
            if strict:
                raise ValueError(
                    f"scheduled minibatch b_i={b_i} overflows the padding "
                    f"bound b_max={self.b_max}; grow SimProblem.b_max to "
                    f"cover the schedule's cap (b_cap split across alive "
                    f"workers)")
            self.clamp_events += 1
            b_i = self.b_max
        if self.seq_len:
            host = self.streams[worker].next_batch(self.b_max, self.seq_len)
        else:
            host = self.streams[worker].next_batch(self.b_max)
        w = np.zeros((self.b_max,), np.float32)
        w[:b_i] = 1.0
        host["weights"] = w
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in host.items()}
        grads, _, _ = anytime.accumulate_scan(self.model.loss, params, batch,
                                              1)
        return grads, float(b_i)

    def error(self, params) -> float:
        """Linreg: the paper's Err(t) (eq. 28); with iid N(0, 1) rows,
        A^T A ~ N I, so Err reduces to ||w - w*||^2 / ||w*||^2, computed
        on the host in f32 numpy as the JAX package does."""
        if self.cfg.family == "linreg":
            w_star = self.streams[0].w_star
            w = params["w"].detach().to(torch.float32).cpu().numpy()
            return float(np.sum((w - w_star) ** 2) / np.sum(w_star ** 2))
        return float("nan")


@dataclass
class Trace:
    scheme: str
    times: List[float] = field(default_factory=list)
    epochs: List[int] = field(default_factory=list)
    errors: List[float] = field(default_factory=list)
    minibatches: List[float] = field(default_factory=list)
    staleness: List[int] = field(default_factory=list)
    # the emitted tau_t sequence when a stochastic delay process drives
    # the run (per epoch for anytime schemes, per message for k-batch)
    delays: List[int] = field(default_factory=list)
    # alive workers per drawn epoch under an elastic worker process
    active: List[int] = field(default_factory=list)
    # the emitted b(t) targets under an adaptive batch schedule (per
    # epoch for anytime schemes, per job for k-batch)
    targets: List[int] = field(default_factory=list)
    # per-update count of capacity clamps (worker requests above
    # SimProblem.b_max)
    clamps: List[int] = field(default_factory=list)
    final_params: object = None

    def summary(self) -> Dict:
        return {"scheme": self.scheme, "updates": len(self.times),
                "final_error": self.errors[-1] if self.errors else None,
                "final_time": self.times[-1] if self.times else None}


# ---------------------------------------------------------------------------
# AMB-DG (and AMB via the synchronous flag)
# ---------------------------------------------------------------------------
def simulate_anytime(problem: SimProblem, *, t_p: float, t_c: float,
                     total_time: float, timing: ShiftedExponential,
                     opt_cfg: AmbdgConfig, scheme: str = "ambdg",
                     rng_seed: int = 0, delay_process=None,
                     worker_process=None, batch_schedule=None) -> Trace:
    """scheme='ambdg': workers never idle; the master applies gradients
    with staleness tau = ceil(T_c/T_p). scheme='amb': synchronous: fresh
    gradients, but each epoch costs T_p + T_c of wall clock.

    ``delay_process`` (ambdg only): a seeded ``core.delay_process``
    instance replacing the constant tau with a per-epoch draw tau_t:
    the t-th update applies gradients computed at w(max(1, t - tau_t)).
    The master's update clock keeps the strategy's closed form. The
    emitted sequence is ``trace.delays``. With the process's
    ``adaptive_alpha`` on, each update's step size takes the observed
    staleness ``t - ref`` of the gradients it applies, as the device
    path's ``metrics["tau_applied"]`` does.

    ``worker_process``: a seeded ``core.worker_process`` instance
    driving a per-epoch active set and speed skew: each epoch's draw
    scales worker i's anytime count to floor(b_i * speed_i) and zeroes
    it when i is down (a dead worker computes nothing and its stream
    does not advance; an all-dead epoch applies an exact zero gradient).
    Alive counts land in ``trace.active``.

    ``batch_schedule``: a seeded ``core.batch_schedule`` controller whose
    per-epoch target b(t) replaces the timing-driven anytime minibatch:
    it splits evenly over the alive workers (remainder to the lowest
    ranks; a share above ``problem.b_max`` raises), the step size takes
    b(t) in place of ``b_bar``, and after each update the controller
    observes the error and the applied staleness. Targets land in
    ``trace.targets``."""
    if scheme not in ("ambdg", "amb"):
        raise ValueError(f"simulate_anytime runs 'ambdg' or 'amb', not "
                         f"{scheme!r}")
    from repro_torch.core.strategy import get_strategy
    tm = get_strategy(scheme).timeline_model()
    tau = Timeline(t_p=t_p, t_c=t_c).tau if scheme == "ambdg" else 0
    if delay_process is not None and scheme != "ambdg":
        raise ValueError("stochastic delay processes apply to the "
                         "'ambdg' scheme (amb is synchronous)")
    # version-retention window: the deepest reference a draw can reach
    tau_keep = delay_process.tau_max if delay_process is not None else tau
    adaptive_alpha = (delay_process is not None
                      and delay_process.cfg.adaptive_alpha)
    rng = np.random.default_rng(rng_seed)
    trace = Trace(scheme=scheme)

    params_versions = {1: problem.params0}  # w(1)
    state = da.init(problem.params0)
    n = problem.n_workers

    for t in range(1, tm.n_updates(total_time, t_p, t_c) + 1):
        if delay_process is not None:
            tau_t = delay_process.next()
            trace.delays.append(tau_t)
            ref = max(1, t - tau_t)
        else:
            ref = max(1, t - tau) if scheme == "ambdg" else t
        w_ref = params_versions[ref]
        b = timing.minibatch_in(rng, n, t_p)
        alive = list(range(n))
        if worker_process is not None:
            w_active, w_speeds = worker_process.step()
            trace.active.append(int(w_active.sum()))
            b = np.where(w_active, np.floor(b * w_speeds).astype(np.int64),
                         0)
            alive = [i for i in range(n) if w_active[i]]
        b_t = None
        if batch_schedule is not None:
            # the target replaces the anytime draw, split evenly over
            # the alive workers (remainder to the lowest ranks)
            b_t = int(batch_schedule.target())
            trace.targets.append(b_t)
            b = np.zeros(n, np.int64)
            if alive:
                share, rem = divmod(b_t, len(alive))
                for j, i in enumerate(alive):
                    b[i] = share + (1 if j < rem else 0)
        c0 = problem.clamp_events
        msgs = [problem.worker_grad(i, w_ref, int(b[i]),
                                    strict=batch_schedule is not None)
                for i in alive]
        trace.clamps.append(problem.clamp_events - c0)
        # an all-dead epoch applies an exact zero gradient (count 0)
        grad_sum = (_tree_sum([g for g, _ in msgs]) if msgs else
                    tree_map(torch.zeros_like, problem.params0))
        count = sum(c for _, c in msgs)
        g = anytime.normalize(
            grad_sum, torch.full((), count, dtype=torch.float32,
                                 device=problem.device))
        w_next, state = da.update(
            state, g, opt_cfg,
            tau=float(t - ref) if adaptive_alpha else None,
            b=None if b_t is None else float(b_t))
        params_versions[t + 1] = w_next
        # keep a tau_keep + 2 window: the deepest reference a draw reaches
        for old in list(params_versions):
            if old < t - tau_keep - 1:
                del params_versions[old]
        trace.times.append(tm.update_time(t, t_p, t_c))
        trace.epochs.append(t)
        trace.errors.append(problem.error(w_next))
        trace.minibatches.append(count)
        trace.staleness.append(t - ref)
        if batch_schedule is not None:
            # closed loop: the error is the signal adadamp damps
            # against, the applied staleness feeds delay_aware
            batch_schedule.observe(loss=trace.errors[-1],
                                   tau_obs=float(t - ref))
    trace.final_params = params_versions[max(params_versions)]
    return trace


# ---------------------------------------------------------------------------
# K-batch async (event-driven)
# ---------------------------------------------------------------------------
def simulate_kbatch(problem: SimProblem, *, b_per_msg: int,
                    K: Optional[int] = None, t_c: float,
                    total_time: float, timing: ShiftedExponential,
                    opt_cfg: AmbdgConfig, rng_seed: int = 0,
                    delay_process=None, worker_process=None,
                    t_p: Optional[float] = None,
                    batch_schedule=None) -> Trace:
    """Dutta et al.'s K-batch async: workers continuously compute
    fixed-size jobs (b_per_msg gradients); the master updates on every
    K-th arriving message (default ``opt_cfg.kbatch_K``); the staleness
    is random.

    ``delay_process``: a seeded ``core.delay_process`` instance
    jittering the per-message uplink: message m takes
    ``0.5 * tau_m * t_p`` seconds instead of ``0.5 * t_c`` (so it needs
    ``t_p``); the broadcast leg stays ``0.5 * t_c``. Draws happen in
    message-send order and land in ``trace.delays``.

    ``worker_process``: a seeded ``core.worker_process`` instance driving
    membership on the arrival heap, indexed by epoch (epoch e covers
    [e t_p, (e + 1) t_p), so it needs ``t_p``). A job that finishes
    while its worker is down is lost and restarts at the start of the
    worker's next active epoch; a job's duration divides by the speed
    of the epoch it starts in. Alive counts per epoch land in
    ``trace.active``.

    ``batch_schedule``: a seeded ``core.batch_schedule`` controller whose
    per-job target, drawn when the job is scheduled, replaces
    ``b_per_msg`` (a lost job restarts with its size). The master runs
    adaptive-b dual averaging (alpha from each triggering batch's total
    count), and after each update the controller observes the error and
    the mean staleness of the triggering messages. Targets land in
    ``trace.targets``."""
    K = K if K is not None else opt_cfg.kbatch_K
    if delay_process is not None and t_p is None:
        raise ValueError("delay_process needs t_p to convert epoch-"
                         "unit delays into uplink seconds")
    if worker_process is not None and t_p is None:
        raise ValueError("worker_process needs t_p to index its "
                         "per-epoch draws on the event clock")
    rng = np.random.default_rng(rng_seed)
    trace = Trace(scheme="kbatch")
    n = problem.n_workers
    strict = batch_schedule is not None

    master = KBatchMaster(problem.params0, opt_cfg, K, adaptive_b=strict)
    # worker i's current parameter version (epoch index) and the params
    worker_version = [1] * n
    params_versions = {1: problem.params0}
    # worker i's current job size: b_per_msg, or the schedule's target
    # drawn when the job was scheduled
    job_b = [b_per_msg] * n
    clamp_mark = problem.clamp_events

    # elastic membership: the seeded per-epoch (mask, speeds) sequence,
    # extended as event times reach new epochs
    epochs: List = []

    def epoch_state(e: int):
        while len(epochs) <= e:
            epochs.append(worker_process.step())
        return epochs[e]

    def next_active_epoch(worker: int, e: int) -> Optional[int]:
        horizon = int(total_time // t_p) + 2
        for e2 in range(e + 1, horizon + 1):
            if epoch_state(e2)[0][worker]:
                return e2
        return None

    def schedule_job(worker: int) -> None:
        """Draw (and record) the next job's size for ``worker``."""
        if batch_schedule is not None:
            job_b[worker] = int(batch_schedule.target())
            trace.targets.append(job_b[worker])

    def job_time(worker: int, at: float = 0.0) -> float:
        b_job = job_b[worker]
        if hasattr(timing, "per_worker_time"):
            base = timing.per_worker_time(worker, b_job)
        else:
            base = float(timing.time_for(rng, 1, b_job)[0])
        if worker_process is not None:
            speed = float(epoch_state(int(at // t_p))[1][worker])
            base = base / max(speed, 1e-12)
        return base

    # event heap: (time, seq, worker, kind); seq is unique, so the heap
    # never compares two kinds
    events: List = []
    seq = 0
    for i in range(n):
        schedule_job(i)
        heapq.heappush(events, (job_time(i), seq, i, "finish"))
        seq += 1

    while events:
        now, _, worker, kind = heapq.heappop(events)
        if now > total_time:
            break
        if kind == "finish":
            if worker_process is not None:
                e = int(now // t_p)
                if not epoch_state(e)[0][worker]:
                    # down at delivery: the job is lost and restarts at
                    # the start of the worker's next active epoch
                    e2 = next_active_epoch(worker, e)
                    if e2 is not None:
                        restart = e2 * t_p
                        heapq.heappush(events, (
                            restart + job_time(worker, restart), seq,
                            worker, "finish"))
                        seq += 1
                    continue
            ver = worker_version[worker]
            g, c = problem.worker_grad(worker, params_versions[ver],
                                       job_b[worker], strict=strict)
            # the worker id rides along: the master orders each
            # triggering batch by (ref_epoch, worker)
            msg = Message(grad_sum=g, count=c, ref_epoch=ver, worker=worker)
            if delay_process is not None:
                tau_m = delay_process.next()
                trace.delays.append(tau_m)
                uplink = 0.5 * tau_m * t_p
            else:
                uplink = 0.5 * t_c
            heapq.heappush(events, (now + uplink, seq, worker, ("msg", msg)))
            seq += 1
            # the worker starts its next job at once (a fresh size draw
            # under a schedule)
            schedule_job(worker)
            heapq.heappush(events, (now + job_time(worker, now), seq, worker,
                                    "finish"))
            seq += 1
        elif kind[0] == "msg":
            if master.receive(kind[1]):
                ver = master.update_count + 1
                params_versions[ver] = master.params
                trace.times.append(now)
                trace.epochs.append(master.update_count)
                trace.errors.append(problem.error(master.params))
                trace.clamps.append(problem.clamp_events - clamp_mark)
                clamp_mark = problem.clamp_events
                if batch_schedule is not None:
                    tail = master.staleness_log[-K:]
                    batch_schedule.observe(
                        loss=trace.errors[-1],
                        tau_obs=float(np.mean(tail)) if tail else None)
                # broadcast: the workers get it after T_c / 2
                for i in range(n):
                    heapq.heappush(events, (now + 0.5 * t_c, seq, i,
                                            ("recv", ver)))
                    seq += 1
        else:   # ("recv", version)
            worker_version[worker] = max(worker_version[worker], kind[1])
            # workers only move forward, and an in-flight version is never
            # older than its receiver's: drop what no worker can reach
            floor = min(worker_version)
            for old in list(params_versions):
                if old < floor:
                    del params_versions[old]

    trace.staleness = list(master.staleness_log)
    if worker_process is not None:
        trace.active = [int(a.sum()) for a, _ in epochs]
    trace.final_params = master.params
    return trace
