"""Host training loop of the port (``repro/train/loop.py``): fixed-time
(anytime) epochs for a registered strategy, with checkpoint/restart and
elastic workers. Each iteration:

  1. the data pipeline draws per-worker anytime counts b_i(t) (the
     shifted-exponential model) and emits the masked global batch
     (seeded numpy: the JAX loop sees the same batches);
  2. under an adaptive ``rc.batch_schedule`` the host draws this step's
     target b(t) (``Strategy.batch_schedule``), caps the anytime weights
     with it (``data.pipeline.apply_batch_target``) and ships it as
     ``batch["b_sched"]``;
  3. under an elastic ``rc.elastic`` process the host draws this epoch's
     (active, speeds) pair, heartbeats ``train.fault.WorkerHealth`` on
     the virtual epoch clock (``at=float(step)``), readmits workers the
     process brings back, folds the draw into the anytime weights, and
     on an eviction records a re-mesh plan and checkpoints at once; a
     strategy that reads the mask (``consumes_active_mask``: the
     decentralized gossip) gets it as ``batch["active"]``, (n,) f32;
  4. under a stochastic ``rc.delay`` the host draws this step's delay
     (``Strategy.delay_process``) into ``batch["delay"]``;
  5. the batch moves to the device and the strategy's step runs (AMB-DG:
     anytime accumulate -> delayed pod exchange -> dual averaging);
  6. with ``rc.serve.publish_period > 0``, every ``publish_period``
     master steps the served weights (``_served_params``) are published
     into the bounded-staleness ring (``serve.publisher``) at step
     ``step + 1``; ``train`` returns the publisher for an engine to
     attach;
  7. every ``ckpt_every`` steps the state and every host-side generator
     (pipeline, delay process, worker process, health, batch schedule)
     and the publisher go to ``ckpt_dir``; a run started on a directory
     that holds a checkpoint resumes from its latest, sample- and
     draw-exact.

Without an elastic process the loop builds no ``WorkerHealth``: the JAX
loop ticks a wall-clock tracker that nothing feeds, which masks every
worker once a run passes 30 s (ROADMAP C.2).

Under a multi-rank mesh (``train(..., mesh=make_mesh(rc.mesh))`` on
every rank of a ``torch.distributed.run`` world) the loop runs inside
the mesh, so the strategy takes its sharded step. Every rank draws the
global batch from the seed (each step's stream is one generator, so a
pod's rows cannot be drawn alone) and keeps its own block of it, cut by
the batch's spec (``dist.sharding``, over ('pod', 'data'): every
``model`` rank of a data rank holds the same block): the stacked run's
draws, split by pod and then by data rank, are exactly these. The metrics are global on
every rank; rank 0 alone logs. A checkpoint joins the ranks' shards on
rank 0's host (``checkpoint.save_sharded``: the checkpoint the single
process would write; at ``model > 1`` the parameters' model blocks too),
and a restart cuts each rank's shards from it on the host, so a
checkpoint restores at any mesh shape.

Under the decentralized strategy's per-rank gossip (one worker a rank of
a world of n_workers ranks, ``gossip_impl`` "shard_map" or an "auto"
that resolves to it) every rank draws the global batch likewise and
keeps worker i's block (``dist.sharding.gossip_specs``); the elastic
mask and the batch target arrive whole. The checkpoint joins the
workers' slices of params, z and residual on rank 0's host along the
worker axis: the dense run's checkpoint, in the same format. Rank 0
alone logs. The publication channel (``rc.serve.publish_period``) is not
carried there: the sharded publish ring is ROADMAP A.11 part 2, item 7.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import LM_FAMILIES, RunConfig
from repro_torch.core.arena import tree_map
from repro_torch.data.pipeline import AnytimePipeline, apply_batch_target
from repro_torch.data.timing import ShiftedExponential
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import WorkerHealth, fold_anytime_weights


@dataclasses.dataclass
class LoopConfig:
    n_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    n_workers: int = 8                  # logical anytime workers
    samples_per_worker: int = 8
    use_timing_model: bool = True
    # elastic mode: consecutive dead epochs before a worker is evicted
    # (eviction -> re-mesh plan -> immediate checkpoint; the worker is
    # readmitted when the elastic process brings it back)
    eviction_misses: int = 3


def _served_params(state, strategy_name: str):
    """The parameter tree (w = -alpha z) the publication channel
    snapshots, whatever the strategy's state: ambdg and amb carry it as
    ``state.params``, kbatch wraps the base state, decentralized stacks
    the workers' copies and serves worker 0's (after the gossip they
    agree up to the consensus error)."""
    if hasattr(state, "base"):
        state = state.base
    params = state.params
    if strategy_name == "decentralized":
        params = tree_map(lambda a: a[0], params)
    return params


def _rank_batch(host: Dict[str, np.ndarray], mesh, coords,
                total: int) -> Dict[str, np.ndarray]:
    """This rank's block of the global batch, cut as ``dist.sharding``
    lays a batch out: a per-sample leaf (leading dim ``total``) on its
    "batch" axis over ('pod', 'data'), so the rank at (p, d) holds block
    p * D + d, its share of its pod's microbatches; a per-pod
    ``n_active`` on "pod"; the scalars whole."""
    from repro_torch.dist.sharding import dim_shard, local_shard, spec_for
    out = {}
    for k, v in host.items():
        if k == "n_active" and v.shape == (mesh.n_pods,):
            axes, n = ("pod",), mesh.n_pods
        elif v.ndim and v.shape[0] == total:
            axes, n = ("batch",) + (None,) * (v.ndim - 1), \
                mesh.n_pods * mesh.data
        else:
            out[k] = v
            continue
        spec = spec_for(axes, v.shape, mesh)
        if dim_shard(spec[0] if spec else None, mesh) != n:
            raise ValueError(f"the batch's {k!r} of shape {v.shape} does "
                             f"not split into {n} blocks over the mesh")
        out[k] = local_shard(torch.from_numpy(v), spec,
                             mesh, coords).numpy()
    return out


def _worker_batch(host: Dict[str, np.ndarray], workers,
                  total: int) -> Dict[str, np.ndarray]:
    """Worker i's block of the global batch on the per-rank gossip: the
    per-sample leaves (leading dim ``total``) and a per-worker
    ``n_active`` cut on the worker axis (``gossip_specs``' spec); the
    elastic mask, the batch target and the scalars whole."""
    from repro_torch.dist.sharding import gossip_specs, local_shard
    spec, sizes = gossip_specs().scalar, workers.sizes
    out = {}
    for k, v in host.items():
        if k in ("active", "b_sched") or not v.ndim or \
                v.shape[0] != (workers.n if k == "n_active" else total):
            out[k] = v
            continue
        out[k] = local_shard(torch.from_numpy(v), spec, sizes,
                             workers.coords).numpy()
    return out


def train(model: Model, rc: RunConfig, loop: LoopConfig,
          log_fn: Callable[[Dict], None] = None, device="cuda",
          mesh=None) -> Dict:
    """Run ``rc.strategy`` on ``device`` up to step ``loop.n_steps``
    (from the latest checkpoint in ``loop.ckpt_dir`` if it holds one).
    Returns {"state", "history", "b_history", "remesh_events",
    "publisher"} (the publisher None unless ``rc.serve.publish_period``):
    ``history`` holds the metrics (as floats) every ``log_every`` steps
    and at the last step, with host-clock seconds: ``wall_s`` since the
    loop began, and for that step ``batch_s`` (the host batch), ``h2d_s``
    (its copy to the device) and ``step_s`` (the step, up to its metrics
    read back); ``active_workers`` under an elastic process and
    ``b_target`` (the drawn target) under a batch schedule. The split
    is exact where every step is logged (``log_every=1``): otherwise a
    step's device work can finish inside the next one's.

    Under an adaptive batch schedule the controller observes each step's
    loss (and ``tau_applied``): one read back to the host a step, the
    same one the JAX loop makes (``float(metrics["loss"])``).

    ``mesh``, a ``launch.mesh.Mesh`` over more than one rank: the run
    takes the sharded step on this rank's pod and rows (see the module's
    docstring)."""
    if mesh is None or mesh.device_mesh is None:
        return _train(model, rc, loop, log_fn, device, None)
    from repro_torch.dist.collectives import require_mesh
    with mesh:
        return _train(model, rc, loop, log_fn, device,
                      require_mesh("train"))


def _train(model: Model, rc: RunConfig, loop: LoopConfig,
           log_fn: Callable[[Dict], None], device, ranks) -> Dict:
    """The loop body of ``train``: ``ranks`` (``dist.collectives.Ranks``)
    under a multi-rank mesh, else None."""
    from repro_torch import api
    device = resolve_device(device)
    strategy = api.build(model, rc, device=device)
    # the per-rank gossip's worker group (None elsewhere)
    workers = getattr(strategy, "workers", None)
    if ranks is not None and rc.mesh.model > 1 and \
            rc.serve.publish_period > 0:
        raise NotImplementedError(
            "rc.serve.publish_period > 0 on a mesh with model > 1: the "
            "publication of model-sharded weights is the sharded publish "
            "ring, ROADMAP A.11 part 2, item 7")
    if workers is not None and rc.serve.publish_period > 0:
        raise NotImplementedError(
            "rc.serve.publish_period > 0 on the per-rank gossip: the "
            "sharded publish ring is ROADMAP A.11 part 2, item 7")
    pipeline = AnytimePipeline(
        cfg=rc.model, n_workers=loop.n_workers,
        samples_per_worker=loop.samples_per_worker,
        seq_len=rc.shape.seq_len if rc.model.family in LM_FAMILIES else 0,
        seed=rc.seed,
        timing=ShiftedExponential() if loop.use_timing_model else None,
        t_p=rc.ambdg.t_p)

    # the host owns the seeded processes: one delay draw per step
    # (ambdg has the master delay ring; amb refuses a stochastic one,
    # kbatch strips it), one batch target, one elastic draw
    delay_proc = strategy.delay_process() if rc.strategy == "ambdg" else None
    batch_sched = strategy.batch_schedule()
    elastic_proc = strategy.worker_process(loop.n_workers)
    wants_active = strategy.consumes_active_mask
    if wants_active and loop.n_workers != rc.consensus.n_workers:
        raise ValueError(
            f"the elastic mask is drawn for loop.n_workers="
            f"{loop.n_workers} workers but the gossip runs "
            f"rc.consensus.n_workers={rc.consensus.n_workers}: set them "
            "equal")
    # liveness on the virtual epoch clock: a missed epoch is a missed
    # heartbeat (none without an elastic process, ROADMAP C.2)
    health = (WorkerHealth(loop.n_workers, heartbeat_timeout=0.5,
                           eviction_misses=loop.eviction_misses, t0=0.0)
              if elastic_proc is not None else None)

    # train-while-serve: every publish_period master updates the served
    # w = -alpha z goes into the bounded-staleness ring (serve.publisher),
    # laid out from the params' shapes on the meta device
    publisher = None
    if rc.serve.publish_period > 0:
        from repro_torch.core.arena import make_layout
        from repro_torch.serve.publisher import WeightPublisher
        publisher = WeightPublisher(make_layout(model.param_shapes()),
                                    rc.serve, device=device)

    # a CPU generator: the model's weights are drawn on the host, so the
    # card and the CPU start from the same ones
    generator = torch.Generator().manual_seed(rc.seed)
    state = strategy.init_state(generator)
    start_step = 0
    lead = (ranks is None and workers is None) or dist.get_rank() == 0
    shard = None
    if workers is not None:
        shard = (strategy.shard_specs(state), workers.sizes, workers.coords)
    elif ranks is not None:
        # the leaves a rank holds shards of, for the checkpoints
        from repro_torch.core.ambdg import shard_specs
        from repro_torch.core.arena import make_layout
        shard = (shard_specs(make_layout(model.whole_param_shapes()), state,
                             rc.mesh, model), rc.mesh, ranks.coords)
    if loop.ckpt_dir and ckpt.latest_step(loop.ckpt_dir) is not None:
        state, extra = ckpt.restore(loop.ckpt_dir, state, shard=shard)
        pipeline.load_state_dict(extra["pipeline"])
        if delay_proc is not None and "delay_process" in extra:
            delay_proc.load_state_dict(extra["delay_process"])
        if elastic_proc is not None and "elastic_process" in extra:
            elastic_proc.load_state_dict(extra["elastic_process"])
            if "health" in extra:
                health.load_state_dict(extra["health"])
        if publisher is not None and "publisher" in extra:
            publisher.load_state_dict(extra["publisher"])
        if batch_sched is not None and "batch_schedule" in extra:
            batch_sched.load_state_dict(extra["batch_schedule"])
        start_step = extra["step"]

    def save_ckpt(next_step: int, plan=None):
        extra = {"step": next_step, "pipeline": pipeline.state_dict()}
        if delay_proc is not None:
            extra["delay_process"] = delay_proc.state_dict()
        if elastic_proc is not None:
            extra["elastic_process"] = elastic_proc.state_dict()
            extra["health"] = health.state_dict()
        if publisher is not None:
            extra["publisher"] = publisher.state_dict()
        if batch_sched is not None:
            extra["batch_schedule"] = batch_sched.state_dict()
        if plan is not None:
            extra["remesh_plan"] = plan
        if shard is None:
            ckpt.save(loop.ckpt_dir, next_step, state, extra=extra)
        else:
            ckpt.save_sharded(loop.ckpt_dir, next_step, state, shard[0],
                              shard[1], workers or ranks, extra=extra)

    history, remesh_events = [], []
    t_start = time.monotonic()
    for step in range(start_step, loop.n_steps):
        t0 = time.monotonic()
        host = pipeline.next_global_batch()
        b_target = None
        if batch_sched is not None:
            b_target = batch_sched.target()
            host["weights"] = apply_batch_target(
                host["weights"], b_target, loop.n_workers,
                loop.samples_per_worker)
        remesh_plan = None
        if elastic_proc is not None:
            active, speeds = elastic_proc.step()
            at = float(step)
            for i in np.flatnonzero(active):
                if int(i) in health.evicted:
                    # the process brought an evicted worker back
                    health.readmit(int(i), at=at)
                    remesh_events.append({"step": step, "event": "readmit",
                                          "worker": int(i)})
                health.heartbeat(int(i), at=at)
            before = set(health.evicted)
            health.tick(at=at)
            newly_evicted = sorted(health.evicted - before)
            host["weights"] = fold_anytime_weights(
                host["weights"], active, speeds, loop.n_workers,
                loop.samples_per_worker)
            if wants_active:
                host["active"] = active.astype(np.float32)
            if newly_evicted:
                # persistent failure: a re-mesh plan and a checkpoint as
                # soon as this step commits
                remesh_plan = health.rescale_plan()
                remesh_plan["evicted"] = sorted(health.evicted)
                remesh_events.append({"step": step, "event": "evict",
                                      "workers": newly_evicted,
                                      "plan": remesh_plan})
        if delay_proc is not None:
            host["delay"] = np.asarray(delay_proc.next(), np.int32)
        if b_target is not None:
            host["b_sched"] = np.asarray(b_target, np.float32)
        if ranks is not None:
            host = _rank_batch(host, rc.mesh, ranks.coords,
                               loop.n_workers * loop.samples_per_worker)
        elif workers is not None:
            host = _worker_batch(host, workers,
                                 loop.n_workers * loop.samples_per_worker)
        t1 = time.monotonic()
        # a copy from pageable host memory returns once it has landed
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        t2 = time.monotonic()
        state, metrics = strategy.train_step(state, batch)
        if batch_sched is not None:
            # closed loop: the loss damps adadamp, the observed
            # staleness feeds delay_aware (reads the step back)
            batch_sched.observe(
                loss=float(metrics["loss"]),
                tau_obs=(float(metrics["tau_applied"])
                         if "tau_applied" in metrics else None))
        if publisher is not None and \
                (step + 1) % rc.serve.publish_period == 0:
            publisher.publish(_served_params(state, rc.strategy), step + 1)
        if (step + 1) % loop.log_every == 0 or step == loop.n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}  # waits on the step
            t3 = time.monotonic()
            m.update(wall_s=t3 - t_start, batch_s=t1 - t0, h2d_s=t2 - t1,
                     step_s=t3 - t2)
            if elastic_proc is not None:
                m["active_workers"] = float(active.sum())
            if b_target is not None:
                m["b_target"] = float(b_target)
            history.append(m)
            if log_fn and lead:
                log_fn(m)
        if loop.ckpt_dir and ((step + 1) % loop.ckpt_every == 0
                              or remesh_plan is not None):
            save_ckpt(step + 1, plan=remesh_plan)
    return {"state": state, "history": history,
            "b_history": pipeline.b_history,
            "remesh_events": remesh_events, "publisher": publisher}
