"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The twin of ``repro/launch/train.py``: the same flags and the same
``RunConfig`` (beyond JAX's flags ``--b-bar``, ``--pod-compression``,
``--proximal`` and ``--radius-c``, each defaulting to JAX's value), run
through the port's host loop (``train.loop``) for any registered
strategy (``--strategy ambdg|amb|kbatch|decentralized``) and
optimizer (``--optimizer dual_averaging|sgd|adam``). It prints one JSON
line per log point and a ``done:`` line. It runs on the card; only
``--device cpu`` runs it on the CPU (without CUDA the default raises).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 3
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
        --device cpu --steps 3

``main(argv)`` takes the argument list (tests and ``chip_smoke.py`` call
it in process) and returns the loop's output.

``--mesh PxDxM`` with P x D x M > 1 runs the sharded step over the
ranks ``torch.distributed.run`` starts (one process a rank; ``--backend``
nccl, the default on the card, or gloo, the CPU's and the default with
``--device cpu``); M > 1 runs the dense transformers tensor parallel
over ``model``; rank 0 alone prints and checkpoints:

    python -m torch.distributed.run --nproc-per-node=2 \
        -m repro_torch.launch.train --arch amb-linreg --mesh 2x1x1 ...
    python -m torch.distributed.run --nproc-per-node=2 \
        -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \
        --mesh 1x1x2 --device cpu ...

``--strategy decentralized`` under ``torch.distributed.run`` with as many
ranks as ``--n-workers`` runs one worker a rank (the per-rank gossip,
which ``gossip_impl="auto"`` picks in such a world); rank 0 alone
prints and checkpoints:

    python -m torch.distributed.run --nproc-per-node=4 \
        -m repro_torch.launch.train --arch amb-linreg --smoke \
        --strategy decentralized --n-workers 4 --device cpu ...

``main`` called in a process that has joined a world already runs in
it. The run a sharded one is held against, the same mesh's pods
stacked in one process, is ``train.loop.train(..., mesh=None)`` on
``run_config(parse_args(argv))``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import repro_torch.configs as C
from repro_torch.api import available_strategies
from repro_torch.configs.base import (AmbdgConfig, BatchScheduleConfig,
                                      ConsensusConfig, DelayConfig,
                                      ElasticConfig, RunConfig,
                                      SHAPES)
from repro_torch.core.batch_schedule import BATCH_SCHEDULES
from repro_torch.core.delay_process import DELAY_PROCESSES
from repro_torch.core.worker_process import WORKER_PROCESSES


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--strategy", default="ambdg",
                    choices=available_strategies(),
                    help="algorithm variant (Strategy registry)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--optimizer", default="dual_averaging")
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--t-p", type=float, default=2.5)
    ap.add_argument("--t-c", type=float, default=10.0)
    ap.add_argument("--n-microbatches", type=int, default=2)
    ap.add_argument("--b-bar", type=float, default=None,
                    help="the step size's b_bar (default: n_workers * "
                         "samples_per_worker)")
    ap.add_argument("--pod-compression", default="none",
                    choices=("none", "int8"),
                    help="the delay ring's cross-pod payload")
    ap.add_argument("--proximal", default="l2", choices=("l2", "l2_ball"))
    ap.add_argument("--radius-c", type=float, default=0.0,
                    help="the l2 ball's radius (--proximal l2_ball)")
    ap.add_argument("--delay-process", default="fixed",
                    choices=sorted(DELAY_PROCESSES),
                    help="staleness process of the master exchange: "
                         "'fixed' = the paper's constant tau; the "
                         "stochastic processes run the delay-tolerant "
                         "ring (ambdg only)")
    ap.add_argument("--tau-max", type=int, default=0,
                    help="staleness cap sizing the delay-tolerant ring "
                         "(0 = 2*tau for stochastic processes)")
    ap.add_argument("--delay-min", type=int, default=1)
    ap.add_argument("--delay-seed", type=int, default=0)
    ap.add_argument("--elastic-process", default="static",
                    choices=sorted(WORKER_PROCESSES),
                    help="elastic-worker process: 'static' = the "
                         "exact fixed-fleet path; 'heterogeneous' = "
                         "persistent speed skew; 'churn' = up/down "
                         "Gilbert-Elliott chain; 'crash_restart' = "
                         "exponential MTTF/MTTR")
    ap.add_argument("--churn-rate", type=float, default=0.05,
                    help="per-epoch failure probability "
                         "(ElasticConfig.p_fail, churn process)")
    ap.add_argument("--churn-recover", type=float, default=0.5,
                    help="per-epoch recovery probability "
                         "(ElasticConfig.p_recover, churn process)")
    ap.add_argument("--elastic-seed", type=int, default=0,
                    help="seed of the elastic worker process")
    ap.add_argument("--batch-schedule", default="fixed",
                    choices=sorted(BATCH_SCHEDULES),
                    help="adaptive minibatch schedule b(t): 'fixed' = "
                         "the exact timing-driven anytime path; "
                         "'linear' ramps, 'adadamp' grows as the loss "
                         "drops, 'delay_aware' scales with observed "
                         "staleness (alpha takes b(t) for b_bar)")
    ap.add_argument("--batch-b0", type=int, default=0,
                    help="schedule base target b(1) "
                         "(0 = round(b_bar) = n_workers * "
                         "samples_per_worker)")
    ap.add_argument("--batch-cap", type=int, default=0,
                    help="cap on scheduled targets (0 = 16 * b0)")
    ap.add_argument("--batch-growth", type=float, default=1.0,
                    help="linear schedule: +samples per step")
    ap.add_argument("--batch-schedule-seed", type=int, default=0,
                    help="seed of the batch-size controller")
    ap.add_argument("--fixed-alpha", action="store_true",
                    help="disable the Agarwal-Duchi delay-adaptive "
                         "step size (use the static worst-case tau)")
    ap.add_argument("--topology", default="ring",
                    help="decentralized gossip topology")
    ap.add_argument("--gossip-rounds", type=int, default=0,
                    help="decentralized: 0 derives eq. (24)'s bound")
    ap.add_argument("--gossip-compression", default="none",
                    choices=("none", "int8"),
                    help="decentralized: compress gossip messages to "
                         "int8 + per-row scales with error feedback")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default="1x1x1",
                    help="PxDxM: pods x data ranks a pod x model ranks "
                         "(M > 1: tensor parallelism, the dense "
                         "transformers); more than one rank runs under "
                         "torch.distributed.run")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend of a multi-rank mesh "
                         "(default: nccl on the card, gloo on the CPU)")
    ap.add_argument("--n-workers", type=int, default=4)
    ap.add_argument("--samples-per-worker", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without CUDA) or "
                         "'cpu'")
    return ap.parse_args(argv)


def run_config(args: argparse.Namespace) -> RunConfig:
    """The ``RunConfig`` JAX's launcher builds from the same flags."""
    model_cfg = (C.get_smoke_config(args.arch) if args.smoke
                 else C.get_config(args.arch))
    shape = SHAPES[args.shape]
    seq_len = args.seq_len
    if args.smoke and seq_len is None:
        seq_len = 128          # the reduced config's default length
    if seq_len or args.batch:
        shape = dataclasses.replace(
            shape, seq_len=seq_len or shape.seq_len,
            global_batch=args.batch or shape.global_batch)

    total = args.n_workers * args.samples_per_worker
    shape = dataclasses.replace(shape, global_batch=total)

    from repro_torch.launch.mesh import parse_mesh
    return RunConfig(
        model=model_cfg, shape=shape, mesh=parse_mesh(args.mesh),
        ambdg=AmbdgConfig(t_p=args.t_p, t_c=args.t_c, tau=args.tau,
                          n_microbatches=args.n_microbatches,
                          b_bar=float(args.b_bar or total),
                          pod_compression=args.pod_compression,
                          proximal=args.proximal, radius_C=args.radius_c),
        strategy=args.strategy,
        consensus=ConsensusConfig(topology=args.topology,
                                  n_workers=args.n_workers,
                                  rounds=args.gossip_rounds,
                                  compression=args.gossip_compression),
        delay=DelayConfig(
            process=args.delay_process,
            tau_max=args.tau_max or (2 * args.tau
                                     if args.delay_process != "fixed"
                                     else 0),
            delay_min=args.delay_min, seed=args.delay_seed,
            adaptive_alpha=not args.fixed_alpha),
        elastic=ElasticConfig(process=args.elastic_process,
                              p_fail=args.churn_rate,
                              p_recover=args.churn_recover,
                              seed=args.elastic_seed),
        batch_schedule=BatchScheduleConfig(
            schedule=args.batch_schedule, b0=args.batch_b0,
            b_cap=args.batch_cap, growth_rate=args.batch_growth,
            seed=args.batch_schedule_seed),
        optimizer=args.optimizer)


def _world_size() -> int:
    """The ranks of this process's world: the initialised group's, or
    the ``torch.distributed.run`` launch's (WORLD_SIZE), else 1."""
    import os

    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _init_world(args, device):
    """Join the ``torch.distributed.run`` world (its RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT), unless this process has joined one
    already. Returns (this rank's device, whether it joined here)."""
    import os

    import torch
    import torch.distributed as dist
    if "RANK" not in os.environ and not dist.is_initialized():
        raise RuntimeError(
            f"--mesh {args.mesh} spans more than one rank: start it under "
            "python -m torch.distributed.run")
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        # ranks beyond the cards share them (gloo only: NCCL refuses
        # two ranks on one device)
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device, False
    dist.init_process_group(backend, init_method="env://")
    return device, True


def main(argv=None):
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    args = parse_args(argv)
    device = resolve_device(args.device)
    rc = run_config(args)
    multi = rc.mesh.n_devices > 1
    # the per-rank gossip: one worker a rank of the launch's world
    world = _world_size()
    gossip = args.strategy == "decentralized" and not multi and world > 1
    if gossip and world != args.n_workers:
        raise ValueError(
            f"--strategy decentralized under torch.distributed.run runs "
            f"one worker a rank: --n-workers {args.n_workers} needs "
            f"{args.n_workers} ranks; the world has {world}")
    joined = False
    if multi or gossip:
        device, joined = _init_world(args, device)
    mesh = make_mesh(rc.mesh, device) if multi else None
    model = build_model(rc.model, device=device)
    loop = LoopConfig(n_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      n_workers=args.n_workers,
                      samples_per_worker=args.samples_per_worker)
    import torch.distributed as dist
    try:
        out = train(model, rc, loop, log_fn=lambda m: print(json.dumps(m)),
                    device=device, mesh=mesh)
        lead = not (multi or gossip) or dist.get_rank() == 0
    finally:
        if joined:
            dist.destroy_process_group()
    if lead:
        print(f"done: {len(out['history'])} log points, "
              f"final loss {out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
