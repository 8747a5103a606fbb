"""Quickstart of the PyTorch port: train a small LM with AMB-DG.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The public API end to end, as ``examples/quickstart.py`` shows it for
the JAX package: config -> model -> strategy (``repro_torch.api.build``:
anytime accumulation + delayed gradients + dual averaging for the
default "ambdg") -> steps. ``applied_count`` is 0 for the first tau steps
while the delay pipeline fills.
"""
import argparse
import dataclasses

import torch

import repro_torch.api as api
import repro_torch.configs as C
from repro_torch.configs.base import (AmbdgConfig, MeshConfig, RunConfig,
                                      TRAIN_4K)
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.api import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    args = ap.parse_args(argv)

    cfg = C.get_smoke_config("qwen3-1.7b")      # reduced same-family config
    model = build_model(cfg, device=args.device)
    rc = RunConfig(
        model=cfg,
        shape=dataclasses.replace(TRAIN_4K, seq_len=args.seq_len,
                                  global_batch=16),
        mesh=MeshConfig(n_pods=1, data=1, model=1),
        ambdg=AmbdgConfig(tau=2, n_microbatches=4, b_bar=16.0,
                          smoothness_L=8.0),
        strategy="ambdg",                       # the Strategy registry id
        optimizer="dual_averaging",             # the paper's workhorse
    )
    strategy = api.build(model, rc, device=args.device)
    state = strategy.init_state(torch.Generator().manual_seed(0))

    stream = TokenStream(cfg, seed=0)
    losses = []
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(args.device)
                 for k, v in stream.next_batch(16, args.seq_len).items()}
        state, metrics = strategy.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        tau_note = " (delay pipeline filling)" if i < rc.ambdg.tau else ""
        print(f"step {i + 1:2d} loss/token={losses[-1]:7.4f} "
              f"applied_count={float(metrics['applied_count']):5.0f}"
              f"{tau_note}")
    return losses


if __name__ == "__main__":
    main()
