"""Decentralized AMB-DG (paper Sec. V) on the PyTorch port: no master,
the workers gossip z + g over a topology and each applies its own
dual-averaging update, through the Strategy API.

    PYTHONPATH=src python examples_torch/decentralized.py \\
        [--topology ring] [--device cpu]

Shows the gossip matrix's spectral gap, the eq.-(24) round bound
computed from the config, and that the decentralized strategy (the
workers' duals in arena layout, the dense gossip fold on one device)
converges with the consensus error below delta, as
``examples/decentralized.py``.
"""
import argparse
import dataclasses

import numpy as np
import torch

import repro_torch.api as api
from repro_torch.configs.base import (LINREG, AmbdgConfig, ConsensusConfig,
                                      MeshConfig, ModelConfig, RunConfig,
                                      TRAIN_4K)
from repro_torch.data.synthetic import make_stream
from repro_torch.models.api import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--topology", default="ring",
                    choices=("ring", "torus", "complete"))
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--compression", default="none",
                    choices=("none", "int8"),
                    help="int8: per-row scales + error feedback")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n, d = args.workers, 256
    cfg = ModelConfig(name="linreg", family=LINREG, n_layers=0, d_model=0,
                      n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
                      linreg_dim=d)
    model = build_model(cfg, device=args.device)
    batch_size = 32 * n
    rc = RunConfig(
        model=cfg,
        shape=dataclasses.replace(TRAIN_4K, seq_len=0,
                                  global_batch=batch_size),
        mesh=MeshConfig(n_pods=1, data=1, model=1),
        ambdg=AmbdgConfig(tau=1, n_microbatches=2, smoothness_L=1.0,
                          b_bar=float(batch_size), proximal="l2_ball",
                          radius_C=float(1.1 * np.sqrt(d))),
        strategy="decentralized",
        consensus=ConsensusConfig(topology=args.topology, n_workers=n,
                                  delta=0.05, msg_norm_J=1.0,
                                  compression=args.compression))

    strategy = api.build(model, rc, device=args.device)
    print(f"{args.topology} Q: lambda2={strategy.lam2:.4f}; "
          f"eq.(24) rounds for delta={rc.consensus.delta}: "
          f"r={strategy.rounds}")
    print(f"gossip impl: {strategy.gossip_impl}; schedule: "
          f"{strategy.staleness_schedule().kind}; compression: "
          f"{args.compression}; arena rows a worker: "
          f"{strategy.layout.rows}")

    state = strategy.init_state(torch.Generator().manual_seed(rc.seed))
    stream = make_stream(cfg, seed=0, sample_seed=100)   # fixed w_star
    errs = []
    for epoch in range(1, args.epochs + 1):
        batch = {k: torch.from_numpy(v).to(args.device)
                 for k, v in stream.next_batch(batch_size).items()}
        state, m = strategy.train_step(state, batch)
        if epoch % 10 == 0:
            # paper eq. (28): mean over workers of ||w_i - w*||^2 /
            # ||w*||^2 (every worker holds its own parameters)
            w = state.params["w"].cpu().numpy()          # (n, d)
            errs.append(float(np.mean(np.sum((w - stream.w_star) ** 2, -1)
                                      / np.sum(stream.w_star ** 2))))
            print(f"epoch {epoch:3d}: mean err={errs[-1]:.4f} "
                  f"consensus err={float(m['consensus_error']):.5f} "
                  f"(delta={rc.consensus.delta})")
    return errs


if __name__ == "__main__":
    errs = main()
    assert errs[-1] < 0.05, "decentralized AMB-DG failed to converge"
    print("converged; consensus error stayed bounded")
