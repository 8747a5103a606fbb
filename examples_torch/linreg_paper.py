"""The paper's Sec. VI-A linear-regression comparison (Fig. 2 + Fig. 3)
on the PyTorch port: AMB-DG vs AMB vs K-batch async under a long
communication delay, in the event-driven cluster simulator, with the
workers' gradients on the device.

    PYTHONPATH=src python examples_torch/linreg_paper.py [--dim 2048] \\
        [--device cpu]

Prints wall-clock error traces and the headline speedups (paper: ~3x
over AMB, ~1.5x over K-batch async), as ``examples/linreg_paper.py``.
"""
import argparse

import numpy as np

from repro_torch import api
from repro_torch.configs.base import LINREG, AmbdgConfig, ModelConfig
from repro_torch.data.timing import ShiftedExponential
from repro_torch.sim import SimProblem


def time_to(tr, tgt):
    for t, e in zip(tr.times, tr.errors):
        if e <= tgt:
            return t
    return float("inf")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=2048)
    ap.add_argument("--total-time", type=float, default=250.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="linreg", family=LINREG, n_layers=0, d_model=0,
                      n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
                      linreg_dim=args.dim)
    # paper constants: n=10, T_p=2.5, T_c=10 (tau=4), shifted-exp workers
    timing = ShiftedExponential(lam=2 / 3, xi=1.0, b=60)
    opt = AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                      b_bar=800.0, proximal="l2_ball",
                      radius_C=float(1.05 * np.sqrt(args.dim)))

    def problem():
        return SimProblem(cfg, 10, b_max=1024, device=args.device)

    runs = {}
    for name in ("ambdg", "amb"):
        runs[name] = api.simulate(
            name, problem(), t_p=2.5, t_c=10.0, total_time=args.total_time,
            timing=timing, opt_cfg=opt)
    runs["kbatch"] = api.simulate(
        "kbatch", problem(), b_per_msg=60, K=10, t_c=10.0,
        total_time=args.total_time, timing=timing, opt_cfg=opt)

    for name, tr in runs.items():
        head = " ".join(f"{e:.3f}" for e in tr.errors[:8])
        print(f"{name:7s} updates={len(tr.times):3d} errs: {head} ...")
    for tgt in (0.5, 0.35, 0.1):
        ts = {k: time_to(tr, tgt) for k, tr in runs.items()}
        print(f"time to err {tgt:4.2f}: "
              + "  ".join(f"{k}={v:6.1f}s" for k, v in ts.items())
              + f"   speedup vs AMB: {ts['amb'] / ts['ambdg']:.2f}x"
              + f", vs K-batch: {ts['kbatch'] / ts['ambdg']:.2f}x")
    st = np.array(runs["kbatch"].staleness)
    print(f"K-batch staleness: mean={st.mean():.2f} "
          f"p90={np.percentile(st, 90):.0f} | AMB-DG staleness: fixed "
          f"tau={runs['ambdg'].staleness[-1]}")
    return runs


if __name__ == "__main__":
    main()
