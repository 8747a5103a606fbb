#!/usr/bin/env python3
"""The CNN's f32 gradient on the card against an f64 one, under cuDNN's
default, deterministic and benchmark modes (TF32 off).

    python3 tools/cnn_grad_check.py      # from the repository root, on a card

At amb-cnn FULL's init weights (seed 0), on 128 images of
``ImageClassStream(32, 10, seed=1)``, prints each leaf's largest gap
to the f64 gradient (the CPU's f64 one), over the leaf's largest element,
for the CPU in f32, the card in f64, and the card in f32 in each mode,
with the 25 most frequent device kernels of each mode (the profiler).
"""
import collections
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.anytime import accumulate_scan  # noqa: E402
from repro_torch.core.arena import tree_flatten  # noqa: E402
from repro_torch.data.synthetic import ImageClassStream  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("cnn_grad_check: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("amb-cnn")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in
             ImageClassStream(32, 10, seed=1).next_batch(128).items()}
    names = sorted(params)

    def grads(device, dtype):
        p = {k: v.to(device, dtype) for k, v in params.items()}
        b = {k: v.to(device, dtype) if v.is_floating_point() else
             v.to(device) for k, v in batch.items()}
        g, _, _ = accumulate_scan(build_model(cfg, device=device).loss, p,
                                  b, 1)
        return [x.double().cpu() for x in tree_flatten(g)[0]]

    ref = grads("cpu", torch.float64)

    def gaps(g):
        return {n: float((a - r).abs().max() / r.abs().max())
                for n, a, r in zip(names, g, ref)}

    out = {"cpu_f32": gaps(grads("cpu", torch.float32)),
           "cuda_f64": gaps(grads("cuda", torch.float64))}
    for mode in ("default", "deterministic", "benchmark"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        torch.backends.cudnn.benchmark = mode == "benchmark"
        grads("cuda", torch.float32)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            g = grads("cuda", torch.float32)
            torch.cuda.synchronize()
        kernels = collections.Counter(
            e.name[:90] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        out[mode] = gaps(g)
        print(mode, "kernels:", json.dumps(dict(kernels.most_common(25))))
    for k, v in out.items():
        print(k, "max", max(v.values()),
              json.dumps({n: f"{x:.1e}" for n, x in v.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
