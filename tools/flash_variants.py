#!/usr/bin/env python3
"""Check and time the bf16 flash-attention kernels on the card, as the
source stands and for source variants: a tool for tuning them.

    python3 tools/flash_variants.py [--no-check] ['old=>new|||old=>new' ...]

Each argument is a variant of ``src/repro_torch/kernels/csrc/
flash_attention.cu``: string replacements, separated by ``|||``, applied
to the source (each ``old`` must occur). For the source and each
variant: build it (one ``nvcc``, the library named by the variant's
hash), print each Hopper kernel's registers and spills, hold the four
entries against their plain versions at small shapes (edges, GQA,
windows, ragged lengths; the element limit of ``chip_smoke.py``: one
bf16 ulp plus 1e-5 of the largest element; the source always, the
variants unless ``--no-check``, for ablations that drop work and so give
wrong outputs), then time the forward with lse, dq and dk/dv at the
main path's, qwen3-1.7b's and yi-6b's shapes with CUDA events (median
of 10, launch work included) beside ``scaled_dot_product_attention``.
Needs one CUDA card; exits non-zero when a check fails.
"""
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CASES = [   # B, Hq, Hkv, Sq, Skv, D, causal, window
    (1, 1, 1, 128, 128, 64, True, None),
    (1, 2, 2, 256, 256, 128, True, None),
    (2, 4, 2, 256, 512, 64, True, None),      # right-aligned queries
    (1, 2, 2, 256, 128, 64, True, None),      # rows with no valid key
    (1, 8, 2, 192, 192, 128, True, None),     # ragged GQA
    (1, 8, 2, 512, 512, 128, True, 200),      # window at D = 128
    (1, 4, 4, 320, 320, 64, True, 96),
    (1, 2, 2, 128, 256, 128, False, None),
    (1, 2, 2, 100, 70, 64, True, None),       # lengths not a multiple of 4
    (1, 2, 2, 70, 100, 128, False, 30),
    (1, 8, 2, 192, 192, 80, True, 96),        # D = 80: read as 128 columns
    (1, 4, 1, 200, 200, 256, True, None),     # D = 256: dk/dv in halves
]
TIMED = [("main", 2, 16, 16, 4096, 64), ("qwen3", 1, 16, 8, 4096, 128),
         ("yi", 1, 32, 4, 4096, 128)]


def event_ms(fn, n=10, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run(label, check):
    """Build, check and time the source in ``build.CSRC``; returns the
    number of failed cases."""
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa, ref
    log = build.build(["flash_attention"])["flash_attention"]
    print(f"== {label}", flush=True)
    name = None
    for line in log.splitlines():
        kernel = re.search(r"(flash_[a-z_]*_wgmma)I(\w*?)E+v", line)
        if "Function properties for" in line:
            name = f"{kernel[1]}<{kernel[2]}>" if kernel else None
        elif name and ("spill" in line or "registers" in line):
            print(f"   {name}: {line.strip()}")
        elif "(C75" in line:
            print(f"   {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    bad = 0
    for B, Hq, Hkv, Sq, Skv, D, causal, window in CASES if check else []:
        q, k, v = randn(B, Hq, Sq, D), randn(B, Hkv, Skv, D), \
            randn(B, Hkv, Skv, D)
        do = randn(B, Hq, Sq, D)
        kw = dict(causal=causal, window=window, scale=D ** -0.5)
        o, lse = fa.flash_fwd_lse(q, k, v, **kw)
        o_ref, lse_ref = ref.flash_fwd_lse_ref(q, k, v, **kw)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        bargs = (q, k, v, lse, delta, do)
        pairs = {
            "o": ((o,), (o_ref,)),
            "o without lse": ((fa.flash_attention_fwd(q, k, v, **kw),),
                              (o_ref,)),
            "dq": ((fa.flash_bwd_dq(*bargs, **kw),),
                   (ref.flash_bwd_dq_ref(*bargs, **kw),)),
            "dk, dv": (fa.flash_bwd_dkv(*bargs, **kw),
                       ref.flash_bwd_dkv_ref(*bargs, **kw)),
        }
        again = fa.flash_bwd_dkv(*bargs, **kw)
        ratios = {n: chip_smoke.flash_err(g, w, 2.0 ** -7)[0]
                  for n, (g, w) in pairs.items()}
        repeat = all(torch.equal(a, b)
                     for a, b in zip(again, pairs["dk, dv"][0]))
        ok = max(ratios.values()) <= 1.0 and repeat
        bad += not ok
        errs = ", ".join(f"{n} {r:.3f}" for n, r in ratios.items())
        print(f"   {'ok ' if ok else 'BAD'} "
              f"{(B, Hq, Hkv, Sq, Skv, D, causal, window)}: err/limit "
              f"{errs}; bitwise repeat {repeat}", flush=True)
    for label_, B, Hq, Hkv, S, D in TIMED:
        q, k, v = randn(B, Hq, S, D), randn(B, Hkv, S, D), \
            randn(B, Hkv, S, D)
        do = randn(B, Hq, S, D)
        kw = dict(causal=True, window=None, scale=D ** -0.5)
        o, lse = fa.flash_fwd_lse(q, k, v, **kw)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        bargs = (q, k, v, lse, delta, do)
        t = {"fwd_lse": event_ms(lambda: fa.flash_fwd_lse(q, k, v, **kw)),
             "dq": event_ms(lambda: fa.flash_bwd_dq(*bargs, **kw)),
             "dkv": event_ms(lambda: fa.flash_bwd_dkv(*bargs, **kw)),
             "sdpa_fwd": event_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, enable_gqa=Hq != Hkv))}
        print(f"   {label_} ms: " + ", ".join(f"{n} {x:.4f}"
                                             for n, x in t.items()),
              flush=True)
    return bad


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa
    check = "--no-check" not in argv
    specs = [a for a in argv if a != "--no-check"]
    bad = run("source", True)
    base = (build.CSRC / "flash_attention.cu").read_text()
    for spec in specs:
        src = base
        for edit in spec.split("|||"):
            old, new = edit.split("=>")
            if old not in src:
                raise SystemExit(f"not in the source: {old!r}")
            src = src.replace(old, new)
        tmp = Path(tempfile.mkdtemp())
        (tmp / "flash_attention.cu").write_text(src)
        build.CSRC = tmp
        build._LIBS.clear()
        for kernel in (fa.FWD, fa.FWD_LSE, fa.DQ, fa.DKV):
            kernel._cfn = None
        bad += run(spec, check)
        shutil.rmtree(tmp)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
