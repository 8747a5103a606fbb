#!/usr/bin/env python3
"""Drive the PyTorch port of AMB-DG on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and the script exits non-zero):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all started together) and print the time;
  2. hold each kernel against its plain PyTorch version on the card,
     bitwise, at the slice's arena (256 rows, one pod) and at an arena
     the size of qwen1.5-0.5b's 463,987,712 parameters (3,624,960 rows;
     one pod, and two for the ring rotate); time both over 25 launches
     after warm-up (device time from ``torch.profiler``, which must see
     the kernels; CUDA events around each call, host launch work
     included, beside it) against the least time the card could take
     (bytes moved at 3.35 TB/s; flops at 67 TFLOP/s f32);
  3. the main path: ``repro_torch.train.loop.train`` of ``amb-linreg``
     FULL (d = 10^4, the paper's Sec. VI-A setting: 10 workers x 150
     samples, tau = 4, l2-ball prox), 12 steps with pod compression int8
     and again with none, on the card and then on the CPU from the same
     seed. The kernels' launch counts, zeroed just before each run on
     the card and read just after, must equal the steps run; the two
     devices must agree (tolerances below). Where a step's time goes
     comes from the same run on the card: ``train``'s per-step host
     batch, copy and step times, and the card's kernel time over the
     run (profiler).

The last lines are the ``{"kernels": [...]}`` record, the card's name
and power limit from ``nvidia-smi``, and ``{"ok": true, ...}``. Without
CUDA, or without the repository's ``src/repro_torch`` beside it, the
script fails before printing any result.
"""
import collections
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
QWEN_0P5B_PARAMS = 463_987_712  # repro.configs qwen1.5-0.5b n_params()
N_TIMED = 25
MAIN_STEPS = 12


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n=N_TIMED, warmup=3):
    """Median milliseconds of ``fn()`` on the card over ``n`` calls, each
    bracketed by CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` (CUPTI); returns (its
    result, the device kernels recorded: a list of (name, microseconds)).
    Raises when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not sum(us for _, us in kernels):
        raise RuntimeError("torch.profiler recorded no device time")
    return out, kernels


def device_ms(fn, n=N_TIMED, warmup=3, match=None):
    """Device time of ``fn()`` from the profiler over ``n`` calls after
    ``warmup``: with ``match``, the median duration of the kernels whose
    name contains it (one per call); without, the summed duration of all
    kernels divided by ``n``. Host time between launches is not counted.
    Also returns the kernels' names and counts. Raises when no kernel
    matches."""
    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(n):
            fn()

    _, kernels = profiled(calls)
    kernels = [(k, us) for k, us in kernels if match is None or match in k]
    if len(kernels) < n:
        raise RuntimeError(f"the profiler saw {len(kernels)} kernels "
                           f"matching {match!r} in {n} calls")
    us = [us for _, us in kernels]
    names = dict(collections.Counter(k for k, _ in kernels))
    if match is None:
        return sum(us) / n / 1e3, names
    return statistics.median(us) / 1e3, names


def timed(kernel_fn, plain_fn, symbol):
    """Times of a kernel (``symbol``: its name in ``csrc``) and its plain
    version. ``ms``: the median device time of the kernel's launches;
    ``plain_ms``: the device time of all the plain version's kernels per
    call (both from the profiler); ``wrapper_ms``/``plain_wrapper_ms``:
    median CUDA-event time around each call, host launch work included."""
    ms, names = device_ms(kernel_fn, match=symbol)
    plain, plain_names = device_ms(plain_fn)
    return dict(ms=ms, plain_ms=plain, kernels=names,
                plain_kernels=plain_names, wrapper_ms=cuda_ms(kernel_fn),
                plain_wrapper_ms=cuda_ms(plain_fn))


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_flops = n_flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                         else "operations")


def max_abs_err(got, want):
    import torch
    return max(0.0 if torch.equal(a, b) else
               float((a.to(torch.float32) - b.to(torch.float32)).abs().max())
               for a, b in zip(got, want))


def check_dual_update(rows, gen):
    """Kernel vs plain version on one (rows, 128) arena; returns a dict
    of the comparison and the times."""
    import torch
    from repro_torch.kernels.dual_update.ops import dual_update_arena
    from repro_torch.kernels.dual_update.ref import dual_update_fused_ref
    dev = torch.device("cuda")
    z = torch.randn((rows, 128), generator=gen, device=dev)
    g = torch.randn((rows, 128), generator=gen, device=dev) * 300
    count = torch.full((), 1377.0, device=dev)
    alpha = torch.full((), 1.0 / (1.0 + math.sqrt(11 / 800)), device=dev)
    zk, wk = dual_update_arena(z.clone(), g, count, alpha, impl="kernel")
    zr, wr = dual_update_arena(z.clone(), g, count, alpha, impl="ref")
    torch.cuda.synchronize()
    equal = torch.equal(zk, zr) and torch.equal(wk, wr)
    err = max_abs_err((zk, wk), (zr, wr))
    del zk, wk, zr, wr
    denom = torch.clamp(count, min=1e-12)
    times = timed(
        lambda: dual_update_arena(z, g, count, alpha, impl="kernel"),
        lambda: dual_update_fused_ref(z, g, denom, alpha),
        "dual_update_fused_kernel")
    n = rows * 128
    b_ms, by = bound_ms(16 * n + 8, 3 * n)
    return dict(rows=rows, pods=1, bitwise=equal, max_abs_err=err,
                bound_ms=b_ms, bound_by=by, **times)


def check_rotate(n_pods, rows, gen):
    """Kernel vs plain version of the int8 slot rotate on (n_pods, rows,
    128) slots; fed puts some values exactly on half-way points and
    some past the clip."""
    import torch
    from repro_torch.kernels.delay_ring.ops import ring_slot_rotate_int8
    from repro_torch.kernels.delay_ring.ref import ring_slot_rotate_int8_ref
    dev = torch.device("cuda")
    shape = (n_pods, rows, 128)
    slot_pop = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    scales_pop = torch.rand(shape[:2], generator=gen, device=dev) + 1e-3
    scale_new = torch.rand(shape[:2], generator=gen, device=dev) + 1e-3
    fed = torch.randn(shape, generator=gen, device=dev)
    scale_new[:, :64] = 2.0 ** -6          # fed / s exact on these rows
    k = torch.randint(-140, 140, (n_pods, 64, 128), generator=gen,
                      device=dev)
    fed[:, :64] = (k + 0.5) * 2.0 ** -6    # ties, and values past +-127
    slot_push = torch.zeros(shape, dtype=torch.int8, device=dev)
    scales_push = torch.zeros(shape[:2], device=dev)

    def run(impl):
        return ring_slot_rotate_int8(slot_pop, scales_pop, slot_push.clone(),
                                     scales_push.clone(), fed.clone(),
                                     scale_new, impl=impl)

    got = run("kernel")
    want = run("ref")
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max_abs_err(got, want)
    del got, want
    times = timed(
        lambda: ring_slot_rotate_int8(slot_pop, scales_pop, slot_push,
                                      scales_push, fed, scale_new,
                                      impl="kernel"),
        lambda: ring_slot_rotate_int8_ref(slot_pop, scales_pop, fed,
                                          scale_new),
        "slot_rotate_int8_kernel")
    n = n_pods * rows * 128
    b_ms, by = bound_ms(14 * n + 12 * n_pods * rows, 7 * n)
    return dict(rows=rows, pods=n_pods, bitwise=equal, max_abs_err=err,
                bound_ms=b_ms, bound_by=by, **times)


def main_path_config(cfg=None):
    """The paper's linear regression at full width (Sec. VI-A), as
    ``examples/linreg_paper.py`` sets it up: (model config, compression
    -> RunConfig)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (AmbdgConfig, MeshConfig,
                                          RunConfig, TRAIN_4K)
    cfg = cfg or get_config("amb-linreg")
    d = cfg.linreg_dim

    def rc(compression):
        return RunConfig(
            model=cfg, shape=TRAIN_4K,
            mesh=MeshConfig(n_pods=1, data=1, model=1),
            ambdg=AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                              b_bar=800.0, proximal="l2_ball",
                              radius_C=1.05 * math.sqrt(d),
                              pod_compression=compression))
    return cfg, rc


def run_main_path(compression, device, cfg=None):
    """One ``train`` run of the main path; returns (result, seconds)."""
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    cfg, rc = main_path_config(cfg)
    loop = LoopConfig(n_steps=MAIN_STEPS, n_workers=10,
                      samples_per_worker=150, use_timing_model=True,
                      log_every=1)
    t0 = time.perf_counter()
    out = train(build_model(cfg, device=device), rc(compression), loop,
                device=device)
    return out, time.perf_counter() - t0


def compare_devices(compression, gpu, cpu, tau):
    """GPU vs CPU run of the same seed. applied_count is exact; loss and
    grad_norm agree to rtol 1e-4 (the f32 products sum their 10^4-term
    dot products in another order on each device, which moves the last
    bits); w to 1e-4 of its largest element, plus one quantization step
    (alpha * scale / count) under int8, where a last-bit difference can
    flip one rounding."""
    import numpy as np
    import torch
    hg, hc = gpu["history"], cpu["history"]
    assert len(hg) == len(hc) == MAIN_STEPS, (len(hg), len(hc))
    for t, (a, b) in enumerate(zip(hg, hc)):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        if t < tau:
            assert a["applied_count"] == 0.0, (t, a)
        else:
            assert a["applied_count"] > 0.0, (t, a)
        for key in ("loss", "grad_norm"):
            assert math.isfinite(a[key]), (t, key, a)
            assert math.isclose(a[key], b[key], rel_tol=1e-4,
                                abs_tol=1e-30), (t, key, a[key], b[key])
    wg = gpu["state"].params["w"].cpu().numpy()
    wc = cpu["state"].params["w"].numpy()
    assert wg.shape == wc.shape == (gpu["state"].params["w"].numel(),)
    assert np.all(np.isfinite(wg))
    tol = 1e-4 * float(np.abs(wc).max())
    if compression == "int8":
        ar = cpu["state"].arena
        step = max(float(s.max()) for s in ar.scales) / min(
            h["applied_count"] for h in hc[tau:])
        tol += step          # alpha < 1
    diff = float(np.abs(wg - wc).max())
    assert diff <= tol, (compression, diff, tol)
    # the run learns: the loss falls once the delayed updates land
    assert hg[-1]["loss"] < hg[0]["loss"], (hg[0]["loss"], hg[-1]["loss"])
    return diff, tol


def step_split(out, kernels):
    """Where a main-path step's time goes, from that run's own history
    (every step logged): medians over the steps after the first of the
    host batch, its copy to the card and the step up to its metrics read
    back (host clock). From ``kernels``, the profiler's record of the
    whole run (state set-up included): the card's kernel time and its
    copy time (memcpy/memset) per step, and the share of the run's wall
    time in which no kernel ran (the device's idle share)."""
    hist = out["history"][1:]
    med = {k: statistics.median(h[k] for h in hist) * 1e3
           for k in ("batch_s", "h2d_s", "step_s")}
    copy_ms = sum(us for k, us in kernels
                  if k.startswith(("Memcpy", "Memset"))) / 1e3
    kernel_ms = sum(us for _, us in kernels) / 1e3 - copy_ms
    wall_ms = out["history"][-1]["wall_s"] * 1e3
    return dict(host_batch_ms=med["batch_s"], h2d_ms=med["h2d_s"],
                device_step_ms=med["step_s"], step_ms=sum(med.values()),
                device_kernel_ms=kernel_ms / MAIN_STEPS,
                device_copy_ms=copy_ms / MAIN_STEPS,
                device_idle_share=1.0 - kernel_ms / wall_ms,
                steps=len(hist))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)
    from repro_torch.kernels import build
    from repro_torch.kernels.delay_ring import kernel as ring_kernel
    from repro_torch.kernels.dual_update import kernel as update_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- 2. kernels against their plain versions ---------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    big_rows = -(-(-(-QWEN_0P5B_PARAMS // 128)) // 256) * 256
    results = {"dual_update": [], "slot_rotate": []}
    for rows in (256, big_rows):
        results["dual_update"].append(check_dual_update(rows, gen))
        torch.cuda.empty_cache()
    for pods, rows in ((1, 256), (1, big_rows), (2, big_rows)):
        results["slot_rotate"].append(check_rotate(pods, rows, gen))
        torch.cuda.empty_cache()
    for name, rs in results.items():
        for r in rs:
            log(f"phase 2: {name} P={r['pods']} rows={r['rows']}: bitwise="
                f"{r['bitwise']} ms={r['ms']:.5f} plain_ms="
                f"{r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
                f"wrapper_ms={r['wrapper_ms']:.5f} plain_wrapper_ms="
                f"{r['plain_wrapper_ms']:.5f} (profiler: kernel "
                f"launches {sum(r['kernels'].values())}, plain "
                f"version {sum(r['plain_kernels'].values())} "
                f"kernels, over {N_TIMED} calls)")
            assert r["bitwise"] and r["max_abs_err"] == 0.0, (name, r)

    # -- 3. the main path ---------------------------------------------------
    tau = 4
    launches = {"dual_update": 0, "slot_rotate": 0}
    main = {}
    for compression in ("int8", "none"):
        update_kernel.KERNEL.launches = 0
        ring_kernel.KERNEL.launches = 0
        (gpu, secs), kernels = profiled(
            lambda: run_main_path(compression, "cuda"))
        n_update = update_kernel.KERNEL.launches
        n_rotate = ring_kernel.KERNEL.launches
        want_rotate = MAIN_STEPS if compression == "int8" else 0
        assert n_update == MAIN_STEPS, (compression, n_update)
        assert n_rotate == want_rotate, (compression, n_rotate)
        launches["dual_update"] += n_update
        launches["slot_rotate"] += n_rotate
        cpu, cpu_secs = run_main_path(compression, "cpu")
        diff, tol = compare_devices(compression, gpu, cpu, tau)
        main[compression] = dict(
            gpu_s=secs, cpu_s=cpu_secs, w_max_diff=diff, w_tol=tol,
            loss_first=gpu["history"][0]["loss"],
            loss_last=gpu["history"][-1]["loss"],
            launches={"dual_update": n_update, "slot_rotate": n_rotate},
            split=step_split(gpu, kernels))
        log(f"phase 3: {compression}: {MAIN_STEPS} steps on cuda in "
            f"{secs:.2f} s, on cpu in {cpu_secs:.2f} s; launches "
            f"{main[compression]['launches']}; loss "
            f"{main[compression]['loss_first']:.4f} -> "
            f"{main[compression]['loss_last']:.4f}; max |w_gpu - w_cpu| "
            f"= {diff:.3e} <= {tol:.3e}")
        log(f"phase 3: {compression}: step split "
            f"{json.dumps(main[compression]['split'])}")
    log(json.dumps({"main_path": main}))

    def entry(name, source, replaces, rs):
        small = rs[0]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": small["ms"], "plain_ms": small["plain_ms"],
            "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
            "library_ms": None,
            "wrapper_ms": small["wrapper_ms"],
            "plain_wrapper_ms": small["plain_wrapper_ms"],
            "shape": {"pods": small["pods"], "rows": small["rows"]},
            "arena_0p5b": [{k: r[k] for k in (
                "pods", "rows", "ms", "plain_ms", "bound_ms", "wrapper_ms",
                "plain_wrapper_ms", "max_abs_err")}
                for r in rs[1:]],
        }

    log(json.dumps({"kernels": [
        entry("dual_update", "src/repro_torch/kernels/csrc/dual_update.cu",
              "src/repro/kernels/dual_update/kernel.py:38",
              results["dual_update"]),
        entry("slot_rotate", "src/repro_torch/kernels/csrc/delay_ring.cu",
              "src/repro/kernels/delay_ring/kernel.py:77",
              results["slot_rotate"]),
    ]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
