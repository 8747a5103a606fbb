#!/usr/bin/env python3
"""Drive the PyTorch port of AMB-DG on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and the script exits non-zero):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all started together) and print the time;
  2. hold each kernel against its plain PyTorch version on the card,
     bitwise, at the slice's arena (256 rows, one pod) and at an arena
     the size of qwen1.5-0.5b's 463,987,712 parameters (3,624,960 rows;
     one pod, and two for the ring rotates and the int8 variable pop);
     the variable pop on a ring of 9 slots with 0, 1 and 2 of them due,
     the v1 rotate on a ring of 4; time both over 25 launches
     after warm-up (device time from ``torch.profiler``, which must see
     the kernels; CUDA events around each call, host launch work
     included, beside it) against the least time the card could take
     (bytes moved at 3.35 TB/s; flops at 67 TFLOP/s f32), and, for the
     f32 variable pop, ``torch.tensordot`` of the mask with the ring
     (one library call computing the same function) as a yardstick;
  3. the main path: ``repro_torch.train.loop.train`` of ``amb-linreg``
     FULL (d = 10^4, the paper's Sec. VI-A setting: 10 workers x 150
     samples, tau = 4, l2-ball prox), 12 steps with pod compression int8
     and again with none, on the card and then on the CPU from the same
     seed. The kernels' launch counts, zeroed just before each run on
     the card and read just after, must equal the steps run; the two
     devices must agree (tolerances below). Where a step's time goes
     comes from the same run on the card: ``train``'s per-step host
     batch, copy and step times, and the card's kernel time over the
     run (profiler);
  4. the stochastic-delay path: the same runs under a heavy-tailed
     delay (tau_max = 8, seed 7) on the delay-tolerant ring. Its steps
     with no arrival, one and two (from ``core.delay_process`` and
     ``core.staleness``) must show in ``applied_count`` and
     ``tau_applied``, identically on the card and the CPU; the variable
     pop and the dual update launch once a step, the slot rotate never;
     one master update (ring push and pop, then dual averaging) runs
     under ``torch.cuda.set_sync_debug_mode("error")``: nothing is read
     back to the host;
  5. the v1 ring: ``core.arena.push_pop`` on a stacked (layout v1) ring
     beside a v2 ring for tau + 3 steps at the main path's arena, f32
     and int8: the same pops bit for bit, one v1 rotate launch a step,
     and ``convert_ring`` gives back the v2 ring's live slots.

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


PROFILER_TRIES = 5


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` (CUPTI); returns (its
    result, the device kernels recorded: a list of (name, microseconds),
    empty when the profiler saw no device time). On some hosts a CUPTI
    session now and then records nothing, or loses some of its records;
    callers run ``fn`` again, up to PROFILER_TRIES times, and raise if no
    try gave a complete record."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not sum(us for _, us in kernels):
        log("note: torch.profiler recorded no device time in one session")
        kernels = []
    return out, kernels


def profiled_kernels(fn, complete):
    """The device kernels of ``fn()`` (see ``profiled``), running it again
    while the profiler's record is empty or not ``complete(kernels)`` (a
    session that lost some of its records); raises after PROFILER_TRIES
    sessions."""
    for _ in range(PROFILER_TRIES):
        _, kernels = profiled(fn)
        if kernels and complete(kernels):
            return kernels
        if kernels:
            log(f"note: torch.profiler recorded {len(kernels)} kernels, an "
                "incomplete record, in one session")
    raise RuntimeError(f"torch.profiler recorded no complete record of "
                       f"the device in {PROFILER_TRIES} sessions")


def device_ms(fn, n=N_TIMED, warmup=3, match=None):
    """Device time of ``fn()`` from the profiler over ``n`` calls after
    ``warmup``: with ``match``, the median duration of the kernels whose
    name contains it (one per call, so the record must hold n of them);
    without, the summed duration of all kernels divided by ``n`` (the
    record must hold a multiple of n: every call launches the same
    kernels). Host time between launches is not counted. Also returns
    the kernels' names and counts."""
    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(n):
            fn()

    def mine(kernels):
        return [(k, us) for k, us in kernels if match is None or match in k]

    def complete(kernels):
        m = len(mine(kernels))
        return m == n if match is not None else m % n == 0

    kernels = mine(profiled_kernels(calls, complete))
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


N_SLOTS = 9          # the stochastic main path's ring: tau_max = 8
DUE = {0: (), 1: (3,), 2: (2, 7)}


def check_variable_pop(int8, n_pods, rows, n_due, gen):
    """Kernel vs plain version of the masked pop (and its count /
    staleness epilogue) on a (9, n_pods, rows, 128) ring with ``n_due``
    slots due; slot 8, never due, holds an inf that must not reach the
    result. f32 also times ``torch.tensordot`` of the mask with the ring.
    """
    import torch
    from repro_torch.kernels.delay_ring.ops import ring_variable_pop
    from repro_torch.kernels.delay_ring.ref import (ring_variable_meta_ref,
                                                    ring_variable_pop_ref)
    dev = torch.device("cuda")
    shape = (N_SLOTS, n_pods, rows, 128)
    scales = None
    if int8:
        ring = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
        scales = torch.rand(shape[:3], generator=gen, device=dev) + 1e-3
        scales[8, :, :2] = math.inf
    else:
        ring = torch.randn(shape, generator=gen, device=dev)
        ring[8, :, :2] = math.inf
    mask = torch.zeros(N_SLOTS, dtype=torch.bool, device=dev)
    mask[list(DUE[n_due])] = True
    cs = torch.stack([
        torch.randint(0, 300, (N_SLOTS,), generator=gen, device=dev),
        torch.randint(0, 9, (N_SLOTS,), generator=gen, device=dev)]).float()
    got = ring_variable_pop(ring, mask, scales, cs, impl="kernel")
    want = ring_variable_pop(ring, mask, scales, cs, impl="ref")
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    finite = bool(torch.isfinite(got[0]).all())
    err = max_abs_err(got, want)
    del got, want
    times = timed(
        lambda: ring_variable_pop(ring, mask, scales, cs, impl="kernel"),
        lambda: (ring_variable_pop_ref(ring, mask, scales),
                 ring_variable_meta_ref(mask, cs)),
        "variable_pop_kernel")
    library_ms = None
    if not int8:
        maskf = mask.float()
        library_ms = device_ms(lambda: torch.tensordot(maskf, ring,
                                                       dims=1))[0]
    n = n_pods * rows * 128
    slot_bytes = n + 4 * n_pods * rows if int8 else 4 * n
    b_ms, by = bound_ms(n_due * slot_bytes + 4 * n + 9 * N_SLOTS + 8,
                        n_due * n * (2 if int8 else 1))
    del ring, scales
    return dict(rows=rows, pods=n_pods, int8=int8, due=n_due, slots=N_SLOTS,
                bitwise=equal and finite, max_abs_err=err, bound_ms=b_ms,
                bound_by=by, library_ms=library_ms, **times)


def check_ring_rotate(int8, n_pods, rows, gen, tau=4):
    """Kernel vs plain version of the v1 rotate (pop ring[head], push in
    place) on a (tau, n_pods, rows, 128) ring, head on the card; under
    int8 fed puts some values on half-way points and past the clip."""
    import torch
    from repro_torch.kernels.delay_ring.ops import ring_push_pop
    from repro_torch.kernels.delay_ring.ref import ring_push_pop_ref
    dev = torch.device("cuda")
    shape = (tau, n_pods, rows, 128)
    head = torch.full((), 2, dtype=torch.int32, device=dev)
    fed = torch.randn(shape[1:], generator=gen, device=dev)
    scales = scale_new = None
    if int8:
        ring = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
        scales = torch.rand(shape[:3], generator=gen, device=dev) + 1e-3
        scale_new = torch.rand(shape[1:3], generator=gen, device=dev) + 1e-3
        scale_new[:, :64] = 2.0 ** -6
        k = torch.randint(-140, 140, (n_pods, 64, 128), generator=gen,
                          device=dev)
        fed[:, :64] = (k + 0.5) * 2.0 ** -6
    else:
        ring = torch.randn(shape, generator=gen, device=dev)

    def run(impl):
        out = ring_push_pop(ring.clone(), fed.clone(), head,
                            None if scales is None else scales.clone(),
                            scale_new, impl=impl)
        return [x for x in out if x is not None]

    got, want = run("kernel"), run("ref")
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max_abs_err(got, want)
    del got, want
    times = timed(
        lambda: ring_push_pop(ring, fed, head, scales, scale_new,
                              impl="kernel"),
        lambda: ring_push_pop_ref(ring, fed, head, scales, scale_new),
        "ring_rotate_")
    n = n_pods * rows * 128
    n_bytes = (14 * n + 12 * n_pods * rows if int8 else 16 * n) + 4
    b_ms, by = bound_ms(n_bytes, 7 * n if int8 else 0)
    del ring, scales
    return dict(rows=rows, pods=n_pods, int8=int8, tau=tau, bitwise=equal,
                max_abs_err=err, bound_ms=b_ms, bound_by=by, library_ms=None,
                **times)


# the stochastic path's delay: heavy-tailed, capped at 8, with the seed
# benchmarks/delay_sweep.py uses
STOCHASTIC_DELAY = dict(process="heavy_tail", tau_max=8, seed=7)


def main_path_config(cfg=None):
    """The paper's linear regression at full width (Sec. VI-A), as
    ``examples/linreg_paper.py`` sets it up: (model config, (compression,
    delay) -> RunConfig); ``delay`` (DelayConfig fields) makes it the
    stochastic-delay path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (AmbdgConfig, DelayConfig,
                                          MeshConfig, RunConfig, TRAIN_4K)
    cfg = cfg or get_config("amb-linreg")
    d = cfg.linreg_dim

    def rc(compression, delay=None):
        return RunConfig(
            model=cfg, shape=TRAIN_4K,
            mesh=MeshConfig(n_pods=1, data=1, model=1),
            ambdg=AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                              b_bar=800.0, proximal="l2_ball",
                              radius_C=1.05 * math.sqrt(d),
                              pod_compression=compression),
            delay=DelayConfig(**(delay or {})))
    return cfg, rc


def run_main_path(compression, device, cfg=None, delay=None):
    """One ``train`` run of the main path; returns (result, seconds)."""
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    cfg, rc = main_path_config(cfg)
    loop = LoopConfig(n_steps=MAIN_STEPS, n_workers=10,
                      samples_per_worker=150, use_timing_model=True,
                      log_every=1)
    t0 = time.perf_counter()
    out = train(build_model(cfg, device=device), rc(compression, delay),
                loop, device=device)
    return out, time.perf_counter() - t0


def arrivals(delay, tau=4):
    """(delays, arrivals per step) of the stochastic path's first
    MAIN_STEPS steps, from the port's delay process and delivery
    schedule (push s, 1-indexed, lands at step s + tau_s)."""
    from repro_torch.configs.base import DelayConfig
    from repro_torch.core.delay_process import make_delay_process
    from repro_torch.core.staleness import delivery_schedule
    delays = make_delay_process(DelayConfig(**delay),
                                tau).sequence(MAIN_STEPS).tolist()
    sched = delivery_schedule(delays)
    return delays, [len(sched.get(t + 1, [])) for t in range(MAIN_STEPS)]


def compare_devices(compression, gpu, cpu, arrived, radius, tau_max=None):
    """GPU vs CPU run of the same seed. ``arrived[t]``: the entries due
    at step t (``applied_count`` is 0 exactly where it is 0); under a
    stochastic delay ``tau_applied`` agrees exactly and is ``tau_max`` on
    the empty steps. applied_count is exact; loss and
    grad_norm agree to rtol 1e-4 (the f32 products sum their 10^4-term
    dot products in another order on each device, which moves the last
    bits); w to 1e-4 of its largest element, plus one quantization step
    (alpha * scale / count) under int8, where a last-bit difference can
    flip one rounding. w lies in the l2 ball of ``radius`` (the prox's
    constraint). With a fixed tau the loss falls over the run; under a
    stochastic delay it need not in 12 steps, and is not checked."""
    import numpy as np
    import torch
    hg, hc = gpu["history"], cpu["history"]
    assert len(hg) == len(hc) == MAIN_STEPS, (len(hg), len(hc))
    for t, (a, b) in enumerate(zip(hg, hc)):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        if not arrived[t]:
            assert a["applied_count"] == 0.0, (t, a)
        else:
            assert a["applied_count"] > 0.0, (t, a)
        if tau_max is not None:       # the stochastic path
            assert a["tau_applied"] == b["tau_applied"], (t, a, b)
            if not arrived[t]:
                assert a["tau_applied"] == tau_max, (t, a)
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
            h["applied_count"] for h in hc if h["applied_count"])
        tol += step          # alpha < 1
    diff = float(np.abs(wg - wc).max())
    assert diff <= tol, (compression, diff, tol)
    norm = float(np.linalg.norm(wg.astype(np.float64)))
    assert norm <= radius * (1 + 1e-5), (norm, radius)
    if tau_max is None:
        # the run learns: the loss falls once the delayed updates land
        assert hg[-1]["loss"] < hg[0]["loss"], (hg[0]["loss"],
                                                hg[-1]["loss"])
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


def split_run(compression, delay=None):
    """A run of the main path again, for its step split, when the
    profiler recorded nothing in the run whose launches were counted:
    (result, seconds, kernels), running it up to PROFILER_TRIES times."""
    for _ in range(PROFILER_TRIES):
        (out, secs), kernels = profiled(
            lambda: run_main_path(compression, "cuda", delay=delay))
        if kernels:
            log(f"note: the step split of {compression} comes from a "
                "second run of the same seed")
            return out, secs, kernels
    raise RuntimeError(f"torch.profiler recorded no device time in "
                       f"{PROFILER_TRIES} runs of the main path")


def master_update_without_sync(out, compression, cfg=None):
    """One master update of the stochastic path on the card (the v3 ring
    push and pop, then dual averaging), continued from a run's final
    state, under ``torch.cuda.set_sync_debug_mode("error")``: any read
    back to the host raises. A first update outside the check warms the
    layout's device caches."""
    import torch
    from repro_torch.core import arena as arena_mod
    from repro_torch.optim import make_arena_optimizer
    cfg, rc = main_path_config(cfg)
    rc = rc(compression, STOCHASTIC_DELAY)
    state = out["state"]
    dev = state.arena.ring.device
    layout = arena_mod.make_layout(state.params)
    opt = make_arena_optimizer(rc, layout, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    arena, opt_state = state.arena, state.opt_state

    def update(delay, check):
        nonlocal arena, opt_state
        grads = {k: torch.randn((1,) + tuple(v.shape), generator=gen,
                                device=dev) for k, v in state.params.items()}
        counts = torch.full((1,), 1000.0, device=dev)
        delay = torch.full((), delay, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if check else 0)
        try:
            g_sum, count, tau_obs, arena = arena_mod.push_pop_variable(
                layout, arena, grads, counts, delay, compression)
            params, opt_state = opt.update(opt_state, state.params, g_sum,
                                           count, tau_obs=tau_obs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return params

    update(0, check=False)
    params = update(0, check=True)     # tau_t = 0: delivered at once
    assert all(bool(torch.isfinite(v).all()) for v in params.values())
    return True


def v1_phase(compression, device, cfg=None, tau=4):
    """``core.arena.push_pop`` on a v1 (stacked) ring beside a v2 ring at
    the main path's arena for tau + 3 steps from the same gradients:
    the pops and counts agree bit for bit; then ``convert_ring`` of the
    v1 ring gives back the v2 ring's live slots. Returns the number of
    steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import arena as arena_mod
    cfg = cfg or get_config("amb-linreg")
    params = {"b": torch.zeros((), device=device),
              "w": torch.zeros((cfg.linreg_dim,), device=device)}
    layout = arena_mod.make_layout(params)
    v1 = arena_mod.init_arena(layout, tau, 1, compression, device=device,
                              ring_version=1)
    v2 = arena_mod.init_arena(layout, tau, 1, compression, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    for t in range(tau + 3):
        grads = {k: torch.randn((1,) + tuple(v.shape), generator=gen,
                                device=device) * 30
                 for k, v in params.items()}
        counts = torch.full((1,), 100.0 + t, device=device)
        g1, c1, v1 = arena_mod.push_pop(layout, v1, grads, counts,
                                        compression)
        g2, c2, v2 = arena_mod.push_pop(layout, v2, grads, counts,
                                        compression)
        assert torch.equal(g1, g2) and torch.equal(c1, c2), (compression, t)
        assert (float(c1) == 0.0) == (t < tau), (t, float(c1))
    back = arena_mod.convert_ring(v1, 2)
    for k in range(1, tau + 1):
        src = (k + v2.phase) % (tau + 1)
        assert torch.equal(back.ring[k], v2.ring[src]), (compression, k)
        assert torch.equal(back.counts[k], v2.counts[src])
    return tau + 3


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
    results = {"dual_update": [], "slot_rotate": [], "variable_pop": [],
               "ring_rotate": []}
    for rows in (256, big_rows):
        results["dual_update"].append(check_dual_update(rows, gen))
        torch.cuda.empty_cache()
    for pods, rows in ((1, 256), (1, big_rows), (2, big_rows)):
        results["slot_rotate"].append(check_rotate(pods, rows, gen))
        torch.cuda.empty_cache()
    # the first entry of each list is the one the kernels line leads with:
    # the main path's shape (f32 where a library call computes the same)
    for int8, pods, rows in ((False, 1, 256), (True, 1, 256),
                             (False, 1, big_rows), (True, 1, big_rows),
                             (True, 2, big_rows)):
        for n_due in ((1, 0, 2) if rows == 256 and not int8 else (0, 1, 2)):
            results["variable_pop"].append(
                check_variable_pop(int8, pods, rows, n_due, gen))
            torch.cuda.empty_cache()
    for int8, pods, rows in ((False, 1, 256), (True, 1, 256),
                             (False, 1, big_rows), (True, 1, big_rows),
                             (True, 2, big_rows)):
        results["ring_rotate"].append(check_ring_rotate(int8, pods, rows,
                                                        gen))
        torch.cuda.empty_cache()
    for name, rs in results.items():
        for r in rs:
            form = ("" if "int8" not in r else
                    (" int8" if r["int8"] else " f32")
                    + (f" due={r['due']}/{r['slots']}" if "due" in r else ""))
            lib = ("" if r.get("library_ms") is None else
                   f" library_ms={r['library_ms']:.5f}")
            log(f"phase 2: {name}{form} P={r['pods']} rows={r['rows']}: "
                f"bitwise={r['bitwise']} ms={r['ms']:.5f} plain_ms="
                f"{r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f}{lib} "
                f"wrapper_ms={r['wrapper_ms']:.5f} plain_wrapper_ms="
                f"{r['plain_wrapper_ms']:.5f} (profiler: kernel "
                f"launches {sum(r['kernels'].values())}, plain "
                f"version {sum(r['plain_kernels'].values())} "
                f"kernels, over {N_TIMED} calls)")
            assert r["bitwise"] and r["max_abs_err"] == 0.0, (name, r)
    counters = {"dual_update": update_kernel.KERNEL,
                "slot_rotate": ring_kernel.KERNEL,
                "variable_pop": ring_kernel.VARIABLE_POP_KERNEL,
                "ring_rotate": ring_kernel.RING_KERNEL}
    launches = dict.fromkeys(counters, 0)

    def drive(fn):
        """Run ``fn()`` with every launch count set to 0 just before;
        returns (its result, the counts just after), the counts also
        added to the kernels line's ``launches``."""
        for k in counters.values():
            k.launches = 0
        out = fn()
        n = {name: k.launches for name, k in counters.items()}
        for name in n:
            launches[name] += n[name]
        return out, n

    # -- 3. the main path: fixed tau ----------------------------------------
    tau = 4
    radius = main_path_config()[1]("none").ambdg.radius_C
    main = {}
    for compression in ("int8", "none"):
        ((gpu, secs), kernels), n = drive(lambda: profiled(
            lambda: run_main_path(compression, "cuda")))
        want = dict(dual_update=MAIN_STEPS, variable_pop=0, ring_rotate=0,
                    slot_rotate=MAIN_STEPS if compression == "int8" else 0)
        assert n == want, (compression, n, want)
        if not kernels:
            gpu, secs, kernels = split_run(compression)
        cpu, cpu_secs = run_main_path(compression, "cpu")
        diff, tol = compare_devices(compression, gpu, cpu,
                                    [t >= tau for t in range(MAIN_STEPS)],
                                    radius)
        main[compression] = dict(
            gpu_s=secs, cpu_s=cpu_secs, w_max_diff=diff, w_tol=tol,
            loss_first=gpu["history"][0]["loss"],
            loss_last=gpu["history"][-1]["loss"],
            launches=n, split=step_split(gpu, kernels))
        log(f"phase 3: {compression}: {MAIN_STEPS} steps on cuda in "
            f"{secs:.2f} s, on cpu in {cpu_secs:.2f} s; launches "
            f"{main[compression]['launches']}; loss "
            f"{main[compression]['loss_first']:.4f} -> "
            f"{main[compression]['loss_last']:.4f}; max |w_gpu - w_cpu| "
            f"= {diff:.3e} <= {tol:.3e}")
        log(f"phase 3: {compression}: step split "
            f"{json.dumps(main[compression]['split'])}")

    # -- 4. the stochastic-delay path ---------------------------------------
    delays, arrived = arrivals(STOCHASTIC_DELAY, tau)
    assert {0, 1, 2} <= set(arrived), (delays, arrived)
    log(f"phase 4: delays {delays}, arrivals per step {arrived}")
    stochastic = {}
    for compression in ("int8", "none"):
        ((gpu, secs), kernels), n = drive(lambda: profiled(
            lambda: run_main_path(compression, "cuda",
                                  delay=STOCHASTIC_DELAY)))
        want = dict(dual_update=MAIN_STEPS, variable_pop=MAIN_STEPS,
                    slot_rotate=0, ring_rotate=0)
        assert n == want, (compression, n, want)
        if not kernels:
            gpu, secs, kernels = split_run(compression, STOCHASTIC_DELAY)
        cpu, cpu_secs = run_main_path(compression, "cpu",
                                      delay=STOCHASTIC_DELAY)
        diff, tol = compare_devices(compression, gpu, cpu, arrived, radius,
                                    tau_max=STOCHASTIC_DELAY["tau_max"])
        no_sync = master_update_without_sync(gpu, compression)
        stochastic[compression] = dict(
            gpu_s=secs, cpu_s=cpu_secs, w_max_diff=diff, w_tol=tol,
            loss=[h["loss"] for h in gpu["history"]],
            applied_count=[h["applied_count"] for h in gpu["history"]],
            tau_applied=[h["tau_applied"] for h in gpu["history"]],
            launches=n, master_update_without_sync=no_sync,
            split=step_split(gpu, kernels))
        log(f"phase 4: {compression}: {MAIN_STEPS} steps on cuda in "
            f"{secs:.2f} s, on cpu in {cpu_secs:.2f} s; launches {n}; "
            f"applied_count {stochastic[compression]['applied_count']}; "
            f"tau_applied {stochastic[compression]['tau_applied']}; loss "
            f"{[round(x, 2) for x in stochastic[compression]['loss']]}; "
            f"max |w_gpu - "
            f"w_cpu| = {diff:.3e} <= {tol:.3e}; master update with no "
            f"host sync: {no_sync}")
        log(f"phase 4: {compression}: step split "
            f"{json.dumps(stochastic[compression]['split'])}")

    # -- 5. the v1 ring -----------------------------------------------------
    v1 = {}
    for compression in ("int8", "none"):
        steps, n = drive(lambda: v1_phase(compression, "cuda"))
        want = dict(dual_update=0, variable_pop=0, ring_rotate=steps,
                    slot_rotate=steps if compression == "int8" else 0)
        assert n == want, (compression, n, want)
        v1[compression] = dict(steps=steps, launches=n)
        log(f"phase 5: v1 {compression}: {steps} steps, pops equal to v2 "
            f"bit for bit; launches {n}")
    log(json.dumps({"main_path": main, "stochastic_path": stochastic,
                    "v1": v1}))

    def entry(name, source, replaces, rs):
        lead = rs[0]
        keys = ("int8", "due", "slots", "tau", "pods", "rows", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "wrapper_ms", "plain_wrapper_ms", "max_abs_err")
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": lead.get("library_ms"),
            "wrapper_ms": lead["wrapper_ms"],
            "plain_wrapper_ms": lead["plain_wrapper_ms"],
            "shape": {k: lead[k] for k in keys[:6] if k in lead},
            "other_shapes": [{k: r[k] for k in keys if k in r}
                             for r in rs[1:]],
        }

    ring_py = "src/repro/kernels/delay_ring/kernel.py"
    log(json.dumps({"kernels": [
        entry("dual_update", "src/repro_torch/kernels/csrc/dual_update.cu",
              "src/repro/kernels/dual_update/kernel.py:38",
              results["dual_update"]),
        entry("slot_rotate", "src/repro_torch/kernels/csrc/delay_ring.cu",
              f"{ring_py}:77", results["slot_rotate"]),
        entry("variable_pop", "src/repro_torch/kernels/csrc/variable_pop.cu",
              f"{ring_py}:159", results["variable_pop"]),
        entry("ring_rotate", "src/repro_torch/kernels/csrc/delay_ring.cu",
              f"{ring_py}:231", results["ring_rotate"]),
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
