#!/usr/bin/env python3
"""Build, check and time the linear-scan kernels on the card alone: the
scan's part of ``chip_smoke.py`` phases 1 and 2, and a tool for tuning
the kernels.

    python3 tools/scan_check.py [--report=FILE] ['old=>new|||old=>new' ...]

Builds ``src/repro_torch/kernels/csrc/linear_scan.cu`` and each variant
of it given as an argument (string replacements, separated by ``|||``,
applied to the source; each ``old`` must occur), one ``nvcc`` each, all
started together. Prints the registers, spills and count of tensor-core
instructions (``HMMA``) in the SASS of the main path's kernels and the
opcode mix of two of them (``--report=FILE``: every kernel's). For the
source: each kernel's device time in the main path's four calls
(profiler, median of 10), then every scan row of ``chip_smoke.py``
phase 2 (``check_scan_rows``: the main path's four calls, timed, and
JAX's and the edge shapes) with its element limit and bitwise repeat.
For each variant: the per-kernel times and the main path's four calls
against the limit (reported; a variant may drop work on purpose). Needs
one CUDA card; exits non-zero when a check of the source fails.
"""
import ctypes
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_all(specs):
    """The source's library and each variant's, built in parallel:
    [(label, path, nvcc log)]."""
    from repro_torch.kernels import build
    base = (build.CSRC / "linear_scan.cu").read_text()
    tmp = Path(tempfile.mkdtemp())
    jobs = []
    for i, spec in enumerate([None] + specs):
        src = base
        for edit in spec.split("|||") if spec else []:
            old, new = edit.split("=>")
            if old not in src:
                raise SystemExit(f"not in the source: {old!r}")
            src = src.replace(old, new)
        cu, lib = tmp / f"v{i}.cu", tmp / f"libv{i}.so"
        cu.write_text(src)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        jobs.append((spec or "source", lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = []
    for label, lib, proc in jobs:
        text = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {label}:\n{text}")
        out.append((label, lib, text))
    return out


def report_build(label, lib, text, lines):
    """Print the main path's kernels' registers, spills and HMMA counts
    and two opcode mixes; append every kernel's line to ``lines``."""
    import chip_smoke as cs
    hmma = cs.sass_counts(lib, "HMMA")
    regs, name = {}, None
    for line in text.splitlines():
        if "Function properties for" in line:
            name = line.split()[-1]
        elif name and ("registers" in line or "spill" in line):
            regs.setdefault(name, []).append(line.split(":")[-1].strip())
    for name in sorted(hmma):
        lines.append(f"{label}: {hmma[name]} HMMA; "
                     f"{'; '.join(regs.get(name, []))}; {name}\n")
    for needle in ("linear_scan_outIffLi64ELi64E",
                   "linear_scan_stateIffLi64ELi64E"):
        mix = opcode_mix(lib, needle)
        cs.log(f"  SASS of {needle}: {sum(mix.values())} instructions; "
               + ", ".join(f"{k} {n}" for k, n in mix.most_common(24)))
    for name in sorted(hmma):   # ds = hd = 64 with an f32 v; the pass
        if ("Li64ELi64E" in name and "fLi64" in name) or "pass" in name:
            cs.log(f"  {hmma[name]} HMMA; {'; '.join(regs.get(name, []))}; "
                   f"{name}")


def opcode_mix(lib, needle):
    """{opcode: count} in the SASS of the first kernel of ``lib`` whose
    name holds ``needle``."""
    import collections
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = needle in line
        elif inside:
            op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
            if op:
                counts[op[1]] += 1
    return counts


def use_library(lib):
    """Bind the scan's entry points to the library at ``lib``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.linear_scan import kernel as sk
    cdll = ctypes.CDLL(str(lib))
    cdll.repro_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.repro_cuda_error_string.restype = ctypes.c_char_p
    build._LIBS["linear_scan"] = cdll
    sk.FWD._cfn = sk.BWD._cfn = None


def per_kernel(forms, n=10):
    """Each kernel's median device time (profiler) in the main path's
    four calls."""
    import collections
    import statistics

    import chip_smoke as cs
    from repro_torch.kernels.linear_scan import kernel as sk
    chunk = cs.SCAN_MAIN[6]
    for form, g, q, k, v, strict, with_inter in forms:
        def calls():
            for _ in range(n):
                sk.linear_scan_fwd(g, q, k, v, chunk=chunk, strict=strict,
                                   with_inter=with_inter)
        calls()
        kernels = cs.profiled_kernels(calls, lambda ks: len(
            [k for k, _ in ks if cs.SCAN_SYMBOL in k]) == 3 * n)
        times = collections.defaultdict(list)
        for name, us in kernels:
            times[re.search(r"linear_scan_[a-z]+", name)[0]].append(us)
        total = sum(statistics.median(v) for v in times.values()) / 1e3
        cs.log(f"  {form}: {total:.4f} ms = " + " + ".join(
            f"{k} {statistics.median(v) / 1e3:.4f}" for k, v in times.items()))


def main(args):
    import torch
    if not torch.cuda.is_available():
        print("scan_check: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"device: {torch.cuda.get_device_name(0)}")
    report = [a.split("=", 1)[1] for a in args if a.startswith("--report=")]
    specs = [a for a in args if not a.startswith("--report=")]
    t0 = time.perf_counter()
    libs = build_all(specs)
    cs.log(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    forms = cs.scan_main_forms(gen)
    bad, lines = 0, []
    for i, (label, lib, text) in enumerate(libs):
        cs.log(f"== {label}")
        report_build(label, lib, text, lines)
        use_library(lib)
        per_kernel(forms)
        if i == 0:
            rows = cs.check_scan_rows(gen)
            bad = sum(not (r["bitwise"] and r["err_over_limit"] <= 1.0)
                      for r in rows)
            cs.log(f"  {len(rows) - bad} of {len(rows)} rows pass")
        else:
            rows = [cs.check_scan(form, "main", *ops, cs.SCAN_MAIN[6],
                                  timed_run=False)
                    for form, *ops in forms]
        for r in rows:
            cs.log_scan_row("scan_check", r)
    if report:
        Path(report[0]).write_text("".join(lines))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.log(smi.stdout.strip())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
