"""Build and load the CUDA sources in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with ``ctypes``. The library's file name carries a hash of the source
and the flags, so a changed source is rebuilt and an unchanged one is
reused. Libraries land in ``_build/`` beside this file (listed in
``.gitignore``); they are built on first use, or all at once, in
parallel, by ``build()``.

A missing ``nvcc``, a failed build or a failed launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("dual_update", "delay_ring", "variable_pop", "flash_attention",
           "linear_scan")
# no --use_fast_math: the kernels pin IEEE rounding with __f*_rn
# intrinsics and must match the plain PyTorch version bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (all by default) that are not built
    yet, one ``nvcc`` per source, all started together. Returns each
    name's compiler log (``-Xptxas -v``: registers and spills per
    kernel); raises if any build fails."""
    names = tuple(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names
            if not library_path(n).exists()}
    procs = {}
    nvcc = nvcc_path() if todo else None
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    logs, failed = {n: "already built" for n in names if n not in todo}, []
    for n, (proc, tmp, out) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{logs[n]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    if name not in _LIBS:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check_tensor(name, t, shape, dtype, device, align: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` whose data is ``align``-byte aligned (the kernels'
    vector loads need it)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: must be contiguous and {align}-byte "
                         "aligned")


class CudaKernel:
    """One C entry point of a ``csrc`` library. ``launch`` runs it on
    PyTorch's current stream for the tensors' device and raises on a
    non-zero ``cudaError_t``; ``launches`` counts the launches that
    went through, and nothing else adds to it."""

    def __init__(self, lib: str, fn: str, argtypes: Sequence):
        self.lib, self.fn = lib, fn
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._cfn = None

    def launch(self, device, *args) -> None:
        import torch
        if self._cfn is None:
            cfn = getattr(load(self.lib), self.fn)
            cfn.argtypes = self.argtypes
            cfn.restype = ctypes.c_int
            self._cfn = cfn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._cfn(*args, stream)
        if err != 0:
            msg = load(self.lib).repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.fn} launch failed: cudaError {err} "
                               f"({msg})")
        self.launches += 1
