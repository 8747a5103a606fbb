"""Hand-written CUDA kernels of the port, one per Pallas TPU kernel of
the JAX package.

Each kernel directory mirrors the JAX one: ``kernel.py`` binds the
CUDA C++ source in ``csrc/`` (built by ``kernels.build`` with ``nvcc``
for ``sm_90a`` and loaded with ``ctypes``), ``ref.py`` is the plain
PyTorch version (the twin of the JAX ``ref.py``), and ``ops.py`` is the
public wrapper that dispatches between the two.

  dual_update/  fused dual-averaging update z += g_sum/denom; w = -alpha z
  delay_ring/   the ring rotates and pops: the v2 int8 slot rotate
                (dequantize the popped slot, quantize the error-fed
                gradient into the push slot, write the new residual), the
                v1 stacked-ring rotate (f32 and int8, head read on the
                card), and the v3 variable pop (fold the slots due this
                step, f32 or int8, with the (count, stale_sum) epilogue)
  flash_attention/  blocked causal/window attention: the forward with and
                without lse, and the recomputing backward (dq, and
                dk/dv summed over each GQA group), wired by an
                autograd.Function

Dispatch (``resolve_impl``) follows the tensors, never the host: a CUDA
tensor goes to the kernel, a CPU tensor to the plain version. There is
no fallback from one to the other.
"""
from __future__ import annotations

IMPLS = ("auto", "kernel", "ref")


def resolve_impl(impl: str, *tensors) -> str:
    """Resolve ``impl`` to "kernel" or "ref" from the tensors' device.

      "auto"    the CUDA kernel for CUDA tensors, the plain PyTorch
                version for CPU tensors;
      "kernel"  the CUDA kernel; raises on CPU tensors;
      "ref"     the plain version on either device (the comparison the
                kernel is held against).

    Tensors on mixed or other devices raise."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "ref":
        return "ref"
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return "kernel"
    if kinds == {"cpu"}:
        if impl == "kernel":
            raise ValueError("impl='kernel' needs CUDA tensors; these lie "
                             "on the CPU (use impl='ref' or 'auto')")
        return "ref"
    raise ValueError(f"tensors on devices {sorted(kinds)}: expected all "
                     "on 'cuda' or all on 'cpu'")
