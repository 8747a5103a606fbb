"""Public wrapper of the fused dual-averaging update on the arena.

``dual_update_arena`` is the port of ``repro.kernels.dual_update.ops.
dual_update_arena``: one pass over the (rows, 128) arena that folds the
anytime count normalization into the update. Dispatch follows the
tensors (``repro_torch.kernels.resolve_impl``): the CUDA kernel on CUDA
tensors, the plain version on CPU tensors, the plain version anywhere
with ``impl="ref"``.

Both implementations update ``z`` in place (the port's counterpart of
the JAX kernel donating z through ``input_output_aliases``) and return
a new ``w``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.dual_update.ref import dual_update_fused_ref


def dual_update_arena(z, g_sum, count, alpha, *, impl: str = "auto"):
    """g = g_sum / max(count, 1e-12); z += g; w = -alpha z.

    z, g_sum: (rows, 128) f32; count, alpha: 0-dim f32 tensors on z's
    device (no host sync: the kernel reads them from device memory).
    Returns (z, w), z being the same tensor, updated in place."""
    denom = torch.clamp(count, min=1e-12)
    if resolve_impl(impl, z, g_sum, denom, alpha) == "ref":
        z_new, w = dual_update_fused_ref(z, g_sum, denom, alpha)
        z.copy_(z_new)
        return z, w
    from repro_torch.kernels.dual_update.kernel import dual_update_fused_fwd
    scal = torch.stack([alpha.to(torch.float32), denom.to(torch.float32)])
    return dual_update_fused_fwd(z, g_sum, scal)


__all__ = ["dual_update_arena", "dual_update_fused_ref"]
