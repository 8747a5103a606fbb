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

``dual_update_arena_sharded`` (JAX's shard_map wrapper) runs the same
update on the rows one rank of a multi-rank mesh holds: the update is
elementwise, so it carries no collective.

``dual_update`` is the legacy pytree wrapper (``repro.kernels.
dual_update.ops.dual_update``): z += g; w = -alpha z over a tree,
flattened on every call into a (rows, 128) matrix padded to a multiple
of 128 x 256 elements and unflattened after. As in JAX, no path of the
package calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.kernels.dual_update.ref import (dual_update_fused_ref,
                                                 dual_update_ref)

_LANES = 128
_BLOCK_ROWS = 256


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


def dual_update_arena_sharded(z, g_sum, count, alpha, *,
                              impl: str = "auto"):
    """``dual_update_arena`` on this rank's row shard of z and g_sum
    ((rows_local, 128) f32, rows over the mesh's intra-pod slice as
    ``dist.sharding.arena_slot_specs``'s row spec cuts them), under the
    ambient mesh (``dist.context``; raises without one or without a
    process group). No collective: count and alpha are replicated
    scalars. Returns (z, w) on the shard, z updated in place."""
    from repro_torch.dist.collectives import require_mesh
    require_mesh("dual_update_arena_sharded")
    return dual_update_arena(z, g_sum, count, alpha, impl=impl)


def _flatten(tree):
    """The sorted leaves as one f32 (rows, 128) matrix, zero-padded to a
    multiple of 128 x 256 elements (JAX's ``_flatten``)."""
    leaves, treedef = tree_flatten(tree)
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
    pad = (-flat.numel()) % (_LANES * _BLOCK_ROWS)
    flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, _LANES), (treedef, [x.shape for x in leaves],
                                      [x.dtype for x in leaves])


def _unflatten(mat, meta):
    treedef, shapes, dtypes = meta
    flat, out, ofs = mat.reshape(-1), [], 0
    for shape, dtype in zip(shapes, dtypes):
        size = shape.numel()
        out.append(flat[ofs:ofs + size].reshape(shape).to(dtype))
        ofs += size
    return tree_unflatten(treedef, out)


def dual_update(z_tree, g_tree, alpha, *, impl: str = "auto"):
    """(z_new_tree, w_tree) = (z + g, -alpha (z + g)) over two trees of
    the same structure; ``alpha`` a float or 0-dim tensor. The input
    trees are left as they are."""
    z_mat, meta = _flatten(z_tree)
    g_mat, _ = _flatten(g_tree)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=z_mat.device)
    if resolve_impl(impl, z_mat, g_mat, alpha) == "ref":
        z_new, w = dual_update_ref(z_mat, g_mat, alpha)
    else:
        from repro_torch.kernels.dual_update.kernel import dual_update_fwd
        z_new, w = dual_update_fwd(z_mat, g_mat, alpha)
    return _unflatten(z_new, meta), _unflatten(w, meta)


__all__ = ["dual_update", "dual_update_arena", "dual_update_arena_sharded",
           "dual_update_fused_ref",
           "dual_update_ref"]
