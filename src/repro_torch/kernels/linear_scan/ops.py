"""Public wrappers of the chunked linear scan
(``repro.kernels.linear_scan``): Mamba2's SSD over the generalized
scan kernel.

``linear_scan`` is the JAX entry (the forward alone); ``ssd_mamba2`` the
JAX mapping (q = C, k = B group-shared, v = dt * x, g = dt * A; the
D-skip, gating and projections stay in the model), here differentiable:
it goes through ``LinearScanTrain``, whose backward is the same scan
three more times. With G = cumsum(g) the forward is
y_t = sum_{j <= t} e^{G_t - G_j} (q_t . k_j) v_j, so, with R the flip
along S, g~ = R(shift(g)) (shift(g)_t = g_{t+1}, 0 at the end) and
x_rep the group-shared x repeated to the BH heads:

    dv   = R(scan(g~, q=R(k), k=R(q), v=R(dy)))
    dk_h = R(scan(g~, q=R(v), k=R(dy), v=R(q_rep)));  dk = group sum
    dq_h = scan(g, q=dy, k=v, v=k_rep);                dq = group sum
    dG   = rowsum(q_rep * dq_h) - rowsum(k_rep * dk_h); dg = reverse cumsum

(the dk_h and dq_h scans strict, and dg assembled chunk by chunk from
the calls' inter-chunk parts: see ``scan_backward``). The backward's
scans run on f32 operands and return f32; the flips, repeats, group
sums, the diagonal and the cumsums are plain PyTorch.

Dispatch follows the tensors (``repro_torch.kernels.resolve_impl``): the
CUDA kernel on CUDA tensors, the plain recurrence (``ref.linear_scan_ref``)
on CPU tensors and anywhere with ``impl="ref"``; ``LinearScanTrain``
runs the same formulas with either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.linear_scan.ref import linear_scan_ref


def _check_chunk(S: int, chunk: int) -> None:
    if chunk <= 0 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")


def linear_scan(g, q, k, v, *, chunk: int = 128, impl: str = "auto"):
    """g (BH, S) log-decays; q, k (BHG, S, ds) group-shared; v (BH, S,
    hd) -> y (BH, S, hd) in v's dtype. Not differentiable (the JAX
    entry); ``linear_scan_train`` is."""
    _check_chunk(g.shape[1], chunk)
    g = g.to(torch.float32)
    if resolve_impl(impl, g, q, k, v) == "ref":
        return linear_scan_ref(g, q, k, v)
    from repro_torch.kernels.linear_scan.kernel import linear_scan_fwd
    return linear_scan_fwd(g.contiguous(), q.contiguous(), k.contiguous(),
                           v.contiguous(), chunk=chunk)


def _flip(x):
    return torch.flip(x, dims=(1,))


def scan_backward(scan, g, q, k, v, dy, chunk: int):
    """(dg, dq, dk, dv) of y = scan(g, q, k, v) for the cotangent dy, in
    f32, from three more calls of ``scan(g, q, k, v, strict, with_inter)``
    (the kernel or the plain recurrence, with this chunk).

    With P_tj = e^{G_t - G_j} (q_t . k_j)(v_j . dy_t), dg_s is the sum
    of P over the pairs j < s <= t. The dq and dk calls are strict (the
    diagonal j = t left out and added back here), so that
    dG_t = sum_j P_tj - sum_t' P_t't holds only off-diagonal terms:
    with strong decay the diagonal dominates both. dg is then assembled
    chunk by chunk rather than as one reverse cumsum of dG over S: the
    pairs inside [s, S) cancel in that cumsum, and the two calls round
    them differently, so over S = 4096 the residue swamps the decay-rate
    gradient. Within s's chunk, dg_s = (reverse cumsum of dG over the
    chunk) + W_c, where W_c, the pairs that straddle the chunk's end,
    follows from the calls' inter-chunk parts: W_c = W_{c-1} + B_c - E_c
    (B_c: pairs leaving chunk c for later chunks, E_c: pairs entering it
    from earlier ones; W of the last chunk is 0)."""
    f32 = lambda x: x.to(torch.float32).contiguous()
    g, q, k, v, dy = map(f32, (g, q, k, v, dy))
    BH, S = g.shape
    BHG, _, ds = q.shape
    rep, nc = BH // BHG, S // chunk
    g_rev = _flip(torch.cat([g[:, 1:], torch.zeros_like(g[:, :1])], dim=1))
    q_rep = torch.repeat_interleave(q, rep, dim=0) if rep > 1 else q
    k_rep = torch.repeat_interleave(k, rep, dim=0) if rep > 1 else k
    dv = _flip(scan(g_rev, _flip(k), _flip(q), _flip(dy), False, False))
    dk_h, dk_inter = (_flip(x) for x in scan(
        g_rev, _flip(v), _flip(dy), _flip(q_rep), True, True))
    dq_h, dq_inter = scan(g, dy, v, k_rep, True, True)
    dG = (torch.sum(q_rep * dq_h, dim=-1)
          - torch.sum(k_rep * dk_h, dim=-1)).reshape(BH, nc, chunk)
    local = torch.flip(torch.cumsum(torch.flip(dG, dims=(2,)), dim=2),
                       dims=(2,))
    leaving = torch.sum(k_rep * dk_inter, dim=-1).reshape(BH, nc, chunk)
    entering = torch.sum(q_rep * dq_inter, dim=-1).reshape(BH, nc, chunk)
    W = torch.cumsum(leaving.sum(dim=2) - entering.sum(dim=2), dim=1)
    W[:, -1] = 0.0
    dg = (local + W[:, :, None]).reshape(BH, S)
    vdy = torch.sum(v * dy, dim=-1, keepdim=True)          # the diagonal
    dq = (dq_h + k_rep * vdy).reshape(BHG, rep, S, ds).sum(dim=1)
    dk = (dk_h + q_rep * vdy).reshape(BHG, rep, S, ds).sum(dim=1)
    return dg, dq, dk, dv


class LinearScanTrain(torch.autograd.Function):
    """The scan with its backward made of the scan (see the module
    docstring). Saves g, q, k, v. ``use_kernel`` picks the CUDA kernel
    or the plain recurrence for the forward and all three backward
    calls."""

    @staticmethod
    def forward(ctx, g, q, k, v, chunk, use_kernel):
        ctx.chunk, ctx.use_kernel = chunk, use_kernel
        ctx.save_for_backward(g, q, k, v)
        if not use_kernel:
            return linear_scan_ref(g, q, k, v)
        from repro_torch.kernels.linear_scan.kernel import linear_scan_fwd
        return linear_scan_fwd(g, q, k, v, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        g, q, k, v = ctx.saved_tensors
        if ctx.use_kernel:
            from repro_torch.kernels.linear_scan.kernel import (
                BWD, linear_scan_fwd)

            def scan(g, q, k, v, strict, with_inter):
                return linear_scan_fwd(g, q, k, v, chunk=ctx.chunk,
                                       strict=strict, with_inter=with_inter,
                                       counter=BWD)
        else:
            def scan(g, q, k, v, strict, with_inter):
                return linear_scan_ref(g, q, k, v, strict,
                                       ctx.chunk if with_inter else None)
        dg, dq, dk, dv = scan_backward(scan, g, q, k, v, dy, ctx.chunk)
        return (dg.to(g.dtype), dq.to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None)


def linear_scan_train(g, q, k, v, *, chunk: int = 128, impl: str = "auto"):
    """Differentiable ``linear_scan`` (``LinearScanTrain``): the kernel
    on CUDA tensors, the plain recurrence on CPU tensors or with
    ``impl="ref"``."""
    _check_chunk(g.shape[1], chunk)
    g = g.to(torch.float32)
    use_kernel = resolve_impl(impl, g, q, k, v) == "kernel"
    return LinearScanTrain.apply(g.contiguous(), q.contiguous(),
                                 k.contiguous(), v.contiguous(), chunk,
                                 use_kernel)


def ssd_mamba2(x, dt, A, B, C, *, chunk: int = 128, impl: str = "auto"):
    """x (Bt, S, nh, hd); dt (Bt, S, nh) post-softplus; A (nh,)
    negative; B, C (Bt, S, g, ds) -> y (Bt, S, nh, hd): the SSD sequence
    mix without the D-skip, in the dtype x * dt promotes to (f32 for a
    bf16 x and an f32 dt, as in JAX). Differentiable."""
    Bt, S, nh, hd = x.shape
    g_grp, ds = B.shape[2], B.shape[3]
    # fold dt into v; build the log-decays
    v = (x * dt[..., None]).permute(0, 2, 1, 3).reshape(Bt * nh, S, hd)
    gdec = (dt * A[None, None, :]).permute(0, 2, 1).reshape(Bt * nh, S)
    q = C.permute(0, 2, 1, 3).reshape(Bt * g_grp, S, ds)
    k = B.permute(0, 2, 1, 3).reshape(Bt * g_grp, S, ds)
    y = linear_scan_train(gdec, q, k, v, chunk=chunk, impl=impl)
    return y.reshape(Bt, nh, S, hd).permute(0, 2, 1, 3)


__all__ = ["LinearScanTrain", "linear_scan", "linear_scan_ref",
           "linear_scan_train", "scan_backward", "ssd_mamba2"]
