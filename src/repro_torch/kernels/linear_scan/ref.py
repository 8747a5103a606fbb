"""Plain PyTorch version of the chunked linear scan: the twin of
``repro/kernels/linear_scan/ref.py``, the naive step-by-step recurrence

    h_t = exp(g_t) h_{t-1} + k_t v_t^T ;  y_t = q_t^T h_t

with an f32 state. It is the oracle the CUDA kernel is held against,
and what the wrappers run on CPU tensors."""
from __future__ import annotations

import torch


def linear_scan_ref(g, q, k, v, strict: bool = False, chunk=None):
    """g: (BH, S); q, k: (BHG, S, ds) (group-shared: head bh reads group
    bh // (BH // BHG)); v: (BH, S, hd) -> y (BH, S, hd) in v's dtype.
    ``strict`` leaves step t's own term out of y_t:
    y_t = q_t^T (h_t - k_t v_t^T) (the backward's form). Given ``chunk``,
    returns (y, y_inter): y_inter (f32) the part of y_t that comes from
    the steps before t's chunk, q_t^T exp(G_t - G_{c0-1}) h_{c0-1} for the
    chunk starting at c0."""
    BH, S = g.shape
    rep = BH // q.shape[0]
    qf = torch.repeat_interleave(q, rep, dim=0).to(torch.float32)
    kf = torch.repeat_interleave(k, rep, dim=0).to(torch.float32)
    vf = v.to(torch.float32)
    decay = torch.exp(g.to(torch.float32))
    h = torch.zeros((BH, qf.shape[-1], vf.shape[-1]), dtype=torch.float32,
                    device=v.device)
    ys, inter = [], []
    for t in range(S):
        if chunk and t % chunk == 0:       # the state entering the chunk
            h_in, dec = h, torch.ones_like(decay[:, t])
        h = decay[:, t, None, None] * h
        if chunk:
            dec = dec * decay[:, t]
            inter.append(dec[:, None] * torch.einsum("bs,bsd->bd", qf[:, t],
                                                     h_in))
        if strict:
            ys.append(torch.einsum("bs,bsd->bd", qf[:, t], h))
        h = h + kf[:, t, :, None] * vf[:, t, None, :]
        if not strict:
            ys.append(torch.einsum("bs,bsd->bd", qf[:, t], h))
    y = torch.stack(ys, dim=1).to(v.dtype)
    return (y, torch.stack(inter, dim=1)) if chunk else y
