"""Decentralized AMB-DG (paper Sec. V): gossip consensus instead of a
master (the port of ``repro/core/consensus.py``).

Workers exchange ``m_i(0) = n (b_i z_i + g_i) / b(t)`` with their
neighbours for r rounds through a doubly-stochastic matrix Q; after
enough rounds every worker holds about ``z-bar + g(t) / b(t)``. Eq. (24)
lower-bounds the rounds needed for a consensus error delta:

    r >= ceil( log(2 sqrt(n) (1 + 2J/delta)) / (1 - lambda_2(Q)) )

A round is an ordered list of (neighbour index, weight) terms folded
left to right, ``x_i' = w_0 x_{nbr_0[i]} + w_1 x_{nbr_1[i]} + ...``. Two
executions share each fold's body and differ only in the gather:

  dense     ``run_consensus_fold*`` on the stacked (n, ...) per-worker
            values in one process: a term's gather indexes the stack;
  per rank  ``gossip_rounds_shard*`` (JAX's shard_map names) on this
            rank's (1, rows, 128) message, one worker a rank of the
            worker group: a term's gather is ``dist.collectives.permute``
            (receiver i takes sender nbr[i]'s value, JAX's ``ppermute``),
            its bytes tagged "gossip" in the census.

The self term gathers nothing in either. Each weighted term is its own
multiply and the fold its own adds, in stencil order from the first
term: eager PyTorch never contracts the two into an FMA, which is the
contract JAX pins with ``optimization_barrier``. So the two executions
agree bit for bit on the same messages, both equal JAX's fold run op by
op bit for bit, and the masked fold under the all-alive mask equals the
plain fold bit for bit.

The neighbour index tensors are built once per (topology, n, device) and
reused by every round (``_device_terms``): a round launches gathers,
multiplies and adds and never reads back to the host.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Communication matrices (numpy, the same values as JAX's)
# ---------------------------------------------------------------------------
def gossip_matrix(topology: str, n: int) -> np.ndarray:
    """Doubly stochastic and symmetric, Q_ij > 0 iff i = j or (i, j) is
    an edge."""
    if topology == "complete":
        Q = np.full((n, n), 1.0 / n)
    elif topology == "ring":
        Q = np.zeros((n, n))
        for i in range(n):
            Q[i, i] = 0.5
            Q[i, (i - 1) % n] += 0.25
            Q[i, (i + 1) % n] += 0.25
    elif topology == "torus":
        side = int(round(math.sqrt(n)))
        if side * side != n:
            raise ValueError(f"torus needs a square n, got {n}")
        Q = np.zeros((n, n))
        for i in range(n):
            r, c = divmod(i, side)
            Q[i, i] = 1.0 / 3.0
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % side) * side + (c + dc) % side
                Q[i, j] += 1.0 / 6.0
    else:
        raise ValueError(topology)
    assert np.allclose(Q.sum(0), 1.0) and np.allclose(Q.sum(1), 1.0)
    return Q


def lambda2(Q: np.ndarray) -> float:
    """Second-largest eigenvalue magnitude (it sets the spectral gap)."""
    ev = np.sort(np.abs(np.linalg.eigvalsh(Q)))[::-1]
    return float(ev[1])


def min_rounds(delta: float, n: int, J: float, lam2: float) -> int:
    """Paper eq. (24), never fewer than 1 round."""
    if lam2 >= 1.0:
        raise ValueError("graph not connected (lambda2 >= 1)")
    num = math.log(2.0 * math.sqrt(n) * (1.0 + 2.0 * J / delta))
    return max(int(math.ceil(num / (1.0 - lam2))), 1)


def run_consensus(values: torch.Tensor, Q, r: int) -> torch.Tensor:
    """values (n, d) per-worker messages -> Q^r @ values, r matmuls."""
    Qt = torch.as_tensor(np.asarray(Q), dtype=values.dtype).to(values.device)
    for _ in range(r):
        values = Qt @ values
    return values


def consensus_error(values: torch.Tensor) -> torch.Tensor:
    """Max deviation from the mean across workers (the paper's
    ||z_i - z||, eq. (24)'s delta target)."""
    mean = torch.mean(values, dim=0, keepdim=True)
    return torch.amax(torch.linalg.vector_norm(values - mean, dim=-1))


# ---------------------------------------------------------------------------
# The ordered stencil fold
# ---------------------------------------------------------------------------
def topology_stencil(topology: str, n: int):
    """Ordered (nbr, weight) terms for one round; ``nbr`` an (n,) int32
    array, term k adds ``weight * x[nbr[i]]`` to worker i. Ring and
    torus lead with the identity (self) term; the complete graph folds
    the n cyclic shifts. Duplicate neighbour terms (ring n = 2, torus
    side 2) merge into the first, their weights summed."""
    idx = np.arange(n)
    if topology == "complete":
        terms = [((idx + d) % n, 1.0 / n) for d in range(n)]
    elif topology == "ring":
        terms = [(idx, 0.5), ((idx - 1) % n, 0.25), ((idx + 1) % n, 0.25)]
    elif topology == "torus":
        side = int(round(math.sqrt(n)))
        if side * side != n:
            raise ValueError(f"torus needs a square n, got {n}")
        r, c = np.divmod(idx, side)
        terms = [(idx, 1.0 / 3.0)]
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            terms.append((((r + dr) % side) * side + (c + dc) % side,
                          1.0 / 6.0))
    else:
        raise ValueError(topology)
    merged = []
    for nbr, w in terms:
        nbr = np.asarray(nbr, np.int32)
        for k, (prev, pw) in enumerate(merged):
            if np.array_equal(prev, nbr):
                merged[k] = (prev, pw + w)
                break
        else:
            merged.append((nbr, float(w)))
    return [(nbr, float(w)) for nbr, w in merged]


def _stencil_matrix(topology: str, n: int) -> np.ndarray:
    """The doubly-stochastic matrix the stencil fold applies a round."""
    Q = np.zeros((n, n))
    for nbr, w in topology_stencil(topology, n):
        Q[np.arange(n), nbr] += w
    return Q


def _is_self_term(nbr: np.ndarray) -> bool:
    """Is this term the identity (worker i reads worker i)? Such a term
    skips the gather."""
    return bool((nbr == np.arange(nbr.shape[0])).all())


@functools.lru_cache(maxsize=None)
def _device_terms(topology: str, n: int, device: torch.device):
    """The stencil on ``device``: (index tensor or None for the self
    term, weight) per term, built once and shared by every round."""
    return tuple((None if _is_self_term(nbr) else
                  torch.as_tensor(nbr.astype(np.int64)).to(device), w)
                 for nbr, w in topology_stencil(topology, n))


def stencil_on(topology: str, n: int, device):
    """``_device_terms`` for a device given as a string or a device (a
    bare "cuda" means the current card, as a tensor's device names it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _device_terms(topology, n, device)


def _gather(x: torch.Tensor, nbr) -> torch.Tensor:
    return x if nbr is None else torch.index_select(x, 0, nbr)


@functools.lru_cache(maxsize=None)
def _rank_terms(topology: str, n: int):
    """The stencil for the per-rank route: (None for the self term, else
    the permutation as a tuple of source ranks, weight) per term."""
    return tuple((None if _is_self_term(nbr) else
                  tuple(int(i) for i in nbr), w)
                 for nbr, w in topology_stencil(topology, n))


def _rank_gather(group):
    """The per-rank route's gather: each term is one ``permute`` over
    the worker group."""
    from repro_torch.dist.collectives import permute
    return lambda x, perm: (x if perm is None else
                            permute(x, group, perm, axis="worker",
                                    tag="gossip"))


def _fold_round(x, terms, gather=_gather):
    """One fold: each term ``w * x[nbr]`` its own multiply (a Python
    float weight is rounded to f32 as JAX's weak-typed constant is),
    summed left to right from the first term."""
    acc = None
    for nbr, w in terms:
        term = w * gather(x, nbr)
        acc = term if acc is None else acc + term
    return acc


def gossip_round_dense(values: torch.Tensor, topology: str) -> torch.Tensor:
    """One stencil-fold round on stacked (n, ...) per-worker values."""
    return _fold_round(values, stencil_on(topology, values.shape[0],
                                          values.device))


def run_consensus_fold(values: torch.Tensor, topology: str, r: int
                       ) -> torch.Tensor:
    """r stencil-fold rounds; equal to ``run_consensus(values,
    gossip_matrix(topology, n), r)`` up to the matmul's summation
    order. r = 0 returns ``values``."""
    terms = stencil_on(topology, values.shape[0], values.device)
    for _ in range(r):
        values = _fold_round(values, terms)
    return values


def gossip_round_shard(x: torch.Tensor, group, topology: str, n: int
                       ) -> torch.Tensor:
    """One round for this rank's worker ``x`` (1, ...) over the worker
    group of ``n`` ranks (rank i is worker i): the dense round's terms,
    each neighbour's value from a ``permute``."""
    return _fold_round(x, _rank_terms(topology, n), _rank_gather(group))


def gossip_rounds_shard(x: torch.Tensor, group, topology: str, n: int,
                        rounds: int) -> torch.Tensor:
    """``rounds`` per-rank rounds; bit for bit the dense
    ``run_consensus_fold``'s row of this worker."""
    for _ in range(rounds):
        x = gossip_round_shard(x, group, topology, n)
    return x


# ---------------------------------------------------------------------------
# Mask-aware gossip: elastic worker sets (core.worker_process)
# ---------------------------------------------------------------------------
# A dead source's weight moves to the receiver's self term:
#
#     w_eff_k[i]    = w_k * active[nbr_k[i]]          (non-self terms)
#     w_eff_self[i] = w_self + sum_k w_k * (1 - active[nbr_k[i]])
#
# Every receiver's row still sums to 1 and, Q being symmetric, the alive
# block stays doubly stochastic: the alive workers agree on the mean of
# the alive messages. Under the all-alive mask every w_eff is w times an
# exact 1 plus exact-zero residues, so the masked fold is the plain fold
# bit for bit.
def _masked_term_weights(terms, a):
    """Per-term effective weights ((n,) f32 each) for the (n,) 0/1 f32
    mask ``a``; residues accumulate in stencil order."""
    self_k = [k for k, (nbr, _) in enumerate(terms) if nbr is None]
    if not self_k:
        raise ValueError("masked gossip needs a self term to absorb dead "
                         "neighbours' weight (every registered topology "
                         "has one: Q_ii > 0)")
    w_effs = [None] * len(terms)
    extra = None
    for k, (nbr, w) in enumerate(terms):
        if k == self_k[0]:
            continue
        src = _gather(a, nbr)
        w_effs[k] = w * src
        residue = w * (1.0 - src)
        extra = residue if extra is None else extra + residue
    w_self = torch.full((), terms[self_k[0]][1], dtype=torch.float32,
                        device=a.device)
    w_effs[self_k[0]] = w_self if extra is None else w_self + extra
    return w_effs


def _masked_fold_round(x, terms, w_effs, gather=_gather):
    """The plain fold with each weight replaced by its per-receiver
    effective weight, broadcast over the trailing dims."""
    acc = None
    for (nbr, _), w_eff in zip(terms, w_effs):
        v = gather(x, nbr)
        w = w_eff.reshape(tuple(w_eff.shape) + (1,) * (v.dim() - w_eff.dim()))
        term = w * v
        acc = term if acc is None else acc + term
    return acc


def gossip_round_dense_masked(values: torch.Tensor, topology: str,
                              active: torch.Tensor) -> torch.Tensor:
    """One masked round on stacked (n, ...) values; ``active`` the (n,)
    0/1 mask (f32 or bool)."""
    return run_consensus_fold_masked(values, topology, 1, active)


def run_consensus_fold_masked(values: torch.Tensor, topology: str, r: int,
                              active: torch.Tensor) -> torch.Tensor:
    """r masked rounds (the mask is constant across the rounds of one
    exchange); the plain fold bit for bit under the all-alive mask."""
    terms = stencil_on(topology, values.shape[0], values.device)
    w_effs = _masked_term_weights(terms, active.to(values.dtype))
    for _ in range(r):
        values = _masked_fold_round(values, terms, w_effs)
    return values


def gossip_round_shard_masked(x: torch.Tensor, group, topology: str,
                              n: int, active: torch.Tensor
                              ) -> torch.Tensor:
    """One masked round for this rank's worker ``x`` (1, ...):
    ``active`` is the whole (n,) mask; the rank takes its own term
    weights from it at its rank (JAX's ``axis_index``)."""
    return gossip_rounds_shard_masked(x, group, topology, n, 1, active)


def gossip_rounds_shard_masked(x: torch.Tensor, group, topology: str,
                               n: int, rounds: int, active: torch.Tensor
                               ) -> torch.Tensor:
    """``rounds`` masked per-rank rounds; bit for bit the dense
    ``run_consensus_fold_masked``'s row of this worker. The effective
    weights are the dense fold's ((n,) each, the same ops on the same
    mask) at this rank."""
    import torch.distributed as dist
    i = dist.get_rank(group)
    w_effs = [w if w.dim() == 0 else w[i:i + 1]
              for w in _masked_term_weights(
                  stencil_on(topology, n, x.device), active.to(x.dtype))]
    terms, gather = _rank_terms(topology, n), _rank_gather(group)
    for _ in range(rounds):
        x = _masked_fold_round(x, terms, w_effs, gather)
    return x


def consensus_error_masked(values: torch.Tensor, active: torch.Tensor
                           ) -> torch.Tensor:
    """Max deviation from the alive mean across the alive workers; an
    all-dead epoch reports exact 0."""
    a = active.to(values.dtype).reshape(-1, 1)
    n_alive = torch.clamp(torch.sum(a), min=1.0)
    mean = torch.div(torch.sum(values * a, dim=0, keepdim=True), n_alive)
    return torch.amax(torch.linalg.vector_norm((values - mean) * a, dim=-1))


# ---------------------------------------------------------------------------
# int8-compressed gossip with per-round error feedback
# ---------------------------------------------------------------------------
# Each round every worker sends its value quantized to int8 with per-row
# bf16 scales, and keeps the quantization error in a residual it feeds
# into the next round's message, so the sent stream telescopes:
#
#     fed_k = v_k + r_k;  d_k = dequant(quant(fed_k));  r_{k+1} = fed_k - d_k
#     =>  sum_k d_k + r_final = sum_k v_k + r_initial     (exactly)
#
# The fold runs on the dequantized messages, the self term included, with
# the stencil weight folded into each gathered row scale,
# ``q * bf16(w * s)``: every product in the round is exact in f32.
def _ef_compress_round_int8(v, res):
    """(value, residual) -> (q int8, scales bf16, new residual)."""
    from repro_torch.optim.compression import (dequantize_int8_rows,
                                               quantize_int8_rows)
    fed = v + res
    q, scales = quantize_int8_rows(fed, scale_dtype=torch.bfloat16)
    return q, scales, fed - dequantize_int8_rows(q, scales)


def _weighted_scale(w: float, scales: torch.Tensor) -> torch.Tensor:
    """``bf16(f32(w) * f32(s))`` as f32: a compressed term's scale."""
    ws = w * scales.to(torch.float32)
    return ws.to(torch.bfloat16).to(torch.float32)


def _fold_round_compressed(q, scales, terms, gather=_gather):
    """The fold on the wire payload: each receiver gathers (q, scales)
    and adds ``q.f32 * bf16(w * s)`` term by term."""
    acc = None
    for nbr, w in terms:
        term = (gather(q, nbr).to(torch.float32)
                * _weighted_scale(w, gather(scales, nbr))[..., None])
        acc = term if acc is None else acc + term
    return acc


def gossip_round_dense_int8(values: torch.Tensor, residual: torch.Tensor,
                            topology: str):
    """One compressed round on stacked (n, rows, lanes) values. Returns
    (values', residual')."""
    q, scales, res_new = _ef_compress_round_int8(values, residual)
    terms = stencil_on(topology, values.shape[0], values.device)
    return _fold_round_compressed(q, scales, terms), res_new


def run_consensus_fold_int8(values: torch.Tensor, residual: torch.Tensor,
                            topology: str, r: int):
    """r compressed rounds; r = 0 is the identity (nothing is quantized,
    the residual is untouched)."""
    terms = stencil_on(topology, values.shape[0], values.device)
    for _ in range(r):
        q, scales, residual = _ef_compress_round_int8(values, residual)
        values = _fold_round_compressed(q, scales, terms)
    return values, residual


def gossip_round_shard_int8(x: torch.Tensor, res: torch.Tensor, group,
                            topology: str, n: int):
    """One compressed round for this rank's worker: each non-self term
    moves the int8 message and its bf16 row scales (as their 16 bits)
    through ``permute``. Returns (x', res')."""
    q, scales, res_new = _ef_compress_round_int8(x, res)
    return _fold_round_compressed(q, scales, _rank_terms(topology, n),
                                  _rank_gather(group)), res_new


def gossip_rounds_shard_int8(x: torch.Tensor, res: torch.Tensor, group,
                             topology: str, n: int, rounds: int):
    """``rounds`` compressed per-rank rounds, the residual carried
    across them; bit for bit the dense ``run_consensus_fold_int8``'s row
    of this worker."""
    for _ in range(rounds):
        x, res = gossip_round_shard_int8(x, res, group, topology, n)
    return x, res


# which gossip message-compression modes exist (ConsensusConfig.compression)
COMPRESSION_MODES = ("none", "int8")


def payload_bytes_per_round(topology: str, n: int, rows: int,
                            lanes: int = 128, compression: str = "none"
                            ) -> int:
    """Per-worker wire bytes of one round: every non-self term moves a
    whole message, rows * lanes f32, or rows * lanes int8 plus rows bf16
    scales under int8."""
    n_terms = sum(1 for nbr, _ in topology_stencil(topology, n)
                  if not _is_self_term(nbr))
    per_msg = (rows * lanes + rows * 2 if compression == "int8"
               else rows * lanes * 4)
    return n_terms * per_msg
