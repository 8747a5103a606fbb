"""Closed-form per-device wire models of the exchange paths (the port of
``repro/launch/wire_model.py``).

Each function returns ``{dtype: per-device wire bytes}``, split by the
payload's dtype in JAX's short names ("f32", "s8", "u16"), with the ring
algorithm's integer formulas:

  all-reduce  2 (n-1)/n * P        all-gather  (n-1)/n * P_gathered

``dist.collectives`` adds every call's bytes to its census with the same
formulas, so a run holds census == model with ``==``, no tolerance.

``master_pod_exchange_bytes``  the fixed-delay ring pop across the
    ``pod`` axis. int8: one s8 all-gather of the due slot and one f32
    all-gather of its row scales, then a local fold
    (``ring_slot_rotate_int8_sharded``). Uncompressed: one f32
    all-reduce of the slot.

``variable_pod_exchange_bytes``  the delay-tolerant (v3) ring pop: each
    pod folds its due slots locally and ships one f32 all-reduce, int8
    or not (``ring_variable_pop_sharded``).

``gossip_round_bytes``  one decentralized gossip round a worker: its
    total is ``consensus.payload_bytes_per_round``, split s8 payload /
    bf16 scales as their u16 bits under int8.

``publish_pop_bytes``  the weight publication's pop: the s8 snapshot
    and its bf16 scales (as u16 bits) all-gathered over the shards.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import consensus

LANES = 128


def _allreduce(n: int, p_bytes: int) -> int:
    return 2 * (n - 1) * p_bytes // max(n, 1)


def _allgather(n: int, gathered_bytes: int) -> int:
    return (n - 1) * gathered_bytes // max(n, 1)


def master_pod_exchange_bytes(rows: int, n_pods: int, compression: str,
                              lanes: int = LANES) -> Dict[str, int]:
    """The fixed-delay ring pop across the pod axis, per device."""
    if n_pods <= 1:
        return {}
    if compression == "int8":
        return {
            # s8 all-gather of the due slot: gathered (n_pods, rows, lanes)
            "s8": _allgather(n_pods, n_pods * rows * lanes),
            # f32 all-gather of its row scales: (n_pods, rows)
            "f32": _allgather(n_pods, n_pods * rows * 4),
        }
    # uncompressed: one f32 all-reduce of the (rows, lanes) slot
    return {"f32": _allreduce(n_pods, rows * lanes * 4)}


def variable_pod_exchange_bytes(rows: int, n_pods: int,
                                lanes: int = LANES) -> Dict[str, int]:
    """The delay-tolerant (v3) ring pop: one f32 all-reduce of the
    locally folded due rows, whatever the compression."""
    if n_pods <= 1:
        return {}
    return {"f32": _allreduce(n_pods, rows * lanes * 4)}


def gossip_round_bytes(topology: str, n_workers: int, rows: int,
                       compression: str = "none",
                       lanes: int = LANES) -> Dict[str, int]:
    """One gossip round a worker, split by wire dtype. The total equals
    ``consensus.payload_bytes_per_round`` (asserted, so the two models
    cannot drift apart)."""
    total = consensus.payload_bytes_per_round(
        topology, n_workers, rows, lanes=lanes, compression=compression)
    n_terms = sum(1 for nbr, _ in
                  consensus.topology_stencil(topology, n_workers)
                  if not consensus._is_self_term(nbr))
    if compression == "int8":
        out = {"s8": n_terms * rows * lanes,   # the quantized message
               "u16": n_terms * rows * 2}      # bf16 scales as u16 bits
    else:
        out = {"f32": n_terms * rows * lanes * 4}
    assert sum(out.values()) == total, (out, total)
    return out


def publish_pop_bytes(rows: int, n_shards: int,
                      lanes: int = LANES) -> Dict[str, int]:
    """The publication pop: the flat-sharded s8 snapshot and its bf16
    scales (as their u16 bits) gathered to every server device, per
    device."""
    if n_shards <= 1:
        return {}
    return {
        "s8": _allgather(n_shards, rows * lanes),
        "u16": _allgather(n_shards, rows * 2),
    }
