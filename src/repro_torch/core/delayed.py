"""Delayed cross-pod gradient exchange: the pod reduction.

In the JAX package the pod dimension's sum is the cross-pod (DCN)
all-reduce that AMB-DG overlaps with compute. The port so far runs the
pods of one process on one device (the pod axis a written-out leading
dimension), where the reduction is the deterministic left fold that both
JAX master pipelines share off-mesh (``repro/core/delayed.py:64``). The
multi-GPU reduce is ROADMAP A.11.
"""
from __future__ import annotations


def pod_sum(x):
    """Left fold over the leading pod dimension: x[0] + x[1] + ... in
    that order (bitwise the JAX off-mesh ``pod_sum``). With one pod it
    returns the view ``x[0]``."""
    acc = x[0]
    for p in range(1, x.shape[0]):
        acc = acc + x[p]
    return acc
