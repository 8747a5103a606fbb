"""Carry parameters and master state from the JAX package to the port.

The functions take the JAX package's objects after ``jax.device_get``
(numpy leaves in the JAX containers: ``ArenaDualAveragingState``,
``DualAveragingState``, ``GradArena``, ``DelayBuffer``, ``TrainState``,
``DecentralizedState``)
and return the port's, so that both
frameworks can continue from one state. They read the containers by
attribute name and import nothing of the JAX package. Values are copied
exactly (same dtype, same bits; a bf16 array, which numpy knows only
through JAX's ``ml_dtypes``, by its raw bits).

``decode_state_from_jax`` carries a decode cache (KV caches, Mamba2
and xLSTM states, the encoder-decoder's memory K/V) across. The weight publisher needs no converter: its
``state_dict`` is the JAX publisher's format (numpy arrays, the bf16
scales as u16 bits), which both packages load.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ambdg import TrainState
from repro_torch.core.arena import GradArena, tree_flatten, tree_unflatten
from repro_torch.core.delayed import DelayBuffer
from repro_torch.core.dual_averaging import (ArenaDualAveragingState,
                                             DualAveragingState)
from repro_torch.core.strategy import DecentralizedState
from repro_torch.device import resolve_device


def to_tensor(x, device="cuda") -> torch.Tensor:
    """An exact copy of a numpy array (or array-like) as a tensor; a
    bf16 array (``ml_dtypes.bfloat16``) by its bits."""
    device = resolve_device(device)
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(params, device="cuda"):
    """A params tree (nested dicts of arrays) as tensors, same keys."""
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [to_tensor(l, device) for l in leaves])


def opt_state_from_jax(opt_state, device="cuda"):
    """``ArenaDualAveragingState(z, t)`` (z one array), or the pytree
    master's ``DualAveragingState(z, t)`` (z a tree of arrays)."""
    if isinstance(opt_state.z, dict):
        return DualAveragingState(z=params_from_jax(opt_state.z, device),
                                  t=to_tensor(opt_state.t, device))
    return ArenaDualAveragingState(z=to_tensor(opt_state.z, device),
                                   t=to_tensor(opt_state.t, device))


def buffer_from_jax(buffer, device="cuda"):
    """The pytree master's ``DelayBuffer``: grads, scales and residual
    trees (scales and residual None unless int8), counts and head. None
    stays None."""
    if buffer is None:
        return None

    def tree(x):
        return None if x is None else params_from_jax(x, device)

    return DelayBuffer(grads=tree(buffer.grads), scales=tree(buffer.scales),
                       residual=tree(buffer.residual),
                       counts=to_tensor(buffer.counts, device),
                       head=to_tensor(buffer.head, device))


def arena_from_jax(arena, device="cuda"):
    """A ``GradArena`` of any ring layout: v2 (slot and scales tuples,
    head mirroring the phase), v1 (one stacked ring, head its slot) or
    v3 (stacked, with the ``due``/``stale`` tags and the absolute step
    counter as head); residual, staging, counts and phase as they are.
    None stays None."""
    if arena is None:
        return None

    def opt(x):
        return None if x is None else to_tensor(x, device)

    def ring(xs):
        if isinstance(xs, (tuple, list)):      # v2: per-slot buffers
            return tuple(to_tensor(x, device) for x in xs)
        return opt(xs)                         # v1 / v3: stacked

    return GradArena(ring=ring(arena.ring), scales=ring(arena.scales),
                     residual=opt(arena.residual), staging=opt(arena.staging),
                     counts=to_tensor(arena.counts, device),
                     head=to_tensor(arena.head, device),
                     due=opt(arena.due), stale=opt(arena.stale),
                     phase=int(arena.phase))


def train_state_from_jax(state, device="cuda") -> TrainState:
    """A JAX ``TrainState`` of either master path (arena or pytree)."""
    return TrainState(params=params_from_jax(state.params, device),
                      opt_state=opt_state_from_jax(state.opt_state, device),
                      buffer=buffer_from_jax(state.buffer, device),
                      arena=arena_from_jax(state.arena, device),
                      step=to_tensor(state.step, device))


def decentralized_state_from_jax(state, device="cuda") -> DecentralizedState:
    """A JAX ``DecentralizedState``: the stacked per-worker params, z, the
    gossip residual, t and step."""
    return DecentralizedState(params=params_from_jax(state.params, device),
                              z=to_tensor(state.z, device),
                              residual=to_tensor(state.residual, device),
                              t=to_tensor(state.t, device),
                              step=to_tensor(state.step, device))


def decode_state_from_jax(cache, device="cuda"):
    """A JAX decode cache (``init_decode_state``'s tree: the KV cache
    {"k", "v"}; for the hybrid family {"mamba": {"ssm", "conv"},
    "shared": {"k", "v"}}; for the xLSTM {"mlstm": {"C", "n", "m"},
    "slstm": {"h", "c", "n", "m"}}; for the encoder-decoder {"self":
    {"k", "v"}, "mem_k", "mem_v"}), same keys, same dtypes and bits. The port
    updates it in place; JAX's Mamba2 ``conv`` state comes back from a
    step in the compute dtype, the port's stays in the dtype it was made
    in (the same values)."""
    return params_from_jax(cache, device)
