"""Continuous-batching serving engine of the port
(``repro/serve/engine.py``) over the unified model API.

Each cache slot holds one request at its own position: finished
sequences are evicted and new requests admitted from the queue every
decode step, so the batch never drains to its slowest member. One
``decode_step`` advances every slot; idle slots ride along under an
active mask (token 0 at position 0; their cache writes land in a column
the next occupant overwrites before it reads it).

Positions start at 0 on admit, so no padding exists (prompts are fed
one token a step) and the validity mask of a fresh sequence covers only
the columns it has written itself: a new occupant never attends to a
previous occupant's entries.

A step moves the slots' tokens, positions and active mask to the device
and reads one thing back, the next tokens, as the JAX engine does.
Weights arrive through the bounded-staleness channel
(``serve.publisher``): ``refresh_weights(now)`` pops the freshest due
``w = -alpha z`` snapshot and threads the observed staleness into
``ServeStats``.

On a mesh (an engine built under an entered ``launch.mesh.Mesh``, on
every rank of its world) the engine serves on JAX's serve profile
(``dist.tensor_parallel``'s decode layout), entering the mesh under
that profile for each of its calls: the model's init keeps the rank's
weight blocks (each leaf cut as it is drawn), the cache is the rank's
block, data rank d holding the slots [d B/D, (d+1) B/D) where ``data``
(D) divides the B slots (else every slot) and model rank m its heads;
each step feeds the rank's rows of the tokens, positions and active
mask, takes the argmax over every model rank's vocab block and gathers
the next tokens over ``data``, so every rank's host sees every slot.
The host's bookkeeping (the seeded queue, admits, evicts, stats) is
global and the same on every rank; pods run the same slots.
``refresh_weights`` cuts the popped whole tree to the rank's blocks.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arena import tree_flatten
from repro_torch.dist import tensor_parallel
from repro_torch.models.api import Model
from repro_torch.serve.request_queue import Request


@dataclasses.dataclass
class ServeStats:
    """Serve counters. Token counters count ACTIVE slots only: an idle
    slot riding under the mask processes no request token."""
    prefill_tokens: int = 0
    decode_tokens: int = 0
    steps: int = 0
    admitted: int = 0
    completed: int = 0
    # weight-publication channel (serve.publisher)
    publish_pops: int = 0
    publish_misses: int = 0
    staleness_last: Optional[int] = None
    staleness_sum: int = 0
    staleness_max: int = 0

    def staleness_mean(self) -> float:
        return self.staleness_sum / max(self.publish_pops, 1)


def continuous_decode_step(decode_fn, params, cache, tokens, pos, active,
                           rows=None):
    """One continuous-batching decode step.

    tokens (B, 1) int, the token each slot feeds; pos (B,) per-slot
    positions; active (B,) bool. Returns (next-token ids (B,) int32,
    the cache). Inactive slots emit 0. The argmax takes the first of
    equal maxima, as ``jnp.argmax`` does. Under an active mesh tokens,
    pos and active are the rank's rows ``rows`` (a
    ``tensor_parallel.SlotRows``) of the slots; the argmax spans every
    ``model`` rank's vocab block (``tensor_parallel.vocab_argmax``) and
    the next tokens of every slot are gathered over ``data``
    (``tensor_parallel.gather_slots``)."""
    logits, cache = decode_fn(params, cache, tokens, pos)
    nxt = tensor_parallel.vocab_argmax(
        logits[:, -1, :], tensor_parallel.model_axis()).to(torch.int32)
    nxt = torch.where(active, nxt, torch.zeros_like(nxt))
    if rows is not None:
        nxt = tensor_parallel.gather_slots(nxt, rows)
    return nxt, cache


def _make_slot_reset(caxes):
    """Admit-time cache reset: the init template's values on the batch
    rows of the freshly admitted slots, for any decode-state tree (KV,
    SSM recurrent state, hybrid), each leaf's batch axis read from the
    logical-axes tree. Only the admitted rows are copied, in place. On
    a mesh ``admit`` is the rank's rows of the admit mask (the rows of
    its block of the cache)."""
    axes, _ = tree_flatten(caxes)

    def reset(cache, cache0, admit: np.ndarray):
        leaves, _ = tree_flatten(cache)
        leaves0, _ = tree_flatten(cache0)
        idx = None
        for c, c0, ax in zip(leaves, leaves0, axes):
            if "batch" not in ax:
                continue
            if idx is None:
                idx = torch.as_tensor(np.flatnonzero(admit),
                                      device=c.device)
            dim = ax.index("batch")
            c.index_copy_(dim, idx, c0.index_select(dim, idx))
        return cache

    return reset


class _StaticQueue:
    """Minimal queue protocol (pop/__len__) over a fixed request list:
    the ``generate()`` path."""

    def __init__(self, reqs):
        self._pending = deque(reqs)

    def __len__(self):
        return len(self._pending)

    def pop(self) -> Optional[Request]:
        return self._pending.popleft() if self._pending else None


class Engine:
    """Continuous batched decoding with a shared fixed-slot cache on the
    model's device.

    ``step(queue)`` admits from the queue into free slots, advances
    every slot one token under the active mask, then evicts finished
    sequences, returning an event record (admits/evicts/active) that the
    golden serve trace pins. ``serve(queue, n)`` drives the seeded
    arrival process for n steps. The engine's own weights are the
    model's init from a CPU generator seeded ``seed`` (under a mesh the
    rank's blocks of it)."""

    def __init__(self, model: Model, batch_slots: int, max_len: int,
                 seed: int = 0):
        from repro_torch.dist.context import active_device_mesh, active_mesh
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.slots = batch_slots
        self.max_len = max_len
        # the mesh the engine was built under (its config and DeviceMesh)
        self._mesh = ((active_mesh(), active_device_mesh())
                      if active_device_mesh() is not None else None)
        with self._serving():
            # this rank's rows of the slots
            self.rows = tensor_parallel.slot_rows(batch_slots)
            self.params = model.init(torch.Generator().manual_seed(seed))
            self.cache, self.caxes = model.init_decode_state(batch_slots,
                                                             max_len)
            # the init template for admit-time slot resets
            self._cache0, _ = model.init_decode_state(batch_slots, max_len)
            # how a popped whole tree is cut to the rank's blocks
            self._cut = None
            if tensor_parallel.model_axis() is not None:
                from repro_torch.core.arena import make_layout
                self._cut = tensor_parallel.model_dims(
                    self.cfg, make_layout(model.whole_param_shapes()),
                    model.param_axes(), self._mesh[0])
        self._reset = _make_slot_reset(self.caxes)
        # per-slot host state
        self._req: List[Optional[Request]] = [None] * batch_slots
        self._n_fed = np.zeros((batch_slots,), np.int64)   # tokens fed
        self._emitted = np.zeros((batch_slots,), np.int64)
        self._next_tok = np.zeros((batch_slots,), np.int64)
        self._out: List[List[int]] = [[] for _ in range(batch_slots)]
        self.completions: List[Tuple[int, List[int]]] = []
        self.publisher = None
        self.stats = ServeStats()

    def _serving(self):
        """The mesh the engine was built under, entered on the serve
        profile (nothing without one)."""
        stack = contextlib.ExitStack()
        if self._mesh is not None:
            from repro_torch.dist.context import (sharding_profile,
                                                  use_device_mesh)
            mesh_cfg, device_mesh = self._mesh
            stack.enter_context(sharding_profile(mesh_cfg, "serve"))
            stack.enter_context(use_device_mesh(device_mesh))
        return stack

    # -- weight publication ------------------------------------------------
    def attach_publisher(self, publisher):
        self.publisher = publisher

    def refresh_weights(self, now: int) -> Optional[int]:
        """Pop the freshest due snapshot at master step ``now``; swap it
        in and return the observed staleness, or None on a miss (the
        engine keeps serving its previous weights, so every served
        snapshot satisfies the bound). At ``model > 1`` the popped tree
        is the whole one: the engine keeps the rank's blocks of it."""
        if self.publisher is None:
            return None
        params, stale = self.publisher.pop(now)
        if params is None:
            self.stats.publish_misses += 1
            return None
        if self._cut is not None:
            with self._serving():
                params = tensor_parallel.cut_params(
                    params, self._cut, tensor_parallel.model_axis())
        self.params = params
        self.stats.publish_pops += 1
        self.stats.staleness_last = stale
        self.stats.staleness_sum += stale
        self.stats.staleness_max = max(self.stats.staleness_max, stale)
        return stale

    # -- scheduling --------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return sum(r is not None for r in self._req)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def step(self, queue=None) -> Dict:
        """One engine step: admit -> decode -> evict. Returns the event
        record pinned by the golden serve trace."""
        t = self.stats.steps
        admits, evicts = [], []
        admit_mask = np.zeros((self.slots,), bool)
        if queue is not None:
            for i in range(self.slots):
                if self._req[i] is not None:
                    continue
                req = queue.pop()
                if req is None:
                    break
                self._req[i] = req
                self._n_fed[i] = 0
                self._emitted[i] = 0
                self._out[i] = list(req.prompt)
                self._next_tok[i] = req.prompt[0]
                admit_mask[i] = True
                admits.append(req.rid)
                self.stats.admitted += 1
        mine = self.rows.of(admit_mask)
        if mine.any():
            self.cache = self._reset(self.cache, self._cache0, mine)
        active = np.array([r is not None for r in self._req])
        self.stats.steps += 1
        if not active.any():
            return {"step": t, "admits": admits, "evicts": [],
                    "active": 0,
                    "queued": len(queue) if queue is not None else 0}
        toks = np.where(active, self._next_tok, 0).astype(np.int32)
        pos = np.where(active, self._n_fed, 0).astype(np.int32)
        rows = self.rows
        with torch.no_grad(), self._serving():
            nxt, self.cache = continuous_decode_step(
                self.model.decode_step, self.params, self.cache,
                self._to_device(rows.of(toks)[:, None]),
                self._to_device(rows.of(pos)),
                self._to_device(rows.of(active)), rows)
        nxt = nxt.cpu().numpy()          # the step's one read back
        for i in range(self.slots):
            req = self._req[i]
            if req is None:
                continue
            fed = int(self._n_fed[i])
            self._n_fed[i] = fed + 1
            if fed < len(req.prompt) - 1:
                # still consuming the prompt: the model's prediction is
                # discarded, the next prompt token is fed instead
                self.stats.prefill_tokens += 1
                self._next_tok[i] = req.prompt[fed + 1]
            else:
                self.stats.decode_tokens += 1
                tok = int(nxt[i])
                self._out[i].append(tok)
                self._emitted[i] += 1
                self._next_tok[i] = tok
            if (self._emitted[i] >= req.max_new
                    or self._n_fed[i] >= self.max_len):
                self.completions.append((req.rid, self._out[i]))
                evicts.append(req.rid)
                self.stats.completed += 1
                self._req[i] = None
        return {"step": t, "admits": admits, "evicts": evicts,
                "active": int(active.sum()),
                "queued": len(queue) if queue is not None else 0}

    def serve(self, queue, n_steps: int) -> List[Dict]:
        """Drive the seeded arrival process for ``n_steps`` engine
        steps; returns the event trace."""
        trace = []
        for _ in range(n_steps):
            arrived = queue.step()
            ev = self.step(queue)
            ev["arrived"] = arrived
            trace.append(ev)
        return trace

    def generate(self, prompts: List[List[int]], max_new: int
                 ) -> List[List[int]]:
        """Greedy generation over the continuous engine: each prompt runs
        in its own slot from position 0, with no padding."""
        if len(prompts) > self.slots:
            raise ValueError(f"{len(prompts)} prompts for {self.slots} "
                             "slots")
        q = _StaticQueue(
            Request(rid=i, prompt=[int(t) for t in p], max_new=max_new)
            for i, p in enumerate(prompts))
        done_before = len(self.completions)
        while len(q) or self.in_flight:
            self.step(q)
        outs = dict(self.completions[done_before:])
        return [outs[i] for i in range(len(prompts))]
