"""Bounded-staleness weight publication of the port
(``repro/serve/publisher.py``): the master -> server channel.

The paper's delayed-consumer argument (Agarwal-Duchi) says consumers of
stale ``w = -alpha z`` make optimal progress as long as the staleness
is bounded, and an inference server reading asynchronously published
master snapshots is such a consumer. The channel reuses the training
side's pieces:

  * snapshots live in the arena's ``(rows, 128)`` layout
    (``core.arena.make_layout`` / ``flatten_tree``), so a publish is
    one flatten and a pop one gather;
  * the wire format is the gossip path's int8 rows with bf16 scales
    (``optim.compression.quantize_int8_rows(scale_dtype=bfloat16)``,
    the same function), so published weights dequantize bit for bit
    like the compressed gossip payload on the same rows, and every
    ``q * scale`` product is exact in f32;
  * with ``n_slots = staleness_bound // publish_period + 1`` slots and
    one publish a period, the snapshot a publish overwrites is
    ``n_slots * publish_period > staleness_bound`` steps old: expired,
    never due. No servable snapshot is overwritten.

``pop(now)`` returns the freshest snapshot whose age ``now -
published_step`` lies in ``[0, staleness_bound]`` and that age; when
none is due it reports a miss and the server keeps its weights, so a
served snapshot always satisfies the bound.

The int8 ring and the bf16 scales live on the device; the publish
steps and the counters on the host. ``state_dict`` is the JAX
publisher's format (numpy arrays, the scales as their raw u16 bits), so
the state of either package's publisher loads into the other's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.core import arena as arena_mod
from repro_torch.device import resolve_device
from repro_torch.optim.compression import (dequantize_int8_rows,
                                           quantize_int8_rows)


def publish_ring_slots(cfg: ServeConfig) -> int:
    """Ring depth for the no-unread-overwrite property (see the module
    docstring); validates the serve knobs."""
    if cfg.publish_period < 1:
        raise ValueError("publisher needs publish_period >= 1 "
                         f"(0 disables the channel), got "
                         f"{cfg.publish_period}")
    if cfg.staleness_bound < 0:
        raise ValueError(f"staleness_bound must be >= 0, got "
                         f"{cfg.staleness_bound}")
    return cfg.staleness_bound // cfg.publish_period + 1


def _bits_of(scales: torch.Tensor) -> np.ndarray:
    """bf16 scales as their raw bits, a numpy u16 array."""
    return scales.detach().cpu().view(torch.int16).numpy().view(
        np.uint16).copy()


def _scales_of(bits, device) -> torch.Tensor:
    i16 = np.array(bits, np.uint16).view(np.int16)
    return torch.from_numpy(i16).view(torch.bfloat16).to(device)


class WeightPublisher:
    """Master-side publish and server-side pop over one bounded-staleness
    ring of int8 ``w`` snapshots, on ``device`` ("cuda" unless the
    caller asks for the CPU).

    ``layout`` is the arena layout of the published parameter tree
    (``arena.make_layout``; the train loop builds it from the model's
    ``meta`` tensors)."""

    def __init__(self, layout: arena_mod.ArenaLayout, cfg: ServeConfig,
                 device="cuda"):
        self.layout = layout
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = publish_ring_slots(cfg)
        rows = layout.rows
        self.ring = torch.zeros((self.n_slots, rows, arena_mod.LANES),
                                dtype=torch.int8, device=self.device)
        self.scales = torch.ones((self.n_slots, rows), dtype=torch.bfloat16,
                                 device=self.device)
        # master step each slot was published at; -1 = never written
        self.pub_step = np.full((self.n_slots,), -1, np.int64)
        self.seq = 0                       # total publishes
        self.pops = 0                      # successful (due) pops
        self.misses = 0                    # pops with nothing due

    # -- master side -------------------------------------------------------
    def publish(self, params, step: int) -> int:
        """Push one ``w`` snapshot taken at master step ``step`` into the
        slot the publish sequence number names (the expired one, module
        docstring). Returns the slot."""
        w = arena_mod.flatten_tree(self.layout, params)
        q, s = quantize_int8_rows(w, scale_dtype=torch.bfloat16)
        k = self.seq % self.n_slots
        self.ring[k].copy_(q)
        self.scales[k].copy_(s)
        self.pub_step[k] = int(step)
        self.seq += 1
        return k

    # -- server side -------------------------------------------------------
    def due_slot(self, now: int) -> Optional[int]:
        """Freshest slot whose age at master step ``now`` is within the
        bound, or None."""
        ages = now - self.pub_step
        ok = (self.pub_step >= 0) & (ages >= 0) & \
            (ages <= self.cfg.staleness_bound)
        if not ok.any():
            return None
        return int(np.flatnonzero(ok)[np.argmax(self.pub_step[ok])])

    def dequantize(self, k: int) -> Dict:
        """Slot ``k`` as a parameter tree in the layout's dtypes."""
        w = dequantize_int8_rows(self.ring[k], self.scales[k])
        return arena_mod.unflatten_tree(self.layout, w, cast=True)

    def pop(self, now: int) -> Tuple[Optional[Dict], Optional[int]]:
        """(params tree, observed staleness in master steps) of the
        freshest due snapshot, or (None, None) when nothing is due: the
        server keeps serving its previous weights, so every served
        snapshot satisfies the bound."""
        k = self.due_slot(now)
        if k is None:
            self.misses += 1
            return None, None
        self.pops += 1
        return self.dequantize(k), int(now - self.pub_step[k])

    # -- restart exactness -------------------------------------------------
    def state_dict(self) -> Dict:
        return {
            "ring": self.ring.detach().cpu().numpy().copy(),
            # numpy has no bf16: the raw bits, as the wire carries them
            "scales_bits": _bits_of(self.scales),
            "pub_step": self.pub_step.copy(),
            "seq": self.seq, "pops": self.pops, "misses": self.misses,
        }

    def load_state_dict(self, s: Dict):
        ring = torch.from_numpy(np.array(s["ring"], np.int8))
        self.ring = ring.to(self.device)
        self.scales = _scales_of(s["scales_bits"], self.device)
        self.pub_step = np.asarray(s["pub_step"], np.int64).copy()
        self.seq = int(s["seq"])
        self.pops = int(s.get("pops", 0))
        self.misses = int(s.get("misses", 0))
