"""Seeded request arrival processes and the serve request queue of the
port (``repro/serve/request_queue.py``), host numpy: the same
``np.random`` streams, so both packages draw the same arrivals and
prompts from the same seed.

The serving twin of ``core.delay_process``: where the training side
draws one staleness ``tau_t`` per master step, the serving side draws
one arrival count per *decode step* — how many new requests hit the
engine while it advanced every active slot by one token. The same
contract applies:

  * every process is seeded (``numpy.random.default_rng``) and emits
    non-negative integer counts;
  * full state checkpoints through ``state_dict``/``load_state_dict``
    (restart exactness: the remaining arrival sequence AND the pending
    queue survive a server restart);
  * the tests replay a process against the queue-conservation oracle
    (``tests/test_torch_serve.py``), and the golden serve trace pins
    one seeded sequence exactly.

Two processes (``ServeConfig.arrival``):

  poisson   n_t ~ Poisson(arrival_rate): memoryless open-loop traffic,
            the standard load model for a request benchmark.
  bursty    2-state Gilbert-Elliott chain (the ``bursty`` delay
            process's shape applied to traffic instead of staleness):
            Poisson(arrival_rate) in the normal state,
            Poisson(burst_rate) inside a burst, with geometric dwell
            times (p_burst / p_exit).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Type

import numpy as np

from repro_torch.configs.base import ServeConfig


def resolve_arrival(cfg: ServeConfig) -> str:
    """Validate the arrival knobs; returns the process name. Every
    consumer goes through here (mirrors ``delay_process.resolve_bounds``
    — raise early with the full message, never mid-run)."""
    if cfg.arrival not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {cfg.arrival!r}; "
                         f"registered: {sorted(ARRIVAL_PROCESSES)}")
    if cfg.arrival_rate < 0.0 or cfg.burst_rate < 0.0:
        raise ValueError("arrival rates must be >= 0, got "
                         f"arrival_rate={cfg.arrival_rate}, "
                         f"burst_rate={cfg.burst_rate}")
    if not 0.0 <= cfg.p_burst <= 1.0 or not 0.0 <= cfg.p_exit <= 1.0:
        raise ValueError("bursty transition probabilities must be in "
                         f"[0, 1], got p_burst={cfg.p_burst}, "
                         f"p_exit={cfg.p_exit}")
    if not 1 <= cfg.prompt_len_min <= cfg.prompt_len_max:
        raise ValueError("need 1 <= prompt_len_min <= prompt_len_max, "
                         f"got [{cfg.prompt_len_min}, "
                         f"{cfg.prompt_len_max}]")
    return cfg.arrival


class ArrivalProcess:
    """One seeded per-step arrival-count sequence. Subclasses implement
    ``_draw()`` -> int; the base class owns seeding and checkpointable
    state (the contract of ``core.delay_process.DelayProcess``)."""

    name: str = "?"

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        resolve_arrival(cfg)
        self._rng = np.random.default_rng(cfg.seed)

    def _draw(self) -> int:
        raise NotImplementedError

    def next(self) -> int:
        """Draw the next arrival count (advances the seeded state)."""
        return max(int(self._draw()), 0)

    def sequence(self, n: int) -> np.ndarray:
        return np.asarray([self.next() for _ in range(n)], np.int64)

    # -- restart exactness -------------------------------------------------
    def state_dict(self) -> Dict:
        return {"rng": self._rng.bit_generator.state}

    def load_state_dict(self, s: Dict):
        self._rng.bit_generator.state = s["rng"]

    def __repr__(self):
        return (f"{type(self).__name__}(rate={self.cfg.arrival_rate}, "
                f"seed={self.cfg.seed})")


class PoissonArrival(ArrivalProcess):
    """Memoryless open-loop traffic: n_t ~ Poisson(arrival_rate)."""

    name = "poisson"

    def _draw(self) -> int:
        return int(self._rng.poisson(self.cfg.arrival_rate))


class BurstyArrival(ArrivalProcess):
    """Gilbert-Elliott traffic: a 2-state Markov chain with geometric
    dwell times. Normal state draws Poisson(arrival_rate), burst state
    Poisson(burst_rate). Transitions are drawn BEFORE the emission, so
    a burst entered at step t already floods step t (the convention of
    ``core.delay_process.BurstyDelay``)."""

    name = "bursty"

    def __init__(self, cfg: ServeConfig):
        super().__init__(cfg)
        self._in_burst = False

    def _draw(self) -> int:
        u = float(self._rng.random())
        if self._in_burst:
            self._in_burst = u >= self.cfg.p_exit
        else:
            self._in_burst = u < self.cfg.p_burst
        rate = (self.cfg.burst_rate if self._in_burst
                else self.cfg.arrival_rate)
        return int(self._rng.poisson(rate))

    def state_dict(self) -> Dict:
        s = super().state_dict()
        s["in_burst"] = bool(self._in_burst)
        return s

    def load_state_dict(self, s: Dict):
        super().load_state_dict(s)
        self._in_burst = bool(s.get("in_burst", False))


ARRIVAL_PROCESSES: Dict[str, Type[ArrivalProcess]] = {
    c.name: c for c in (PoissonArrival, BurstyArrival)}


def make_arrival_process(cfg: ServeConfig) -> ArrivalProcess:
    """Construct the process named by ``cfg.arrival`` (validates the
    config — every consumer goes through here)."""
    resolve_arrival(cfg)
    return ARRIVAL_PROCESSES[cfg.arrival](cfg)


@dataclasses.dataclass
class Request:
    """One inference request: prompt token ids + generation budget."""
    rid: int
    prompt: List[int]
    max_new: int


class RequestQueue:
    """Seeded open-loop request queue feeding the continuous-batching
    engine. ``step()`` draws one arrival count from the configured
    process and synthesizes that many requests (seeded prompt lengths
    in [prompt_len_min, prompt_len_max], token ids in [1, vocab));
    ``submit()`` enqueues an externally supplied prompt (the
    ``generate()`` compatibility path). The engine admits via ``pop()``
    whenever a slot frees.

    Conservation contract (the property suite's first invariant):
    every request that enters the queue is, at any instant, exactly one
    of pending / in flight / completed — ``submitted == len(queue) +
    in_flight + completed`` with the engine's counters."""

    def __init__(self, cfg: ServeConfig, vocab_size: int):
        self.cfg = cfg
        self.vocab_size = int(vocab_size)
        self.arrival = make_arrival_process(cfg)
        # prompt synthesis draws from its own stream so the arrival
        # sequence is invariant to prompt-length knobs
        self._prompt_rng = np.random.default_rng(cfg.seed + 1)
        self._pending: deque = deque()
        self.next_rid = 0
        self.submitted = 0

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, prompt: List[int], max_new: Optional[int] = None
               ) -> Request:
        req = Request(self.next_rid, [int(t) for t in prompt],
                      int(max_new if max_new is not None
                          else self.cfg.max_new))
        self.next_rid += 1
        self.submitted += 1
        self._pending.append(req)
        return req

    def step(self) -> int:
        """Advance the arrival process one decode step: draw n_t, then
        synthesize and enqueue n_t seeded requests. Returns n_t."""
        n = self.arrival.next()
        for _ in range(n):
            plen = int(self._prompt_rng.integers(
                self.cfg.prompt_len_min, self.cfg.prompt_len_max + 1))
            prompt = self._prompt_rng.integers(
                1, self.vocab_size, size=plen).tolist()
            self.submit(prompt)
        return n

    def pop(self) -> Optional[Request]:
        return self._pending.popleft() if self._pending else None

    # -- restart exactness -------------------------------------------------
    def state_dict(self) -> Dict:
        return {
            "arrival": self.arrival.state_dict(),
            "prompt_rng": self._prompt_rng.bit_generator.state,
            "pending": [(r.rid, list(r.prompt), r.max_new)
                        for r in self._pending],
            "next_rid": self.next_rid,
            "submitted": self.submitted,
        }

    def load_state_dict(self, s: Dict):
        self.arrival.load_state_dict(s["arrival"])
        self._prompt_rng.bit_generator.state = s["prompt_rng"]
        self._pending = deque(Request(rid, list(p), mn)
                              for rid, p, mn in s["pending"])
        self.next_rid = int(s["next_rid"])
        self.submitted = int(s["submitted"])
