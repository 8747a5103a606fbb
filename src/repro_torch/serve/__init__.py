"""Serving of the port: continuous batching and bounded-staleness
weight publication (``repro/serve``; see docs/serve.md)."""
from repro_torch.serve.engine import Engine, ServeStats, continuous_decode_step
from repro_torch.serve.publisher import WeightPublisher, publish_ring_slots
from repro_torch.serve.request_queue import (ARRIVAL_PROCESSES, Request,
                                             RequestQueue,
                                             make_arrival_process)

__all__ = [
    "ARRIVAL_PROCESSES",
    "Engine",
    "Request",
    "RequestQueue",
    "ServeStats",
    "WeightPublisher",
    "continuous_decode_step",
    "make_arrival_process",
    "publish_ring_slots",
]
