"""The port's closed-form wire models (``repro_torch.launch.wire_model``)
against the JAX package's (``repro.launch.wire_model``): every function,
on a grid of rows, pods, shards, topologies, worker counts and
compressions, equal with ``==`` (integer arithmetic both sides).
"""
import itertools

import pytest

from repro.launch import wire_model as jwm
from repro_torch.launch import wire_model as wm

ROWS = (1, 7, 256, 3_624_960)
PODS = (1, 2, 3, 4, 8)
COMPRESSIONS = ("none", "int8")
# (topology, worker counts): the torus needs a square
GOSSIP = [("ring", n) for n in (1, 2, 3, 4, 10)] + \
    [("complete", n) for n in (1, 2, 4, 6)] + \
    [("torus", n) for n in (1, 4, 9)]


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_master_pod_exchange_bytes_match_jax(compression):
    for rows, pods in itertools.product(ROWS, PODS):
        assert wm.master_pod_exchange_bytes(rows, pods, compression) == \
            jwm.master_pod_exchange_bytes(rows, pods, compression), \
            (rows, pods)


def test_variable_pod_exchange_bytes_match_jax():
    for rows, pods in itertools.product(ROWS, PODS):
        assert wm.variable_pod_exchange_bytes(rows, pods) == \
            jwm.variable_pod_exchange_bytes(rows, pods), (rows, pods)


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("topology,n", GOSSIP,
                         ids=[f"{t}-{n}" for t, n in GOSSIP])
def test_gossip_round_bytes_match_jax(topology, n, compression):
    for rows in ROWS:
        got = wm.gossip_round_bytes(topology, n, rows, compression)
        assert got == jwm.gossip_round_bytes(topology, n, rows,
                                             compression), rows
        assert sum(got.values()) == wm.consensus.payload_bytes_per_round(
            topology, n, rows, compression=compression)


def test_publish_pop_bytes_match_jax():
    for rows, shards in itertools.product(ROWS, PODS):
        assert wm.publish_pop_bytes(rows, shards) == \
            jwm.publish_pop_bytes(rows, shards), (rows, shards)


def test_ring_formulas_match_jax():
    for n, b in itertools.product((1, 2, 3, 4, 7, 16), (0, 1, 129, 10**9)):
        assert wm._allreduce(n, b) == jwm._allreduce(n, b)
        assert wm._allgather(n, b) == jwm._allgather(n, b)
