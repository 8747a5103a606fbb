"""The port's serving path (``repro_torch.serve``: the request queue,
the continuous-batching engine, the weight publisher, ``api.serve``)
against the JAX package's (``repro.serve``), at the SMOKE widths.

  * the queue: both arrival processes draw JAX's arrival counts and
    prompts over 200 steps, exactly; the state round-trips mid-run, JAX's
    state loads into the port; conservation holds at every step;
  * the engine: ``generate`` in f32 compute gives JAX's tokens exactly
    (qwen1.5-0.5b and zamba2-2.7b, JAX's weights carried across, the KV
    cache in f32 in both: a bf16 cache can flip one rounding, ROADMAP
    C.13); ragged prompts decode the same batched as alone; the stats
    count active slots only; greedy decoding repeats; the golden serve
    trace (``tests/golden/serve_trace.json``) is exact;
  * the publisher: the ring's int8 bytes and bf16 scale bits equal JAX's
    publisher on the same params bit for bit, and so do the popped
    trees; the port's gossip quantizer gives the same bits; the
    staleness bound holds and no servable slot is overwritten; the
    ``state_dict`` goes both ways between the packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.configs.base import ServeConfig as JServeConfig
from repro.core.arena import make_layout as jmake_layout
from repro.models import build_model as jbuild_model
from repro.serve import Engine as JEngine
from repro.serve import RequestQueue as JRequestQueue
from repro.serve import WeightPublisher as JWeightPublisher
from repro.serve import make_arrival_process as jmake_arrival_process
from repro_torch import api, convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig, ServeConfig, TRAIN_4K
from repro_torch.core.arena import (flatten_tree, make_layout, tree_flatten,
                                    tree_map)
from repro_torch.models.api import build_model
from repro_torch.optim.compression import (dequantize_int8_rows,
                                           quantize_int8_rows)
from repro_torch.serve import (Engine, RequestQueue, WeightPublisher,
                               make_arrival_process, publish_ring_slots)
from test_torch_cuda import assert_serve_golden, serve_golden_trace

ARRIVALS = ["poisson", "bursty"]


def _sc(**kw):
    return ServeConfig(**kw), JServeConfig(**kw)


# ---------------------------------------------------------------------------
# The request queue
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arrival", ARRIVALS)
def test_queue_draws_equal_jax(arrival):
    sc, jsc = _sc(arrival=arrival, arrival_rate=0.9, burst_rate=3.0,
                  prompt_len_min=2, prompt_len_max=9, seed=4)
    q, jq = RequestQueue(sc, 256), JRequestQueue(jsc, 256)
    for _ in range(200):
        assert q.step() == jq.step()
    assert q.submitted == jq.submitted > 0
    assert [(r.rid, r.prompt, r.max_new) for r in q._pending] == \
        [(r.rid, r.prompt, r.max_new) for r in jq._pending]
    assert make_arrival_process(sc).sequence(200).tolist() == \
        jmake_arrival_process(jsc).sequence(200).tolist()


@pytest.mark.parametrize("arrival", ARRIVALS)
def test_queue_state_roundtrips_and_loads_jax_state(arrival):
    sc, jsc = _sc(arrival=arrival, arrival_rate=1.1, seed=9)
    q, jq = RequestQueue(sc, 256), JRequestQueue(jsc, 256)
    for _ in range(6):
        q.step(), jq.step()
    mine, theirs = RequestQueue(sc, 256), RequestQueue(sc, 256)
    mine.load_state_dict(q.state_dict())
    theirs.load_state_dict(jq.state_dict())
    for _ in range(30):
        n = jq.step()
        assert q.step() == mine.step() == theirs.step() == n
    for other in (mine, theirs):
        assert [(r.rid, r.prompt) for r in other._pending] == \
            [(r.rid, r.prompt) for r in jq._pending]
        assert (other.submitted, other.next_rid) == \
            (jq.submitted, jq.next_rid)


def _cpu(arch, **kw):
    return build_model(dataclasses.replace(get_smoke_config(arch), **kw),
                       device="cpu")


@pytest.mark.parametrize("arrival", ARRIVALS)
def test_queue_conservation(arrival):
    sc = ServeConfig(slots=3, max_len=24, max_new=3, arrival=arrival,
                     arrival_rate=0.8, prompt_len_min=2, prompt_len_max=5,
                     seed=3)
    engine = Engine(_cpu("qwen1.5-0.5b"), sc.slots, sc.max_len)
    queue = RequestQueue(sc, 256)
    for _ in range(32):
        queue.step()
        engine.step(queue)
        assert queue.submitted == (len(queue) + engine.in_flight
                                   + engine.stats.completed)
    assert engine.stats.completed > 0
    assert engine.stats.admitted == engine.in_flight + engine.stats.completed


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
def _f32_cache(engine, slots, max_len, jax_engine=False):
    """Both engines' caches (and reset templates) in f32."""
    if jax_engine:
        engine.cache, _ = engine.model.init_decode_state(slots, max_len,
                                                          jnp.float32)
        engine._cache0, _ = engine.model.init_decode_state(slots, max_len,
                                                            jnp.float32)
    else:
        engine.cache, _ = engine.model.init_decode_state(slots, max_len,
                                                          torch.float32)
        engine._cache0, _ = engine.model.init_decode_state(slots, max_len,
                                                            torch.float32)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b"])
def test_generate_f32_tokens_equal_jax(arch):
    jcfg = dataclasses.replace(C.get_smoke_config(arch),
                               compute_dtype="float32")
    jengine = JEngine(jbuild_model(jcfg), 3, 32)
    engine = Engine(_cpu(arch, compute_dtype="float32"), 3, 32)
    engine.params = convert.params_from_jax(jax.device_get(jengine.params),
                                            device="cpu")
    _f32_cache(jengine, 3, 32, jax_engine=True)
    _f32_cache(engine, 3, 32)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, jcfg.vocab_size, size=n))
               for n in (4, 7, 5)]
    want = jengine.generate(prompts, max_new=8)
    got = engine.generate(prompts, max_new=8)
    assert got == want
    assert dataclasses.asdict(engine.stats) == \
        dataclasses.asdict(jengine.stats)


def test_ragged_prompt_equivalence():
    """Batched ragged prompts decode as each prompt alone: positions start
    at 0 on admit, so no padding exists and a slot's mask covers only its
    own cache writes."""
    model = _cpu("qwen1.5-0.5b")
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(1, 256, size=n)) for n in (3, 7, 5)]
    batched = Engine(model, 3, 48).generate(prompts, max_new=6)
    for i, p in enumerate(prompts):
        assert batched[i] == Engine(model, 1, 48).generate([p], max_new=6)[0]


def test_stats_count_active_slots_only():
    engine = Engine(_cpu("qwen1.5-0.5b"), batch_slots=3, max_len=48)
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 256, size=n)) for n in (4, 6)]
    out = engine.generate(prompts, max_new=3)
    assert [len(o) for o in out] == [4 + 3, 6 + 3]
    assert engine.stats.decode_tokens == 2 * 3
    assert engine.stats.prefill_tokens == (4 - 1) + (6 - 1)


def test_greedy_is_deterministic():
    model = _cpu("zamba2-2.7b")
    a = Engine(model, 1, 32).generate([[5, 7, 9]], max_new=5)
    b = Engine(model, 1, 32).generate([[5, 7, 9]], max_new=5)
    assert a == b


def test_golden_serve_trace():
    assert_serve_golden(*serve_golden_trace("cpu"))


def test_api_serve_builds_engine_and_queue():
    model = _cpu("qwen1.5-0.5b")
    rc = RunConfig(model=model.cfg, shape=TRAIN_4K,
                   serve=ServeConfig(slots=2, max_len=16, max_new=2,
                                     arrival_rate=1.0, seed=1))
    pub = WeightPublisher(make_layout(model.param_shapes()),
                          dataclasses.replace(rc.serve, publish_period=1),
                          device="cpu")
    engine, queue = api.serve(model, rc, publisher=pub, device="cpu")
    assert (engine.slots, engine.max_len, engine.publisher) == (2, 16, pub)
    trace = engine.serve(queue, 6)
    assert [ev["arrived"] for ev in trace] == \
        make_arrival_process(rc.serve).sequence(6).tolist()


# ---------------------------------------------------------------------------
# The publisher
# ---------------------------------------------------------------------------
def _tiny_params(seed):
    """A small multi-leaf tree with padded and multi-row leaves."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(9).astype(np.float32),
            "b": {"c": rng.standard_normal((33, 7)).astype(np.float32)},
            "d": (3 * rng.standard_normal(140)).astype(np.float32)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16))


def _pair(sc, seed=4):
    host = _tiny_params(seed)
    jparams = jax.tree.map(jnp.asarray, host)
    params = convert.params_from_jax(host, device="cpu")
    jpub = JWeightPublisher(jmake_layout(jparams),
                            JServeConfig(**dataclasses.asdict(sc)))
    pub = WeightPublisher(make_layout(params), sc, device="cpu")
    return jparams, params, jpub, pub


def test_publisher_ring_and_pop_equal_jax_bitwise():
    sc = ServeConfig(publish_period=1, staleness_bound=2)
    jparams, params, jpub, pub = _pair(sc)
    for step in range(4):
        scale = 1.0 + step
        jk = jpub.publish(jax.tree.map(lambda a: scale * a, jparams), step)
        k = pub.publish(tree_map(lambda a: scale * a, params), step)
        assert k == jk
        np.testing.assert_array_equal(pub.ring.numpy(), np.asarray(jpub.ring))
        np.testing.assert_array_equal(_bits(pub.scales), _bits(jpub.scales))
        np.testing.assert_array_equal(pub.pub_step, jpub.pub_step)
    for now in range(2, 7):
        got, stale = pub.pop(now)
        want, jstale = jpub.pop(now)
        assert stale == jstale
        if want is None:
            assert got is None
            continue
        for g, w in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (pub.pops, pub.misses) == (jpub.pops, jpub.misses)


def test_publisher_bit_identical_to_gossip_quantizer():
    sc = ServeConfig(publish_period=1, staleness_bound=2)
    _, params, _, pub = _pair(sc, seed=5)
    layout = make_layout(params)
    k = pub.publish(params, step=0)
    q, s = quantize_int8_rows(flatten_tree(layout, params),
                              scale_dtype=torch.bfloat16)
    assert torch.equal(pub.ring[k], q)
    assert torch.equal(pub.scales[k].view(torch.int16), s.view(torch.int16))
    popped, stale = pub.pop(now=0)
    assert stale == 0
    assert torch.equal(flatten_tree(layout, popped),
                       dequantize_int8_rows(q, s))


def test_publisher_staleness_bound_and_no_unread_overwrite():
    period, bound = 2, 5
    sc = ServeConfig(publish_period=period, staleness_bound=bound)
    _, params, _, pub = _pair(sc, seed=6)
    layout = make_layout(params)
    assert pub.n_slots == publish_ring_slots(sc) == bound // period + 1
    published = {}
    gen = torch.Generator().manual_seed(6)
    for step in range(0, 24, period):
        k = pub.seq % pub.n_slots
        old = int(pub.pub_step[k])
        if old >= 0:                       # overwritten means expired
            assert step - old > bound, (step, old)
        tree = tree_map(lambda a: a + torch.randn(a.shape, generator=gen),
                        params)
        pub.publish(tree, step)
        published[step] = tree
        for now in range(step, step + period):
            got, stale = pub.pop(now)
            assert got is not None and 0 <= stale <= bound
            want = quantize_int8_rows(
                flatten_tree(layout, published[now - stale]),
                scale_dtype=torch.bfloat16)
            assert torch.equal(flatten_tree(layout, got),
                               dequantize_int8_rows(*want))
    fresh = WeightPublisher(layout, sc, device="cpu")
    assert fresh.pop(0) == (None, None) and fresh.misses == 1
    assert pub.pop(22 + bound + period + 1) == (None, None)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_publisher_state_dict_exchanges_with_jax(direction):
    sc = ServeConfig(publish_period=2, staleness_bound=4)
    jparams, params, jpub, pub = _pair(sc, seed=7)
    for step in (0, 2, 4):
        jpub.publish(jax.tree.map(lambda a: a * (step + 1), jparams), step)
        pub.publish(tree_map(lambda a: a * (step + 1), params), step)
    jpub.pop(5), pub.pop(5)
    jfresh = JWeightPublisher(jpub.layout, jpub.cfg)
    fresh = WeightPublisher(pub.layout, sc, device="cpu")
    if direction == "jax_to_port":
        fresh.load_state_dict(jpub.state_dict())
        jfresh.load_state_dict(jpub.state_dict())
    else:
        jfresh.load_state_dict(pub.state_dict())
        fresh.load_state_dict(pub.state_dict())
    np.testing.assert_array_equal(fresh.ring.numpy(), np.asarray(jfresh.ring))
    np.testing.assert_array_equal(_bits(fresh.scales), _bits(jfresh.scales))
    np.testing.assert_array_equal(fresh.pub_step, jfresh.pub_step)
    assert (fresh.seq, fresh.pops, fresh.misses) == \
        (jfresh.seq, jfresh.pops, jfresh.misses) == (3, 1, 0)
    for now in (4, 6, 9):
        got, stale = fresh.pop(now)
        want, jstale = jfresh.pop(now)
        assert stale == jstale
        if want is not None:
            for g, w in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
