"""The port's delay processes and staleness algebra against the JAX
package.

``repro_torch.core.delay_process`` is the port's own copy of the numpy
module, so its sequences must equal the JAX package's exactly (integer
equality, no tolerance) for every process, cap and seed, through a
``state_dict`` resume as well; the same configurations must be refused
with the same messages. ``repro_torch.core.staleness``'s delivery
schedule and observed staleness must equal JAX's exactly too.
"""
import numpy as np
import pytest

from repro.configs.base import DelayConfig as JaxDelayConfig
from repro.core import delay_process as jdp
from repro.core import staleness as jst
from repro_torch.configs.base import DelayConfig
from repro_torch.core import delay_process as dp
from repro_torch.core import staleness as st

PROCESSES = ("fixed", "jitter", "heavy_tail", "bursty")
TAU = 3


def _pair(process, tau_max, seed=0, **kw):
    return (dp.make_delay_process(DelayConfig(process=process,
                                              tau_max=tau_max, seed=seed,
                                              **kw), TAU),
            jdp.make_delay_process(JaxDelayConfig(process=process,
                                                  tau_max=tau_max,
                                                  seed=seed, **kw), TAU))


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("process,tau_max", [
    (p, m) for p in PROCESSES for m in (1, 4, 8, 16)
    if not (p == "fixed" and m < TAU)] + [("fixed", 0)])
def test_sequences_equal_jax(process, tau_max, seed):
    port, ref = _pair(process, tau_max, seed)
    assert (port.delay_min, port.tau_max) == (ref.delay_min, ref.tau_max)
    a, b = port.sequence(300), ref.sequence(300)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    assert [port.next() for _ in range(20)] == [ref.next()
                                                for _ in range(20)]


@pytest.mark.parametrize("kw", [dict(jitter=3), dict(tail_alpha=0.6),
                                dict(p_burst=0.4, p_exit=0.1),
                                dict(delay_min=0)])
@pytest.mark.parametrize("process", ["jitter", "heavy_tail", "bursty"])
def test_sequences_equal_jax_other_settings(process, kw):
    port, ref = _pair(process, 8, seed=3, **kw)
    np.testing.assert_array_equal(port.sequence(200), ref.sequence(200))


@pytest.mark.parametrize("process", PROCESSES)
def test_state_dict_resume_matches_jax(process):
    port, ref = _pair(process, 8, seed=5)
    np.testing.assert_array_equal(port.sequence(37), ref.sequence(37))
    saved = port.state_dict()
    rest = ref.sequence(64)
    resumed, _ = _pair(process, 8, seed=999)
    resumed.load_state_dict(saved)
    np.testing.assert_array_equal(resumed.sequence(64), rest)
    # and a JAX state loads into the port
    other, _ = _pair(process, 8, seed=42)
    _, ref2 = _pair(process, 8, seed=5)
    ref2.sequence(37)
    other.load_state_dict(ref2.state_dict())
    np.testing.assert_array_equal(other.sequence(64), ref2.sequence(64))


@pytest.mark.parametrize("process,tau_max,kw,match", [
    ("lognormal", 4, {}, "unknown delay process"),
    ("jitter", 0, {}, "tau_max >= 1"),
    ("jitter", 2, dict(delay_min=5), "delay_min"),
    ("jitter", 2, dict(delay_min=-1), "delay_min"),
    ("heavy_tail", 4, dict(tail_alpha=0.0), "tail_alpha"),
    ("bursty", 4, dict(p_burst=1.5), "probabilities"),
    ("jitter", 4, dict(jitter=-1), "jitter"),
    ("fixed", 1, {}, "tau_max"),
])
def test_validation_errors_match_jax(process, tau_max, kw, match):
    msgs = []
    for make, cfg in ((dp.make_delay_process, DelayConfig),
                      (jdp.make_delay_process, JaxDelayConfig)):
        with pytest.raises(ValueError, match=match) as err:
            make(cfg(process=process, tau_max=tau_max, **kw), TAU)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_resolve_bounds_and_registry_match_jax():
    assert set(dp.DELAY_PROCESSES) == set(jdp.DELAY_PROCESSES)
    for process in PROCESSES:
        for tau_max in (0, 3, 9):
            args = dict(process=process, tau_max=tau_max)
            try:
                want = jdp.resolve_bounds(JaxDelayConfig(**args), TAU)
            except ValueError:
                with pytest.raises(ValueError):
                    dp.resolve_bounds(DelayConfig(**args), TAU)
                continue
            assert dp.resolve_bounds(DelayConfig(**args), TAU) == want


@pytest.mark.parametrize("process", ["jitter", "heavy_tail", "bursty"])
def test_staleness_algebra_matches_jax(process):
    delays = _pair(process, 8, seed=7)[0].sequence(40).tolist()
    assert st.delivery_schedule(delays) == jst.delivery_schedule(delays)
    for fallback in (0.0, 8.0):
        assert (st.observed_staleness(delays, 40, fallback)
                == jst.observed_staleness(delays, 40, fallback))
    assert (st.reference_epoch_sequence(delays)
            == jst.reference_epoch_sequence(delays))
    with pytest.raises(ValueError, match="delay"):
        st.delivery_schedule([1, 2.5])
