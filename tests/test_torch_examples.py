"""The port's examples (``examples_torch/``, the twins of ``examples/``)
run on the CPU at small sizes through their ``main(argv)``;
``linreg_paper``'s simulator traces equal the JAX package's for the
same arguments (times, epochs, staleness and minibatches exactly, the
errors to rtol 1e-4, atol 1e-7, as ``test_torch_sim.py`` holds them);
each example's default device is the card.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["quickstart", "linreg_paper", "decentralized", "serve_batched"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the examples' small ops ran 15-30x slower
    under the parallel test run with PyTorch's default threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_on_the_cpu():
    losses = _example("quickstart").main(["--device", "cpu", "--steps", "6",
                                          "--seq-len", "32"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_decentralized_converges_on_the_cpu():
    errs = _example("decentralized").main(["--device", "cpu", "--epochs",
                                           "40", "--compression", "int8"])
    assert len(errs) == 4 and errs[-1] < 0.05 and errs[-1] < errs[0]


def test_serve_batched_keeps_the_staleness_bound():
    engine = _example("serve_batched").main(["--device", "cpu", "--steps",
                                             "24"])
    s = engine.stats
    assert s.steps == 24 and s.admitted > 0 and s.publish_pops > 0
    assert s.staleness_max <= 8


def _jax_runs(dim, total_time):
    """``examples/linreg_paper.py``'s three simulations, JAX's."""
    from repro import api
    from repro.configs.base import LINREG, AmbdgConfig, ModelConfig
    from repro.data.timing import ShiftedExponential
    from repro.sim import SimProblem
    cfg = ModelConfig(name="linreg", family=LINREG, n_layers=0, d_model=0,
                      n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
                      linreg_dim=dim)
    timing = ShiftedExponential(lam=2 / 3, xi=1.0, b=60)
    opt = AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                      b_bar=800.0, proximal="l2_ball",
                      radius_C=float(1.05 * np.sqrt(dim)))
    runs = {name: api.simulate(
        name, SimProblem(cfg, 10, b_max=1024), t_p=2.5, t_c=10.0,
        total_time=total_time, timing=timing, opt_cfg=opt)
        for name in ("ambdg", "amb")}
    runs["kbatch"] = api.simulate(
        "kbatch", SimProblem(cfg, 10, b_max=1024), b_per_msg=60, K=10,
        t_c=10.0, total_time=total_time, timing=timing, opt_cfg=opt)
    return runs


def test_linreg_paper_traces_equal_jax(capsys):
    got = _example("linreg_paper").main(["--device", "cpu", "--dim", "256",
                                         "--total-time", "60"])
    assert "speedup vs AMB" in capsys.readouterr().out
    want = _jax_runs(256, 60.0)
    for name in ("ambdg", "amb", "kbatch"):
        g, w = got[name], want[name]
        assert len(g.times) >= 5
        for col in ("times", "epochs", "staleness", "minibatches"):
            if hasattr(w, col):
                assert list(getattr(g, col)) == list(getattr(w, col)), (
                    name, col)
        np.testing.assert_allclose(g.errors, w.errors, rtol=1e-4, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main([])
