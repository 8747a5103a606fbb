"""The port's boundaries: it imports neither JAX nor the JAX package,
its entry points run on the card unless the caller asks for the CPU,
and a kernel asked for on a CPU tensor raises instead of falling back.
"""
import ast
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig, XLSTMConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SLICE = ["repro_torch", "repro_torch.api", "repro_torch.convert",
         "repro_torch.train.loop", "repro_torch.core.ambdg",
         "repro_torch.core.strategy", "repro_torch.core.arena",
         "repro_torch.core.dual_averaging", "repro_torch.core.anytime",
         "repro_torch.core.delayed", "repro_torch.core.delay_process",
         "repro_torch.core.staleness", "repro_torch.optim",
         "repro_torch.models.api", "repro_torch.models.linear",
         "repro_torch.data.pipeline", "repro_torch.configs",
         "repro_torch.kernels.build",
         "repro_torch.kernels.dual_update.ops",
         "repro_torch.kernels.dual_update.kernel",
         "repro_torch.kernels.delay_ring.ops",
         "repro_torch.kernels.delay_ring.ref",
         "repro_torch.kernels.delay_ring.kernel",
         # the LM slice
         "repro_torch.models.common", "repro_torch.models.layers",
         "repro_torch.models.transformer", "repro_torch.data.synthetic",
         "repro_torch.configs.qwen1_5_0_5b", "repro_torch.configs.qwen3_1_7b",
         "repro_torch.configs.yi_6b", "repro_torch.configs.chatglm3_6b",
         "repro_torch.kernels.flash_attention.ops",
         "repro_torch.kernels.flash_attention.ref",
         "repro_torch.kernels.flash_attention.kernel",
         # the hybrid slice
         "repro_torch.models.ssm", "repro_torch.configs.zamba2_2_7b",
         "repro_torch.kernels.linear_scan.ops",
         "repro_torch.kernels.linear_scan.ref",
         "repro_torch.kernels.linear_scan.kernel",
         # the simulator slice
         "repro_torch.sim", "repro_torch.sim.cluster",
         "repro_torch.core.kbatch", "repro_torch.data.timing",
         # the CNN and the scenarios
         "repro_torch.configs.amb_cnn", "repro_torch.models.cnn",
         "repro_torch.core.batch_schedule", "repro_torch.core.worker_process",
         "repro_torch.train.fault", "repro_torch.train.checkpoint",
         # the decentralized gossip
         "repro_torch.core.consensus", "repro_torch.optim.compression",
         # train-while-serve
         "repro_torch.serve", "repro_torch.serve.engine",
         "repro_torch.serve.publisher", "repro_torch.serve.request_queue",
         # the xLSTM slice
         "repro_torch.models.xlstm", "repro_torch.configs.xlstm_125m",
         # the encoder-decoder and the VLM
         "repro_torch.models.encdec",
         "repro_torch.configs.seamless_m4t_large_v2",
         "repro_torch.configs.paligemma_3b",
         # the launchers and the AMB alias
         "repro_torch.core.amb", "repro_torch.launch",
         "repro_torch.launch.mesh", "repro_torch.launch.train",
         "repro_torch.launch.serve",
         # the multi-process path
         "repro_torch.dist", "repro_torch.dist.sharding",
         "repro_torch.dist.context", "repro_torch.dist.collectives",
         # tensor parallelism over 'model'
         "repro_torch.dist.tensor_parallel",
         # the per-rank gossip and the wire models
         "repro_torch.launch.wire_model"]
EXAMPLES = ROOT / "examples_torch"


def test_import_loads_no_jax_and_no_jax_package():
    code = ("import sys\n" + "".join(f"import {m}\n" for m in SLICE) +
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'repro')"
            " or m.startswith(('jax.', 'jaxlib.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         sorted(EXAMPLES.glob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def _cpu_model():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import build_model
    return build_model(get_smoke_config("amb-linreg"), device="cpu")


def _rc():
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig, TRAIN_4K
    return RunConfig(model=get_smoke_config("amb-linreg"), shape=TRAIN_4K)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    from repro_torch import api
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_smoke_config("amb-linreg"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.build(_cpu_model(), _rc())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(_cpu_model(), _rc(), LoopConfig(n_steps=1))


def test_serve_entry_points_default_to_cuda_and_raise_without_it():
    """``api.serve`` and the weight publisher land on the card unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    import dataclasses
    from repro_torch import api
    from repro_torch.core.arena import make_layout
    from repro_torch.serve import WeightPublisher
    model = _lm_model()
    rc = _rc().replace(model=model.cfg)
    sc = dataclasses.replace(rc.serve, publish_period=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.serve(model, rc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WeightPublisher(make_layout(model.param_shapes()), sc)
    engine, _ = api.serve(model, rc, device="cpu")
    assert engine.cache["k"].device.type == "cpu"
    pub = WeightPublisher(make_layout(model.param_shapes()), sc,
                          device="cpu")
    assert pub.ring.device.type == "cpu"


def _lm_model():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import build_model
    return build_model(get_smoke_config("qwen1.5-0.5b"), device="cpu")


def test_state_constructors_default_to_cuda_and_raise_without_it():
    """A JAX state carried across, or a fresh delay ring, lands on the
    card unless the caller asks for the CPU; never silently on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    import numpy as np
    from repro_torch import convert
    from repro_torch.core import arena
    layout = arena.make_layout({"w": torch.zeros(300)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.to_tensor(np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        arena.init_arena(layout, 2, 1, "int8")
    state = types.SimpleNamespace(params={"w": np.zeros((4, 3), np.float32)},
                                  z=np.zeros((4, 256, 128), np.float32),
                                  residual=np.zeros((4, 256, 128), np.float32),
                                  t=np.int32(0), step=np.int32(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.decentralized_state_from_jax(state)
    assert convert.decentralized_state_from_jax(
        state, device="cpu").z.device.type == "cpu"
    assert arena.init_arena(layout, 2, 1, "int8",
                            device="cpu").ring[0].device.type == "cpu"


@pytest.mark.parametrize("knob,value,error,item", [
    # one worker a rank is ported: without a world of n_workers ranks
    # it raises, naming both counts
    ("consensus", "shard_map", RuntimeError,
     "8 workers need an initialised process group of 8 ranks"),
])
def test_unported_knobs_raise(knob, value, error, item):
    import dataclasses
    from repro_torch import api
    rc = _rc()
    if knob == "kbatch":
        knob, rc = "batch_schedule", rc.replace(strategy="kbatch")
    if knob == "consensus":
        rc = rc.replace(strategy="decentralized")
    field = {"ambdg": "anytime_impl", "batch_schedule": "schedule",
             "elastic": "process", "consensus": "gossip_impl"}.get(knob)
    if field:
        rc = rc.replace(**{knob: dataclasses.replace(getattr(rc, knob),
                                                     **{field: value})})
    else:
        rc = rc.replace(**{knob: value})
    with pytest.raises(error, match=item):
        api.build(_cpu_model(), rc, device="cpu")


@pytest.mark.parametrize("knob,value", [("master_impl", "pytree"),
                                        ("strategy", "kbatch"),
                                        ("kbatch", "linear"),
                                        ("batch_schedule", "linear"),
                                        ("elastic", "churn"),
                                        ("strategy", "decentralized"),
                                        ("optimizer", "sgd"),
                                        ("optimizer", "adam"),
                                        ("ambdg", "while_dynamic")])
def test_ported_knobs_build_and_step(knob, value):
    """Knobs that raised before their slice build and step on the CPU:
    the pytree master, the K-batch strategy (also under a linear batch
    schedule), the linear batch schedule (its target rides the batch as
    ``b_sched``), the churn worker process (its seeded process comes
    from the strategy), the decentralized gossip (8 workers), the sgd
    and adam optimizers and the dynamic-trip accumulation."""
    import dataclasses
    from repro_torch import api
    from repro_torch.data.pipeline import AnytimePipeline
    rc = _rc()
    if knob == "kbatch":
        knob, rc = "batch_schedule", rc.replace(strategy="kbatch")
    field = {"batch_schedule": "schedule", "elastic": "process",
             "ambdg": "anytime_impl"}.get(knob)
    if field:
        rc = rc.replace(**{knob: dataclasses.replace(getattr(rc, knob),
                                                     **{field: value})})
    else:
        rc = rc.replace(**{knob: value})
    strategy = api.build(_cpu_model(), rc, device="cpu")
    state = strategy.init_state()
    sched = strategy.batch_schedule()
    assert (sched is None) == (knob != "batch_schedule")
    assert (strategy.worker_process(4) is None) == (knob != "elastic")
    pipe = AnytimePipeline(rc.model, 4, 8)
    for _ in range(3):
        batch = {k: torch.from_numpy(v)
                 for k, v in pipe.next_global_batch().items()}
        if sched is not None:
            batch["b_sched"] = torch.tensor(float(sched.target()))
        state, metrics = strategy.train_step(state, batch)
    assert metrics["applied_count"].item() == 32.0
    if value == "pytree":
        assert state.arena is None and state.buffer is not None
    elif rc.strategy == "kbatch":
        assert state.ref_epoch.item() == 4
        assert metrics["staleness"].item() == 0
    elif rc.strategy == "decentralized":
        assert state.z.shape[0] == rc.consensus.n_workers
        assert metrics["consensus_error"].item() >= 0.0


def test_loop_restores_from_ckpt_dir(tmp_path):
    """``ckpt_dir`` (which raised before checkpoints were ported) saves
    every ``ckpt_every`` steps, and a run started on the directory
    resumes from its latest checkpoint: 3 + 2 steps end where 5 do."""
    from repro_torch.train.loop import LoopConfig, train
    loop = dict(n_workers=4, samples_per_worker=8, log_every=1)
    whole = train(_cpu_model(), _rc(), LoopConfig(n_steps=5, **loop),
                  device="cpu")
    first = train(_cpu_model(), _rc(), LoopConfig(
        n_steps=3, ckpt_dir=str(tmp_path), ckpt_every=3, **loop),
        device="cpu")
    assert len(first["history"]) == 3
    rest = train(_cpu_model(), _rc(), LoopConfig(
        n_steps=5, ckpt_dir=str(tmp_path), ckpt_every=3, **loop),
        device="cpu")
    assert len(rest["history"]) == 2
    assert torch.equal(rest["state"].params["w"], whole["state"].params["w"])
    assert int(rest["state"].step) == 5


def test_unported_loop_options_raise():
    """The loop's last unported option, the weight publisher
    (``rc.serve.publish_period``), now runs and returns its publisher;
    a serve config the publisher cannot hold raises before any step."""
    import dataclasses
    from repro_torch.train.loop import LoopConfig, train
    rc = _rc()
    rc = rc.replace(serve=dataclasses.replace(rc.serve, publish_period=2))
    out = train(_cpu_model(), rc, LoopConfig(n_steps=2, n_workers=4,
                                             samples_per_worker=8),
                device="cpu")
    assert out["publisher"].seq == 1
    assert out["publisher"].pub_step.tolist() == [2, -1, -1]
    bad = rc.replace(serve=dataclasses.replace(rc.serve, staleness_bound=-1))
    with pytest.raises(ValueError, match="staleness_bound"):
        train(_cpu_model(), bad, LoopConfig(n_steps=1), device="cpu")


@pytest.mark.parametrize("op", ["dual_update", "delay_ring",
                                "variable_pop", "ring_rotate",
                                "dual_update_pytree", "linear_scan"])
def test_kernel_impl_on_cpu_raises_and_launches_nothing(op):
    from repro_torch.kernels.delay_ring import kernel as ring_kernel
    from repro_torch.kernels.delay_ring.ops import (ring_push_pop,
                                                    ring_slot_rotate_int8,
                                                    ring_variable_pop)
    from repro_torch.kernels.dual_update import kernel as update_kernel
    from repro_torch.kernels.dual_update.ops import (dual_update,
                                                     dual_update_arena)
    from repro_torch.kernels.linear_scan import kernel as scan_kernel
    from repro_torch.kernels.linear_scan.ops import ssd_mamba2
    counters = (update_kernel.KERNEL, update_kernel.UPDATE,
                ring_kernel.KERNEL, ring_kernel.RING_KERNEL,
                ring_kernel.VARIABLE_POP_KERNEL, scan_kernel.FWD,
                scan_kernel.BWD)
    before = [k.launches for k in counters]
    f32 = torch.zeros((1, 256, 128))
    with pytest.raises(ValueError, match="CUDA tensors"):
        if op == "dual_update":
            dual_update_arena(f32[0], f32[0].clone(), torch.tensor(1.0),
                              torch.tensor(0.5), impl="kernel")
        elif op == "delay_ring":
            i8 = torch.zeros((1, 256, 128), dtype=torch.int8)
            s = torch.ones((1, 256))
            ring_slot_rotate_int8(i8, s, i8.clone(), s.clone(), f32, s,
                                  impl="kernel")
        elif op == "variable_pop":
            ring_variable_pop(torch.zeros((3, 1, 256, 128)),
                              torch.tensor([True, False, False]),
                              impl="kernel")
        elif op == "dual_update_pytree":
            dual_update({"w": torch.zeros(7)}, {"w": torch.ones(7)}, 0.5,
                        impl="kernel")
        elif op == "linear_scan":
            x = torch.zeros((1, 64, 2, 16))
            ssd_mamba2(x, torch.ones((1, 64, 2)), -torch.ones(2),
                       torch.zeros((1, 64, 1, 16)),
                       torch.zeros((1, 64, 1, 16)), chunk=32, impl="kernel")
        else:
            ring_push_pop(torch.zeros((2, 1, 256, 128)), f32,
                          torch.zeros((), dtype=torch.int32), impl="kernel")
    assert [k.launches for k in counters] == before


def test_lm_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import build_model
    for arch in ("qwen1.5-0.5b", "qwen3-1.7b", "yi-6b", "chatglm3-6b",
                 "zamba2-2.7b", "mixtral-8x7b", "mixtral-8x22b",
                 "xlstm-125m", "seamless-m4t-large-v2", "paligemma-3b"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(get_smoke_config(arch))
        assert build_model(get_smoke_config(arch),
                           device="cpu").device.type == "cpu"


def _dense(**kw):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), **kw)


@pytest.mark.parametrize("kw,item", [
    (dict(family="moe"), "moe config"),
    (dict(family="ssm"), "xlstm config"),
    (dict(family="ssm", xlstm=XLSTMConfig()), None),
    (dict(family="vlm"), "frontend"),
    (dict(family="encdec", n_encoder_layers=2), None),
    (dict(family="moe", moe=MoEConfig()), None),
    (dict(prefix_lm=True), None),
    (dict(logit_softcap=30.0), None),
    (dict(sliding_window=16), None),
    # ported (A.11 part 2, item 5): the identity without a model axis
    pytest.param(dict(seq_parallel=True), None, id="kw9-A.11"),
    (dict(block_remat="dots"), None),
    (dict(block_remat="selective"), "block_remat"),
])
def test_unported_model_knobs_raise(kw, item):
    """Each knob the port does not carry raises naming its ROADMAP item;
    the MOE family (given its moe config), the SSM family (given its
    xlstm config), the ENCDEC family (given its encoder layers),
    prefix_lm, logit_softcap, sliding_window, ``seq_parallel`` (the
    identity off a model axis) and ``block_remat="dots"`` are ported and
    build and take a loss on the CPU (a MOE or SSM family
    without its config, a VLM without its frontend stub, and an unknown
    block_remat, raise a ValueError, as JAX's model fails on them)."""
    from repro_torch.models.api import build_model
    if item is None:
        model = build_model(_dense(**kw), device="cpu")
        batch = model.dummy_batch(2, 24, torch.Generator().manual_seed(0))
        loss, aux = model.loss(model.init(), batch)
        assert bool(torch.isfinite(loss)) and float(aux["count"]) == 46
        return
    error = (ValueError if item in ("moe config", "xlstm config",
                                    "block_remat", "frontend")
             else NotImplementedError)
    with pytest.raises(error, match=item):
        build_model(_dense(**kw), device="cpu")


def _decode_entry(entry, cfg):
    """Call the transformer's decode entry ``entry`` on ``cfg``: the cache
    tree's keys, or one step's logits."""
    from repro_torch.models import transformer as tf
    if entry == "init_decode_state":
        return set(tf.init_decode_state(cfg, 2, 8)[0])
    params = tf.init(cfg, torch.Generator().manual_seed(0), "cpu")
    cache, _ = tf.init_decode_state(cfg, 2, 8)
    return tf.decode_step(params, cfg, cache,
                          torch.zeros((2, 1), dtype=torch.int64), 0)[0]


def _check_xlstm_decodes(entry, cfg):
    """The xLSTM (ssm) family decodes through ``entry`` given its xlstm
    config, and raises a ValueError without one."""
    import dataclasses
    got = _decode_entry(entry, cfg)
    if entry == "init_decode_state":
        assert got == {"mlstm", "slstm"}
    else:
        assert got.shape == (2, 1, cfg.padded_vocab_size)
        assert bool(torch.isfinite(got).all())
    with pytest.raises(ValueError, match="xlstm config"):
        _decode_entry(entry, dataclasses.replace(cfg, xlstm=None))


@pytest.mark.parametrize("entry", ["init_decode_state", "decode_step"])
def test_decode_path_raises(entry):
    """The DENSE and MOE decode paths are ported (the model's entries run,
    the MOE one with a rolling window cache of 4 slots past its wrap);
    the xLSTM (ssm) family's decodes, and raises a ValueError without its
    xlstm config."""
    from repro_torch.configs.base import MoEConfig as MoE
    from repro_torch.models.api import build_model
    model = build_model(_dense(), device="cpu")
    cache, _ = model.init_decode_state(2, 8)
    logits, _ = model.decode_step(model.init(), cache,
                                  torch.zeros((2, 1), dtype=torch.int64), 0)
    assert logits.shape == (2, 1, model.cfg.padded_vocab_size)
    moe = build_model(_dense(family="moe", moe=MoE(n_experts=4),
                             sliding_window=4), device="cpu")
    cache, _ = moe.init_decode_state(2, 8)
    assert cache["k"].shape[2] == 4
    params = moe.init()
    for t in range(6):
        logits, cache = moe.decode_step(
            params, cache, torch.zeros((2, 1), dtype=torch.int64),
            torch.tensor([t, t + 1]))
    assert bool(torch.isfinite(logits).all())
    _check_xlstm_decodes(entry, _dense(family="ssm", xlstm=XLSTMConfig()))


def _hybrid(**kw):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("zamba2-2.7b"), **kw)


@pytest.mark.parametrize("kw,error,match", [
    (dict(prefix_lm=True), None, None),
    (dict(prefix_lm=True, attn_impl="flash"), NotImplementedError, "flash"),
    (dict(scan_impl="pallas"), ValueError, "scan_impl"),
    (dict(n_layers=3), ValueError, "shared_attn_every"),
    (dict(ssm=None), ValueError, "ssm config"),
])
def test_hybrid_model_knobs_raise(kw, error, match):
    """The hybrid's knobs that raise; prefix_lm is ported (the shared
    attention block takes the mask) and builds, except under the flash
    kernels, which do not compute it."""
    from repro_torch.models.api import build_model
    if error is None:
        model = build_model(_hybrid(**kw), device="cpu")
        batch = model.dummy_batch(2, 16, torch.Generator().manual_seed(0))
        assert bool(torch.isfinite(model.loss(model.init(), batch)[0]))
        return
    with pytest.raises(error, match=match):
        build_model(_hybrid(**kw), device="cpu")


@pytest.mark.parametrize("entry", ["init_decode_state", "decode_step"])
def test_hybrid_decode_path_raises(entry):
    """The HYBRID decode path is ported; so is the xLSTM (ssm) family's,
    which raises a ValueError without its xlstm config."""
    from repro_torch.models.api import build_model
    model = build_model(_hybrid(), device="cpu")
    cache, _ = model.init_decode_state(2, 8)
    assert set(cache) == {"mamba", "shared"}
    logits, _ = model.decode_step(model.init(), cache,
                                  torch.zeros((2, 1), dtype=torch.int64),
                                  torch.tensor([0, 3]))
    assert logits.shape == (2, 1, model.cfg.padded_vocab_size)
    _check_xlstm_decodes(entry, _hybrid(family="ssm", xlstm=XLSTMConfig()))


@pytest.mark.parametrize("stack,floor", [("mlstm", -1e30), ("slstm", -30.0)])
def test_xlstm_decode_state_starts_each_m_at_its_floor(stack, floor):
    """The mLSTM's m starts at -1e30 (JAX's NEG_INF), the sLSTM's at -30
    (JAX's ``slstm_zero_state``), in f32; every other state leaf at 0.
    The engine's slot reset copies these from its template."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.arena import tree_flatten
    from repro_torch.models.api import build_model
    model = build_model(get_smoke_config("xlstm-125m"), device="cpu")
    cache, caxes = model.init_decode_state(3, 8)
    m = cache[stack]["m"]
    assert m.dtype == torch.float32 and caxes[stack]["m"][1] == "batch"
    assert torch.equal(m, torch.full_like(m, floor))
    for name, leaf in cache[stack].items():
        if name != "m":
            assert leaf.dtype == torch.float32
            assert not bool(leaf.any()), name
    assert len(tree_flatten(cache)[0]) == 7


@pytest.mark.parametrize("strategy", ["ambdg", "amb", "kbatch",
                                      "decentralized"])
def test_remat_knobs_step_every_lm_strategy(strategy):
    """``block_remat="dots"`` with ``rc.remat="whole_loss"`` (which raised
    before the xLSTM slice) builds and steps every strategy that takes an
    LM's gradient, on xlstm-125m SMOKE in f32: two steps whose losses and
    gradient norms equal those of the default (full block remat, no
    whole-loss checkpoint) to rtol 1e-6."""
    import dataclasses
    from repro_torch import api
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (AmbdgConfig, ConsensusConfig,
                                          RunConfig, TRAIN_4K)
    from repro_torch.data.pipeline import AnytimePipeline
    from repro_torch.models.api import build_model
    runs, threads = [], torch.get_num_threads()
    torch.set_num_threads(1)       # the sLSTM's time loop of tiny ops
    try:
        for block_remat, remat in (("dots", "whole_loss"), ("full", "none")):
            cfg = dataclasses.replace(get_smoke_config("xlstm-125m"),
                                      compute_dtype="float32",
                                      block_remat=block_remat)
            rc = RunConfig(model=cfg, strategy=strategy, remat=remat,
                           shape=dataclasses.replace(TRAIN_4K, seq_len=16,
                                                     global_batch=4),
                           ambdg=AmbdgConfig(tau=1, b_bar=4.0,
                                             n_microbatches=2),
                           consensus=ConsensusConfig(n_workers=2, rounds=1))
            s = api.build(build_model(cfg, device="cpu"), rc, device="cpu")
            state = s.init_state(torch.Generator().manual_seed(0))
            pipe = AnytimePipeline(cfg, 2, 2, seq_len=16, seed=0)
            out = []
            for _ in range(2):
                batch = {k: torch.from_numpy(v)
                         for k, v in pipe.next_global_batch().items()}
                state, m = s.train_step(state, batch)
                out.append([float(m["loss"]), float(m.get(
                    "grad_norm", m["loss"]))])
            runs.append(out)
    finally:
        torch.set_num_threads(threads)
    assert all(np.isfinite(runs[0]).ravel())
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-6)


def _seamless(**kw):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("seamless-m4t-large-v2"),
                               **kw)


@pytest.mark.parametrize("kw,error,match", [
    (dict(seq_parallel=True), None, "seq_parallel"),
    (dict(sliding_window=16), NotImplementedError, "sliding_window"),
    (dict(prefix_lm=True), NotImplementedError, "prefix_lm"),
    (dict(block_remat="selective"), ValueError, "block_remat"),
    (dict(attn_impl="pallas"), ValueError, "attn_impl"),
    (dict(attn_impl="flash", logit_softcap=30.0), NotImplementedError,
     "flash"),
    (dict(family="dense"), None, None),
])
def test_encdec_model_knobs_raise(kw, error, match):
    """The encoder-decoder's knobs that raise: the masks JAX's
    encoder-decoder leaves out of training, an unknown remat or
    attention knob, a cap under the flash kernels; and the transformer
    sends the family to ``models/encdec.py`` (a dense config built as an
    encoder-decoder through ``encdec.init`` raises). ``seq_parallel``
    builds, and off a mesh with ``model > 1`` it is the identity: the
    loss equals the one without it, bit for bit (its split is
    ``test_torch_tensor_parallel_zoo``'s)."""
    from repro_torch.models import encdec, transformer
    from repro_torch.models.api import build_model
    if match == "seq_parallel":
        on, off = (build_model(_seamless(**k), device="cpu")
                   for k in (kw, {}))
        batch = off.dummy_batch(2, 8, torch.Generator().manual_seed(0))
        params = off.init()
        assert torch.equal(on.loss(params, batch)[0],
                           off.loss(params, batch)[0])
        return
    if error is None:
        with pytest.raises(ValueError, match="encdec"):
            encdec.init(_seamless(**kw), None, "meta")
        with pytest.raises(ValueError, match="encdec.py"):
            transformer.init(_seamless(), None, "meta")
        return
    with pytest.raises(error, match=match):
        build_model(_seamless(**kw), device="cpu")


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "paligemma-3b"])
def test_encdec_and_vlm_decode_paths(arch):
    """Both families decode through the model's entries on the CPU, with
    ragged positions: the encoder-decoder's cache {"self", "mem_k",
    "mem_v"} (the slot reset reads "batch" in each), the VLM's the dense
    KV cache; finite logits over the padded vocab."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.arena import tree_flatten
    from repro_torch.models.api import build_model
    model = build_model(get_smoke_config(arch), device="cpu")
    cache, axes = model.init_decode_state(2, 8)
    want = ({"self", "mem_k", "mem_v"} if arch.startswith("seamless")
            else {"k", "v"})
    assert set(cache) == want
    assert all("batch" in ax for ax in tree_flatten(axes)[0])
    params = model.init()
    for t in range(4):
        logits, cache = model.decode_step(
            params, cache, torch.full((2, 1), t + 1, dtype=torch.int64),
            torch.tensor([t, t + 2]))
    assert logits.shape == (2, 1, model.cfg.padded_vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("strategy", ["ambdg", "amb", "kbatch",
                                      "decentralized"])
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "paligemma-3b"])
def test_encdec_and_vlm_step_every_lm_strategy(arch, strategy):
    """Both families build and step every strategy that takes an LM's
    gradient, their frames or patches split with the tokens (across the
    decentralized workers, then into microbatches), on SMOKE in f32:
    with ``block_remat="dots"`` and ``rc.remat="whole_loss"``, two steps
    whose losses and gradient norms equal those of the default (full
    block remat on every encoder and decoder layer) to rtol 1e-6."""
    import dataclasses
    from repro_torch import api
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (AmbdgConfig, ConsensusConfig,
                                          RunConfig, TRAIN_4K)
    from repro_torch.data.pipeline import AnytimePipeline
    from repro_torch.models.api import build_model
    runs = []
    for block_remat, remat in (("dots", "whole_loss"), ("full", "none")):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32",
                                  block_remat=block_remat)
        rc = RunConfig(model=cfg, strategy=strategy, remat=remat,
                       shape=dataclasses.replace(TRAIN_4K, seq_len=24,
                                                 global_batch=4),
                       ambdg=AmbdgConfig(tau=1, b_bar=4.0, n_microbatches=2),
                       consensus=ConsensusConfig(n_workers=2, rounds=1))
        s = api.build(build_model(cfg, device="cpu"), rc, device="cpu")
        state = s.init_state(torch.Generator().manual_seed(0))
        pipe = AnytimePipeline(cfg, 2, 2, seq_len=24, seed=0)
        out = []
        for _ in range(2):
            batch = {k: torch.from_numpy(v)
                     for k, v in pipe.next_global_batch().items()}
            state, m = s.train_step(state, batch)
            out.append([float(m["loss"]), float(m.get("grad_norm",
                                                      m["loss"]))])
        runs.append(out)
    assert all(np.isfinite(runs[0]).ravel())
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-6)


def test_full_width_attention_head_dims_are_kernel_head_dims():
    """Every full-width config that attends has a head dim the flash
    kernels take, so ``attn_impl="flash"`` runs each on the card."""
    from repro_torch.configs import _MODULES, get_config
    from repro_torch.configs.base import DENSE, ENCDEC, HYBRID, MOE, VLM
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    dims = {arch: get_config(arch).resolved_head_dim for arch in _MODULES
            if get_config(arch).family in (DENSE, ENCDEC, HYBRID, MOE, VLM)}
    assert dims["zamba2-2.7b"] == 80 and dims["paligemma-3b"] == 256, dims
    assert len(dims) == 9, dims
    assert all(d in HEAD_DIMS for d in dims.values()), dims


def test_no_module_names_a_ported_part_of_a11_as_missing():
    """A.11 part 2's items 1-3 (the LMs on the mesh, the wire models and
    the byte census, the per-rank gossip) and 5 (``seq_parallel``) are
    ported: every mention of A.11 part 2 in the port names one of the
    items still open (4, 6-9: item 6's Mamba2 grouped B/C, item 9 the
    weights' storage over ``data``), and no module calls the per-rank
    fold unported."""
    import re
    for path in sorted(PORT.rglob("*.py")) + sorted(EXAMPLES.glob("*.py")):
        text = " ".join(path.read_text().split())
        text = re.sub(r'" "|"\s*f?"', "", text)   # joined string pieces
        for m in re.finditer(r"A\.11 part 2", text):
            assert re.match(r"A\.11 part 2, item [46789]\b",
                            text[m.start():]), (path, text[m.start() - 80:
                                                          m.end() + 40])
        for stale in ("not ported yet (ROADMAP A.11", "is ROADMAP A.11 part 2 "
                      "and raises", "one worker per card is ROADMAP"):
            assert stale not in text, (path, stale)
