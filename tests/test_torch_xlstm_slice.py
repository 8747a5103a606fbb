"""The xLSTM slice against the JAX package: xlstm-125m SMOKE (2 layers:
an mLSTM block, then an sLSTM block; d 64, vocab 256), JAX's weights
carried across with ``convert.params_from_jax``, numpy-seeded tokens.

  * ``forward``, ``lm_loss`` and the worker's gradient in f32: logits
    within 1e-5 of the largest, the loss to rtol 1e-6, each gradient leaf
    within 1e-5 of its largest element; at S = 64 (one mLSTM chunk) and
    at S = 128 with conv_width 1 (chunks of 64: the carry runs). These
    run with the sLSTM's recurrent weights ``w_h`` scaled by sqrt(nh /
    hd), as if drawn at fan-in hd: at JAX's own init (fan-in nh, ROADMAP
    C.16) the recurrence is chaotic and JAX's f32 gradient moves by 4e-4
    (S = 64) to 2.3 (S = 128) of a leaf's largest element when each
    weight moves by 1e-7 of itself. At JAX's own init (S = 32) the
    port's gradient is held to twice that motion of JAX's own;
  * in bf16 compute (S = 64), each of those at most twice as far from
    JAX's f32 result as JAX's own bf16 result is (the two frameworks
    round bf16 products in other orders);
  * ``decode_step`` for 8 steps from the initial state, with a scalar
    and with ragged positions (the recurrence reads none): logits and the
    whole state within 1e-5 of the largest, the port continuing from
    JAX's state (``convert.decode_state_from_jax``) after 4 steps;
    prefill-by-decode against the
    forward at the last position (JAX's ``test_decode_matches_forward``,
    at f32 limits) over two chunks, with the scaled ``w_h``;
  * the engine's greedy tokens equal JAX's ``Engine.generate`` in f32,
    with a second round of prompts admitted into the slots the first
    round's requests left (the reset restores both m floors);
  * AMB-DG through both packages' ``api.build`` in lockstep (tau 2, two
    microbatches), and ``train`` with a checkpoint that resumes bit for
    bit;
  * ``n_params`` is JAX's formula and the leaves are JAX's leaves, both
    pinned (they differ, ROADMAP C.15).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import base as jbase
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import AnytimePipeline as JaxPipeline
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro.serve import Engine as JEngine
from repro_torch import api, convert
from repro_torch.configs import base, get_config, get_smoke_config
from repro_torch.core.anytime import accumulate_scan
from repro_torch.core.arena import tree_flatten
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model
from repro_torch.serve import Engine
from repro_torch.train import loop as tloop

ARCH = "xlstm-125m"
# (seq, conv_width): one chunk of 256 -> 64; chunks of 64 over 128
SHAPES = {"one_chunk": (64, 4), "two_chunks": (128, 1)}


def _cfgs(dtype="float32", conv_width=4):
    def one(fn):
        c = fn(ARCH)
        return dataclasses.replace(c, compute_dtype=dtype,
                                   xlstm=dataclasses.replace(
                                       c.xlstm, conv_width=conv_width))
    return one(jax_smoke_config), one(get_smoke_config)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _gap(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              or 1.0)


def _batch(cfg, seq, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(2, seq)).astype(np.int32)
    return {"tokens": toks, "weights": np.array([1.0, 0.5], np.float32)}


def _jax_run(jcfg, jparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = jax.jit(lambda p: jtf.forward(p, jcfg, jb["tokens"]))(jparams)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jb), has_aux=True))(jparams)
    return logits, float(loss), jax.tree.leaves(grads)


def _port_run(cfg, params, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = tf.forward(params, cfg, tb["tokens"])
    assert float(aux) == 0.0
    g, _, m = accumulate_scan(build_model(cfg, device="cpu").loss, params,
                              tb, 1)
    return logits, float(m["loss_sum"]), tree_flatten(g)[0]


def _pair(jp):
    return jp, convert.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The sLSTM's time loop runs thousands of tiny ops: intra-op threads
    only wait on each other there, and under a parallel test run they
    take cores from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's init weights (as JAX and as the port's tensors)."""
    jp, _ = jtf.init(jax.random.PRNGKey(0), _cfgs()[0])
    return _pair(jp)


@pytest.fixture(scope="module")
def scaled_params(jax_params):
    """JAX's init with the sLSTM's ``w_h`` (nh, hd, 4 hd) rescaled from
    fan-in nh to fan-in hd: a recurrence whose f32 gradient is well
    conditioned (ROADMAP C.16)."""
    jp = jax_params[0]
    sl = dict(jp["slstm_layers"]["slstm"])
    nh, hd = sl["w_h"].shape[1:3]
    sl["w_h"] = sl["w_h"] * np.float32(np.sqrt(nh / hd))
    return _pair(dict(jp, slstm_layers=dict(jp["slstm_layers"], slstm=sl)))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_loss_and_gradient_match_jax(shape, scaled_params):
    seq, cw = SHAPES[shape]
    jcfg, cfg = _cfgs("float32", cw)
    jp, p = scaled_params
    batch = _batch(cfg, seq)
    jl, jloss, jg = _jax_run(jcfg, jp, batch)
    logits, loss, g = _port_run(cfg, p, batch)
    assert _gap(logits, jl) <= 1e-5
    assert loss == pytest.approx(jloss, rel=1e-6)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert len(g) == len(jg) == len(names) == 20
    for name, a, b in zip(names, g, jg):
        assert _gap(a, b) <= 1e-5, (name, _gap(a, b))


def test_gradient_at_jax_init_moves_no_more_than_jax_own(jax_params):
    """At JAX's own init (S = 32) the f32 gradient is ill-conditioned:
    the port's distance from JAX's, leaf by leaf, is at most twice how
    far JAX's own gradient moves when every weight moves by 1e-7 of
    itself (numpy-seeded); the logits and the loss hold the f32 limits."""
    jcfg, cfg = _cfgs()
    jp, p = jax_params
    batch = _batch(cfg, 32)
    jl, jloss, jg = _jax_run(jcfg, jp, batch)
    rng = np.random.default_rng(0)
    moved = jax.tree.map(lambda a: a * (1 + 1e-7 * rng.standard_normal(
        a.shape).astype(np.float32)), jp)
    _, _, jg_moved = _jax_run(jcfg, moved, batch)
    logits, loss, g = _port_run(cfg, p, batch)
    assert _gap(logits, jl) <= 1e-5
    assert loss == pytest.approx(jloss, rel=1e-6)
    motion = max(_gap(a, b) for a, b in zip(jg_moved, jg))
    assert motion > 1e-5                  # the f32 limit does not apply
    for i, (a, b) in enumerate(zip(g, jg)):
        assert _gap(a, b) <= 2 * motion, (i, _gap(a, b), motion)


def test_bf16_lies_within_twice_jax_distance_from_f32(scaled_params):
    seq, cw = SHAPES["one_chunk"]
    jp, p = scaled_params
    batch = _batch(_cfgs()[1], seq, seed=2)
    want = _jax_run(_cfgs("float32", cw)[0], jp, batch)
    jcfg, cfg = _cfgs("bfloat16", cw)
    jax16 = _jax_run(jcfg, jp, batch)
    port16 = _port_run(cfg, p, batch)
    assert port16[0].dtype == torch.bfloat16
    assert _gap(port16[0], want[0]) <= 2 * _gap(jax16[0], want[0])
    assert abs(port16[1] - want[1]) <= 2 * abs(jax16[1] - want[1])
    for i, (a, b, c) in enumerate(zip(port16[2], jax16[2], want[2])):
        assert _gap(a, c) <= 2 * _gap(b, c), (i, _gap(a, c), _gap(b, c))


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
def test_decode_matches_jax(ragged, jax_params):
    jcfg, cfg = _cfgs()
    jp, p = jax_params
    B = 3
    jcache, jaxes = jtf.init_decode_state(jcfg, B, 16, jnp.float32)
    model = build_model(cfg, device="cpu")
    cache, caxes = model.init_decode_state(B, 16, torch.float32)
    assert caxes == jaxes       # the engine's slot reset reads "batch"
    jstep = jax.jit(lambda p_, c, t, pos: jtf.decode_step(p_, jcfg, c, t,
                                                          pos))
    rng = np.random.default_rng(11)
    for t in range(8):
        if t == 4:     # continue from JAX's state, carried across
            cache = convert.decode_state_from_jax(jax.device_get(jcache),
                                                  device="cpu")
        toks = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = (np.array([t, t + 3, t + 5], np.int32) if ragged
               else np.int32(t))
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(toks),
                                jnp.asarray(pos))
        with torch.no_grad():
            logits, out = model.decode_step(p, cache, torch.from_numpy(toks),
                                            torch.as_tensor(pos))
        assert out is cache
        assert _gap(logits, jlogits) <= 1e-5, t
    for c, j in zip(tree_flatten(cache)[0], jax.tree.leaves(jcache)):
        assert _gap(c, j) <= 1e-5


def test_decode_matches_forward(scaled_params):
    """Prefill-by-decode over 128 tokens (two chunks of 64 in the
    forward) against the forward's last position, f32."""
    _, cfg = _cfgs("float32", 1)
    _, p = scaled_params
    toks = torch.from_numpy(_batch(cfg, 128)["tokens"][:1])
    model = build_model(cfg, device="cpu")
    cache, _ = model.init_decode_state(1, 128, torch.float32)
    with torch.no_grad():
        full, _ = tf.forward(p, cfg, toks)
        for pos in range(128):
            logits, cache = model.decode_step(p, cache, toks[:, pos:pos + 1],
                                              pos)
    assert _gap(logits[0, 0], full[0, -1]) <= 1e-5


def test_engine_tokens_equal_jax():
    """Two rounds of generate on one engine: the second round's prompts
    enter slots the first round's requests left, so each is reset to the
    init template (C, n, h, c at 0; the mLSTM m at -1e30, the sLSTM m at
    -30) before it is read."""
    jcfg, cfg = _cfgs()
    jengine = JEngine(jax_build_model(jcfg), 3, 48)
    engine = Engine(build_model(cfg, device="cpu"), 3, 48)
    engine.params = convert.params_from_jax(jax.device_get(jengine.params),
                                            device="cpu")
    assert float(engine._cache0["slstm"]["m"].max()) == -30.0
    assert float(engine._cache0["mlstm"]["m"].max()) == float(
        np.float32(-1e30))
    rng = np.random.default_rng(0)
    for n_new, lens in ((12, (4, 7, 5)), (9, (6, 3, 8))):
        prompts = [list(rng.integers(1, cfg.vocab_size, size=n))
                   for n in lens]
        want = jengine.generate(prompts, max_new=n_new)
        got = engine.generate(prompts, max_new=n_new)
        assert got == want
    assert dataclasses.asdict(engine.stats) == \
        dataclasses.asdict(jengine.stats)
    assert engine.stats.admitted == 6


def _rc(cfgs, model_cfg, seq=16, **kw):
    return cfgs.RunConfig(
        model=model_cfg,
        shape=dataclasses.replace(cfgs.TRAIN_4K, seq_len=seq, global_batch=4),
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(tau=2, n_microbatches=2, b_bar=4.0,
                               smoothness_L=8.0, **kw))


def test_ambdg_steps_match_jax():
    """Four AMB-DG steps from JAX's init on the same batches: counts
    exact, loss and grad norm to rtol 1e-5, w and z to 1e-5 of z's
    largest element (``test_torch_moe_train.py``'s limits)."""
    jcfg, cfg = _cfgs()
    js = japi.build(jax_build_model(jcfg), _rc(jbase, jcfg))
    ps = api.build(build_model(cfg, device="cpu"), _rc(base, cfg),
                   device="cpu")
    jstate = js.init_state(jax.random.PRNGKey(0))
    pstate = ps.init_state(torch.Generator().manual_seed(0))
    pstate = pstate._replace(params=convert.params_from_jax(
        jax.device_get(jstate.params), device="cpu"))
    jpipe = JaxPipeline(jcfg, 2, 2, seq_len=16, seed=0)
    pipe = AnytimePipeline(cfg, 2, 2, seq_len=16, seed=0)
    jstep = jax.jit(js.train_step)
    for t in range(4):
        batch, jbatch = pipe.next_global_batch(), jpipe.next_global_batch()
        for k in batch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        pstate, pm = ps.train_step(pstate, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        assert pm["applied_count"].item() == float(jm["applied_count"])
        assert (pm["applied_count"].item() == 0.0) == (t < 2)
        assert pm["local_count"].item() == float(jm["local_count"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(pm[key].item(), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} at {t}")
    jz = np.asarray(jstate.opt_state.z)
    assert _gap(pstate.opt_state.z, jz) <= 1e-5
    for w, jw in zip(tree_flatten(pstate.params)[0],
                     jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-5 * np.abs(jz).max())


def test_train_resumes_from_its_checkpoint_bit_for_bit(tmp_path):
    """``train`` (int8 pod compression) stopped after 3 steps and
    restarted from its checkpoint ends where the uninterrupted 5-step run
    ends, bit for bit."""
    cfg = _cfgs()[1]
    rc = _rc(base, cfg, pod_compression="int8")
    loop = dict(n_workers=2, samples_per_worker=2, log_every=1,
                ckpt_every=3)

    def run(n, d):
        return tloop.train(build_model(cfg, device="cpu"), rc,
                           tloop.LoopConfig(n_steps=n, ckpt_dir=str(d),
                                            **loop), device="cpu")

    whole = run(5, tmp_path / "whole")
    run(3, tmp_path / "split")
    rest = run(5, tmp_path / "split")
    assert [h["step"] for h in rest["history"]] == [4, 5]
    for a, b in zip(rest["history"], whole["history"][3:]):
        assert {k: v for k, v in a.items() if not k.endswith("_s")} == \
            {k: v for k, v in b.items() if not k.endswith("_s")}
    for a, b in zip(tree_flatten(rest["state"].params)[0],
                    tree_flatten(whole["state"].params)[0]):
        assert torch.equal(a, b)
    assert torch.equal(rest["state"].opt_state.z, whole["state"].opt_state.z)
    assert all(np.isfinite(h["loss"]) for h in whole["history"])


def test_param_counts_are_pinned_to_jax():
    """JAX's ``n_params`` formula (8 d^2 for the sLSTM gates, 2 d_in for
    the mLSTM gates) and JAX's leaves (w_x and a block-diagonal w_h;
    w_i, w_f of (d_in, n_heads) and their biases; the padded embedding)."""
    for fn, jfn, count, leaves in (
            (get_smoke_config, jax_smoke_config, 139_776, 132_100),
            (get_config, jax_config, 144_825_600, 134_380_848)):
        cfg, jcfg = fn(ARCH), jfn(ARCH)
        assert cfg.n_params() == jcfg.n_params() == count
        shapes = jax.eval_shape(lambda: jtf.init(jax.random.PRNGKey(0),
                                                 jcfg)[0])
        jn = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        n = sum(x.numel() for x in tree_flatten(
            build_model(cfg, device="cpu").param_shapes())[0])
        assert n == jn == leaves
