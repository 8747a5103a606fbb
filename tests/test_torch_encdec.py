"""The encoder-decoder slice against the JAX package: seamless-m4t-large-v2
SMOKE (2 encoder + 2 decoder layers, d 64, 4 heads of 16, vocab 256),
JAX's weights carried across with ``convert.params_from_jax``,
numpy-seeded frames and tokens.

  * ``encode``, ``decode_train``, ``loss`` and the worker's gradient in
    f32, with the source as long as the target and with a source twice
    as long: the encoder's output and the logits within 1e-5 of the
    largest, the loss to rtol 1e-6, each gradient leaf within 1e-5 of
    its largest element;
  * in bf16 compute, each of those at most twice as far from JAX's f32
    result as JAX's own bf16 result is;
  * ``attn_impl="flash"`` (the kernels' plain version on CPU tensors)
    against "xla" in f32 within 1e-6, for the encoder and the
    cross-attention; the encoder's and the cross-attention's flash route
    is non-causal and the decoder's causal (what the kernels are asked
    for, and a first position that sees the last frame);
  * ``decode_step`` for 8 steps (scalar and ragged positions) against
    JAX's, with the memory K/V filled, continuing from JAX's cache
    (``convert.decode_state_from_jax``) after 4; prefill-by-decode
    against ``decode_train`` with the memory of a 16-frame source;
  * the engine's greedy tokens equal JAX's ``Engine.generate`` (f32);
  * AMB-DG through both packages' ``api.build`` in lockstep (tau 2, two
    microbatches, int8 pods), and ``train`` resuming from its checkpoint
    bit for bit;
  * ``TokenStream``'s frames and tokens bit-equal to JAX's;
  * ``n_params`` (JAX's count, which leaves out ``frame_proj``) and the
    leaves, pinned at FULL and SMOKE (ROADMAP C.17).
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
from repro.data.synthetic import TokenStream as JaxTokenStream
from repro.models import encdec as jed
from repro.models.api import build_model as jax_build_model
from repro.serve import Engine as JEngine
from repro_torch import api, convert
from repro_torch.configs import base, get_config, get_smoke_config
from repro_torch.core.anytime import accumulate_scan
from repro_torch.core.arena import tree_flatten
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import encdec as ed
from repro_torch.models.api import build_model
from repro_torch.serve import Engine
from repro_torch.train import loop as tloop

ARCH = "seamless-m4t-large-v2"
# (source, target) lengths
SHAPES = {"equal": (32, 32), "long_source": (48, 24)}


def _cfgs(dtype="float32", **kw):
    return tuple(dataclasses.replace(fn(ARCH), compute_dtype=dtype, **kw)
                 for fn in (jax_smoke_config, get_smoke_config))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _gap(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              or 1.0)


def _batch(cfg, src, tgt, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   size=(2, tgt)).astype(np.int32),
            "frames": rng.standard_normal((2, src, cfg.d_model))
            .astype(np.float32),
            "weights": np.array([1.0, 0.5], np.float32)}


def _jax_run(jcfg, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    memory = jax.jit(lambda p: jed.encode(p, jcfg, jb["frames"]))(jp)
    logits = jax.jit(lambda p: jed.decode_train(p, jcfg, jb["tokens"],
                                                memory))(jp)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jed.loss(p, jcfg, jb), has_aux=True))(jp)
    return memory, logits, float(loss), jax.tree.leaves(grads)


def _port_run(cfg, p, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        memory = ed.encode(p, cfg, tb["frames"])
        logits = ed.decode_train(p, cfg, tb["tokens"], memory)
    g, _, m = accumulate_scan(build_model(cfg, device="cpu").loss, p, tb, 1)
    return memory, logits, float(m["loss_sum"]), tree_flatten(g)[0]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs: the SMOKE model's tiny
    ops only wait on each other's threads, and under a parallel test run
    they take cores from the other workers (a 1.5 s test here ran 71 s
    with the default threads beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """JAX's init weights, as JAX's arrays and as the port's tensors."""
    jp, _ = jed.init(jax.random.PRNGKey(0), _cfgs()[0])
    return jp, convert.params_from_jax(jax.device_get(jp), device="cpu")


def test_params_from_jax_carries_the_tree(params):
    """The encdec tree comes across as it is: JAX's keys (the stacked
    ``encoder`` and ``decoder``), every leaf bit for bit, and the port's
    own init has the same tree, shapes and dtypes."""
    jp, p = params
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    leaves = tree_flatten(p)[0]
    own = tree_flatten(build_model(_cfgs()[1], device="cpu").init())[0]
    assert len(jl) == len(leaves) == len(own) == 28
    assert set(p) == {"tok_emb", "out_head", "frame_proj", "encoder",
                      "decoder", "ln_enc_final", "ln_final"}
    for (path, j), c, o in zip(jl, leaves, own):
        np.testing.assert_array_equal(c.numpy(), np.asarray(j))
        assert c.shape == o.shape and c.dtype == o.dtype, path


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_loss_and_gradient_match_jax(shape, params):
    src, tgt = SHAPES[shape]
    jcfg, cfg = _cfgs()
    jp, p = params
    batch = _batch(cfg, src, tgt)
    jmem, jl, jloss, jg = _jax_run(jcfg, jp, batch)
    mem, logits, loss, g = _port_run(cfg, p, batch)
    assert _gap(mem, jmem) <= 1e-5
    assert _gap(logits, jl) <= 1e-5
    assert loss == pytest.approx(jloss, rel=1e-6)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert len(g) == len(jg) == len(names)
    for name, a, b in zip(names, g, jg):
        assert _gap(a, b) <= 1e-5, (name, _gap(a, b))


def test_bf16_lies_within_twice_jax_distance_from_f32(params):
    jp, p = params
    batch = _batch(_cfgs()[1], 32, 32, seed=2)
    want = _jax_run(_cfgs()[0], jp, batch)
    jcfg, cfg = _cfgs("bfloat16")
    jax16 = _jax_run(jcfg, jp, batch)
    port16 = _port_run(cfg, p, batch)
    assert port16[1].dtype == torch.bfloat16
    for i in (0, 1):        # the encoder's output, the logits
        assert _gap(port16[i], want[i]) <= 2 * _gap(jax16[i], want[i]), i
    assert abs(port16[2] - want[2]) <= 2 * abs(jax16[2] - want[2])
    for i, (a, b, c) in enumerate(zip(port16[3], jax16[3], want[3])):
        assert _gap(a, c) <= 2 * _gap(b, c), (i, _gap(a, c), _gap(b, c))


def test_flash_route_matches_xla_in_the_encoder(params):
    """The encoder's output, the loss and the gradient under
    ``attn_impl="flash"`` (on CPU tensors, the kernels' plain version,
    non-causal) against "xla" (all-ones mask), f32, within 1e-6."""
    _, p = params
    cfg = _cfgs()[1]
    flash = dataclasses.replace(cfg, attn_impl="flash")
    batch = _batch(cfg, 48, 24, seed=3)
    want, got = _port_run(cfg, p, batch), _port_run(flash, p, batch)
    for i in (0, 1):
        assert _gap(got[i], want[i]) <= 1e-6, i
    assert got[2] == pytest.approx(want[2], rel=1e-6)
    for i, (a, b) in enumerate(zip(got[3], want[3])):
        assert _gap(a, b) <= 1e-6, i


def test_flash_route_matches_xla_in_the_cross_attention(params):
    """``_cross_attention`` through the flash route (non-causal, 24
    queries over 48 memory positions) against ``gqa_attend`` with the
    all-ones mask, f32, within 1e-6; and its gradient."""
    _, p = params
    cfg = _cfgs()[1]
    xp = {k: v[0] for k, v in p["decoder"]["xattn"].items()}
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model))
                         .astype(np.float32))
    memory = torch.from_numpy(rng.standard_normal((2, 48, cfg.d_model))
                              .astype(np.float32))

    def run(impl):
        xs = x.clone().requires_grad_(True)
        mk, mv = ed._memory_kv(xp, cfg, memory)
        y = ed._cross_attention(xp, cfg, xs, mk, mv, impl)
        torch.sum(y * torch.cos(y)).backward()
        return y.detach(), xs.grad

    (y_f, g_f), (y_x, g_x) = run("flash"), run("xla")
    assert _gap(y_f, y_x) <= 1e-6
    assert _gap(g_f, g_x) <= 1e-6


def test_flash_route_is_non_causal_where_it_must_be(params, monkeypatch):
    """Under "flash" the kernels are asked for the encoder's self-
    attention and the cross-attention non-causal and for the decoder's
    self-attention causal (one call each per layer), and the first
    target position's logits move with the last source frame (a causal
    encoder or cross-attention would hide it)."""
    from repro_torch.kernels.flash_attention import ops
    _, p = params
    cfg = dataclasses.replace(_cfgs()[1], attn_impl="flash")
    seen = []

    def spy(real):
        def call(q, k, v, *, causal=True, window=None, impl="auto"):
            seen.append((causal, q.shape[2], k.shape[2]))
            return real(q, k, v, causal=causal, window=window, impl=impl)
        return call

    for name in ("attend", "attend_train"):
        monkeypatch.setattr(ops, name, spy(getattr(ops, name)))
    batch = _batch(cfg, 48, 24, seed=5)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    build_model(cfg, device="cpu").loss(p, tb)
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    assert seen == ([(False, 48, 48)] * n_enc
                    + [(True, 24, 24), (False, 24, 48)] * n_dec)
    with torch.no_grad():
        base_logits = ed.decode_train(p, cfg, tb["tokens"],
                                      ed.encode(p, cfg, tb["frames"]))
        frames = tb["frames"].clone()
        frames[:, -1] += 1.0
        moved = ed.decode_train(p, cfg, tb["tokens"],
                                ed.encode(p, cfg, frames))
    assert float((moved[:, 0] - base_logits[:, 0]).abs().max()) > 1e-3


def _fill_memory(jcache, cfg, seed):
    """JAX's decode cache with random memory K/V (the serve path leaves
    them 0, C.17): the cross-attention then reads something."""
    rng = np.random.default_rng(seed)
    for key in ("mem_k", "mem_v"):
        jcache[key] = jnp.asarray(rng.standard_normal(
            jcache[key].shape).astype(np.float32))
    return jcache


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
def test_decode_matches_jax(ragged, params):
    jcfg, cfg = _cfgs()
    jp, p = params
    B = 3
    jcache, jaxes = jed.init_decode_state(jcfg, B, 16, jnp.float32)
    jcache = _fill_memory(jcache, cfg, 7)
    model = build_model(cfg, device="cpu")
    cache, caxes = model.init_decode_state(B, 16, torch.float32)
    assert caxes == jaxes       # the engine's slot reset reads "batch"
    assert set(cache) == {"self", "mem_k", "mem_v"}
    for key in ("mem_k", "mem_v"):
        cache[key].copy_(torch.from_numpy(np.array(jcache[key])))
    jstep = jax.jit(lambda p_, c, t, pos: jed.decode_step(p_, jcfg, c, t,
                                                          pos))
    rng = np.random.default_rng(11)
    for t in range(8):
        if t == 4:     # continue from JAX's cache, carried across
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


def test_decode_matches_decode_train(params):
    """Prefill-by-decode over 16 target tokens, with the memory K/V of a
    16-frame source's encoder output in the cache, against the teacher-
    forced decoder at every position, f32."""
    _, p = params
    cfg = _cfgs()[1]
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, 16, 16, seed=8).items()}
    model = build_model(cfg, device="cpu")
    cache, _ = model.init_decode_state(2, 16, torch.float32)
    with torch.no_grad():
        memory = ed.encode(p, cfg, batch["frames"])
        full = ed.decode_train(p, cfg, batch["tokens"], memory)
        for i in range(cfg.n_layers):
            xp = {k: v[i] for k, v in p["decoder"]["xattn"].items()}
            mk, mv = ed._memory_kv(xp, cfg, memory)
            cache["mem_k"][i].copy_(mk)
            cache["mem_v"][i].copy_(mv)
        for pos in range(16):
            logits, cache = model.decode_step(
                p, cache, batch["tokens"][:, pos:pos + 1], pos)
            assert _gap(logits[:, 0], full[:, pos]) <= 1e-5, pos


def test_engine_tokens_equal_jax():
    """Two rounds of generate on one engine (the second round's prompts
    enter slots the first left, reset to the zero template): the greedy
    tokens and the counters equal JAX's, f32."""
    jcfg, cfg = _cfgs()
    jengine = JEngine(jax_build_model(jcfg), 3, 48)
    engine = Engine(build_model(cfg, device="cpu"), 3, 48)
    engine.params = convert.params_from_jax(jax.device_get(jengine.params),
                                            device="cpu")
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
                               smoothness_L=8.0, pod_compression="int8",
                               **kw))


def test_ambdg_steps_match_jax():
    """Five AMB-DG steps (tau 2, two microbatches, int8 pods) from JAX's
    init on the same batches, JAX's step eager (C.4): counts exact, loss
    to rtol 1e-5, the grad norm to rtol 1e-5 plus one quantization step,
    z and w to 1e-5 of their largest element plus one quantization step
    (``test_torch_lm_slice.py``'s limits)."""
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
    q_step = 0.0
    for t in range(5):
        batch, jbatch = pipe.next_global_batch(), jpipe.next_global_batch()
        assert set(batch) == {"tokens", "frames", "weights"}
        for k in batch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
        jstate, jm = js.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        pstate, pm = ps.train_step(pstate, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        count = pm["applied_count"].item()
        assert count == float(jm["applied_count"])
        assert (count == 0.0) == (t < 2)
        assert pm["local_count"].item() == float(jm["local_count"])
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss at {t}")
        q_now = (max(float(s.max()) for s in pstate.arena.scales) / count
                 if count else 0.0)
        q_step = max(q_step, q_now)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   atol=q_now, err_msg=f"grad norm at {t}")
    assert float(jm["grad_norm"]) > 0.0
    jz = np.asarray(jstate.opt_state.z)
    z_tol = 1e-5 * np.abs(jz).max() + q_step
    np.testing.assert_allclose(pstate.opt_state.z.numpy(), jz, rtol=0,
                               atol=z_tol)
    for w, jw in zip(tree_flatten(pstate.params)[0],
                     jax.tree.leaves(jstate.params)):
        jw = np.asarray(jw)
        np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max() + z_tol)


def test_train_resumes_from_its_checkpoint_bit_for_bit(tmp_path):
    """``train`` (bf16 compute, int8 pods) stopped after 3 steps and
    restarted from its checkpoint ends where the uninterrupted 5-step
    run ends, bit for bit."""
    cfg = get_smoke_config(ARCH)
    rc = _rc(base, cfg)
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


@pytest.mark.parametrize("seq", [16, 40])
def test_token_stream_draws_equal_jax(seq):
    """Three batches of tokens and frames, bit for bit, and the cursor."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    ours, theirs = TokenStream(cfg, seed=5), JaxTokenStream(jcfg, seed=5)
    for _ in range(3):
        a, b = ours.next_batch(3, seq), theirs.next_batch(3, seq)
        assert set(a) == set(b) == {"tokens", "weights", "frames"}
        assert a["frames"].shape == (3, seq, cfg.d_model)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.state_dict() == theirs.state_dict()


def test_param_counts_are_pinned_to_jax():
    """JAX's ``n_params`` (no ``frame_proj``; the unpadded vocab) and JAX's
    leaves (with ``frame_proj``, the padded embedding and head): they
    differ (ROADMAP C.17)."""
    for fn, jfn, count, leaves in (
            (get_smoke_config, jax_smoke_config, 205_568, 209_664),
            (get_config, jax_config, 2_034_784_256, 2_035_935_232)):
        cfg, jcfg = fn(ARCH), jfn(ARCH)
        assert cfg.n_params() == jcfg.n_params() == count
        shapes = jax.eval_shape(lambda: jed.init(jax.random.PRNGKey(0),
                                                 jcfg)[0])
        jn = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        n = sum(x.numel() for x in tree_flatten(
            build_model(cfg, device="cpu").param_shapes())[0])
        assert n == jn == leaves
