"""The VLM slice against the JAX package: paligemma-3b SMOKE (2 layers, d
64, 4 query heads on 1 kv head of 16, 16 stub patches, prefix-LM, tied
embeddings, vocab 256), JAX's weights carried across with
``convert.params_from_jax``, numpy-seeded patches and tokens.

  * ``forward`` (the patches in front of the text, bidirectional over
    them), ``lm_loss`` (on the text alone) and the worker's gradient in
    f32 at two text lengths: logits within 1e-5 of the largest, the loss
    to rtol 1e-6, each gradient leaf within 1e-5 of its largest element;
  * in bf16 compute, each of those at most twice as far from JAX's f32
    result as JAX's own bf16 result is;
  * the prefix: a patch sees the last patch, a text position no later
    text; ``attn_impl="flash"`` raises (the kernels compute no prefix);
  * the decode is the dense one and never sees the patches (ROADMAP
    C.17): prefill-by-decode equals the forward of the text alone with no
    prefix;
  * the engine's greedy tokens equal JAX's ``Engine.generate`` (f32);
  * AMB-DG through both packages' ``api.build`` in lockstep (tau 2, two
    microbatches, int8 pods), and ``train`` resuming from its checkpoint
    bit for bit;
  * ``TokenStream``'s patches and text bit-equal to JAX's;
  * ``n_params`` (JAX's count, the stub as its 16 / 256 positions) and
    the leaves (``patch_proj`` and ``patch_pos``), pinned (C.17).
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
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro.serve import Engine as JEngine
from repro_torch import api, convert
from repro_torch.configs import base, get_config, get_smoke_config
from repro_torch.core.anytime import accumulate_scan
from repro_torch.core.arena import tree_flatten
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model
from repro_torch.serve import Engine
from repro_torch.train import loop as tloop

ARCH = "paligemma-3b"
TEXT = {"short_text": 8, "long_text": 48}


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


def _batch(cfg, text, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   size=(2, text)).astype(np.int32),
            "patches": rng.standard_normal(
                (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32),
            "weights": np.array([1.0, 0.5], np.float32)}


def _jax_run(jcfg, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = jax.jit(lambda p: jtf.forward(
        p, jcfg, jb["tokens"], extra={"patches": jb["patches"]}))(jp)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jb), has_aux=True))(jp)
    return logits, float(loss), jax.tree.leaves(grads)


def _port_run(cfg, p, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = tf.forward(p, cfg, tb["tokens"],
                                 extra={"patches": tb["patches"]})
    assert float(aux) == 0.0
    g, _, m = accumulate_scan(build_model(cfg, device="cpu").loss, p, tb, 1)
    return logits, float(m["loss_sum"]), tree_flatten(g)[0]


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
    jp, _ = jtf.init(jax.random.PRNGKey(0), _cfgs()[0])
    return jp, convert.params_from_jax(jax.device_get(jp), device="cpu")


def test_params_from_jax_carries_the_tree(params):
    """JAX's keys (the stub's ``patch_proj`` and ``patch_pos`` beside the
    dense tree), every leaf bit for bit; the port's own init has the same
    tree, shapes and dtypes."""
    jp, p = params
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    own = tree_flatten(build_model(_cfgs()[1], device="cpu").init())[0]
    assert len(jl) == len(tree_flatten(p)[0]) == len(own) == 13
    assert set(p) == {"tok_emb", "ln_final", "layers", "patch_proj",
                      "patch_pos"}
    assert tuple(p["patch_pos"].shape) == (16, 64)
    for (path, j), c, o in zip(jl, tree_flatten(p)[0], own):
        np.testing.assert_array_equal(c.numpy(), np.asarray(j))
        assert c.shape == o.shape and c.dtype == o.dtype, path


@pytest.mark.parametrize("text", list(TEXT))
def test_forward_loss_and_gradient_match_jax(text, params):
    jcfg, cfg = _cfgs()
    jp, p = params
    batch = _batch(cfg, TEXT[text])
    jl, jloss, jg = _jax_run(jcfg, jp, batch)
    logits, loss, g = _port_run(cfg, p, batch)
    assert logits.shape[1] == cfg.n_frontend_tokens + TEXT[text]
    assert _gap(logits, jl) <= 1e-5
    assert loss == pytest.approx(jloss, rel=1e-6)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert len(g) == len(jg) == len(names)
    for name, a, b in zip(names, g, jg):
        assert _gap(a, b) <= 1e-5, (name, _gap(a, b))


def test_bf16_lies_within_twice_jax_distance_from_f32(params):
    jp, p = params
    batch = _batch(_cfgs()[1], 32, seed=2)
    want = _jax_run(_cfgs()[0], jp, batch)
    jcfg, cfg = _cfgs("bfloat16")
    jax16 = _jax_run(jcfg, jp, batch)
    port16 = _port_run(cfg, p, batch)
    assert port16[0].dtype == torch.bfloat16
    assert _gap(port16[0], want[0]) <= 2 * _gap(jax16[0], want[0])
    assert abs(port16[1] - want[1]) <= 2 * abs(jax16[1] - want[1])
    for i, (a, b, c) in enumerate(zip(port16[2], jax16[2], want[2])):
        assert _gap(a, c) <= 2 * _gap(b, c), (i, _gap(a, c), _gap(b, c))


def test_patches_form_a_bidirectional_prefix(params):
    """Moving the last patch moves the first patch position's logits (the
    prefix attends both ways); moving the last text token moves no earlier
    position; the flash route raises, as its kernels compute no prefix."""
    _, p = params
    cfg = _cfgs()[1]
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 16, seed=3).items()}
    with torch.no_grad():
        base_logits, _ = tf.forward(p, cfg, b["tokens"],
                                    extra={"patches": b["patches"]})
        patches = b["patches"].clone()
        patches[:, -1] += 1.0
        moved, _ = tf.forward(p, cfg, b["tokens"], extra={"patches": patches})
        tokens = b["tokens"].clone()
        tokens[:, -1] = (tokens[:, -1] + 1) % cfg.vocab_size
        later, _ = tf.forward(p, cfg, tokens, extra={"patches": b["patches"]})
    assert float((moved[:, 0] - base_logits[:, 0]).abs().max()) > 1e-3
    assert torch.equal(later[:, :-1], base_logits[:, :-1])
    with pytest.raises(NotImplementedError, match="prefix_lm"):
        build_model(dataclasses.replace(cfg, attn_impl="flash"),
                    device="cpu")


def test_decode_sees_no_patches(params):
    """The decode is the dense one (JAX's never sees the patches, C.17):
    prefill-by-decode over 24 text tokens equals the forward of the text
    alone with no prefix at every position, f32; the forward's default
    prefix of n_frontend_tokens positions is another function."""
    _, p = params
    cfg = _cfgs()[1]
    toks = torch.from_numpy(_batch(cfg, 24, seed=4)["tokens"])
    model = build_model(cfg, device="cpu")
    cache, _ = model.init_decode_state(2, 24, torch.float32)
    assert set(cache) == {"k", "v"}
    with torch.no_grad():
        causal, _ = tf.forward(p, cfg, toks, prefix_len=0)
        prefixed, _ = tf.forward(p, cfg, toks)
        for pos in range(24):
            logits, cache = model.decode_step(p, cache, toks[:, pos:pos + 1],
                                              pos)
            assert _gap(logits[:, 0], causal[:, pos]) <= 1e-5, pos
    assert _gap(prefixed[:, 0], causal[:, 0]) > 1e-3


def test_engine_tokens_equal_jax():
    """Two rounds of generate on one engine: the greedy tokens and the
    counters equal JAX's, f32."""
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


def _rc(cfgs, model_cfg, seq=32):
    return cfgs.RunConfig(
        model=model_cfg,
        shape=dataclasses.replace(cfgs.TRAIN_4K, seq_len=seq, global_batch=4),
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(tau=2, n_microbatches=2, b_bar=4.0,
                               smoothness_L=8.0, pod_compression="int8"))


def test_ambdg_steps_match_jax():
    """Five AMB-DG steps (tau 2, two microbatches, int8 pods) from JAX's
    init on the same batches (16 patches + 16 text tokens a sample), JAX's
    step eager (C.4): counts exact, loss to rtol 1e-5, the grad norm to
    rtol 1e-5 plus one quantization step, z and w to 1e-5 of their
    largest element plus one quantization step."""
    jcfg, cfg = _cfgs()
    js = japi.build(jax_build_model(jcfg), _rc(jbase, jcfg))
    ps = api.build(build_model(cfg, device="cpu"), _rc(base, cfg),
                   device="cpu")
    jstate = js.init_state(jax.random.PRNGKey(0))
    pstate = ps.init_state(torch.Generator().manual_seed(0))
    pstate = pstate._replace(params=convert.params_from_jax(
        jax.device_get(jstate.params), device="cpu"))
    jpipe = JaxPipeline(jcfg, 2, 2, seq_len=32, seed=0)
    pipe = AnytimePipeline(cfg, 2, 2, seq_len=32, seed=0)
    q_step = 0.0
    for t in range(5):
        batch, jbatch = pipe.next_global_batch(), jpipe.next_global_batch()
        assert batch["tokens"].shape == (4, 16)
        for k in batch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
        jstate, jm = js.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        pstate, pm = ps.train_step(pstate, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        count = pm["applied_count"].item()
        assert count == float(jm["applied_count"])
        assert (count == 0.0) == (t < 2)
        assert pm["local_count"].item() == float(jm["local_count"]) == 60.0
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


@pytest.mark.parametrize("seq", [24, 64])
def test_token_stream_draws_equal_jax(seq):
    """Three batches of text and patches, bit for bit (the text
    seq - n_frontend_tokens long), and the cursor."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    ours, theirs = TokenStream(cfg, seed=5), JaxTokenStream(jcfg, seed=5)
    for _ in range(3):
        a, b = ours.next_batch(3, seq), theirs.next_batch(3, seq)
        assert set(a) == set(b) == {"tokens", "weights", "patches"}
        assert a["tokens"].shape == (3, seq - cfg.n_frontend_tokens)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.state_dict() == theirs.state_dict()


def test_param_counts_are_pinned_to_jax():
    """JAX's ``n_params`` (the stub counted as its n_frontend_tokens
    positions; the unpadded vocab) and JAX's leaves (``patch_proj`` (d,
    d), ``patch_pos`` (P, d), the padded embedding): they differ (ROADMAP
    C.17)."""
    for fn, jfn, count, leaves in (
            (get_smoke_config, jax_smoke_config, 86_352, 91_456),
            (get_config, jax_config, 2_508_663_040, 2_513_512_448)):
        cfg, jcfg = fn(ARCH), jfn(ARCH)
        assert cfg.n_params() == jcfg.n_params() == count
        shapes = jax.eval_shape(lambda: jtf.init(jax.random.PRNGKey(0),
                                                 jcfg)[0])
        jn = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        n = sum(x.numel() for x in tree_flatten(
            build_model(cfg, device="cpu").param_shapes())[0])
        assert n == jn == leaves
