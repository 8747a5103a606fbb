"""The port's DENSE transformer (``repro_torch.models.transformer``)
against the JAX model, for the four DENSE SMOKE configs (qwen1.5-0.5b:
MHA with QKV bias, tied; qwen3-1.7b: GQA with qk-norm; yi-6b: GQA,
untied; chatglm3-6b: partial RoPE, QKV bias, GQA).

The JAX weights are carried across with ``convert.params_from_jax`` and
both models see the same numpy-seeded tokens. Logits, ``lm_loss`` (sum
and count) and every gradient leaf are compared, for ``attn_impl``
"xla" (``gqa_attend``, the JAX model's attention) and "flash" (on the
CPU the flash path's plain version, ``attention_ref``; the JAX model
computes ``gqa_attend`` whatever its knob says).

Tolerances, each relative to the largest magnitude of the tensor
compared:
  * compute_dtype float32 (the algorithm): 1e-5, summation order of
    the two frameworks' f32 matmuls;
  * compute_dtype bfloat16 (the default): bf16 keeps 8 significant bits
    (unit roundoff 2^-8 = 3.9e-3) and the two frameworks round at other
    places (XLA fuses elementwise chains in f32, PyTorch rounds after
    each op; the flash path keeps the softmax unrounded where
    gqa_attend rounds its scores and weights), so logits get 2e-2 (five
    roundings), gradients, which pass back through both layers and the
    head, 5e-2, and the f32 loss sum over bf16 logits 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import arena as jarena
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import arena
from repro_torch.core.arena import tree_flatten
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model

ARCHS = ["qwen1.5-0.5b", "qwen3-1.7b", "yi-6b", "chatglm3-6b"]
TOL = {"float32": dict(logits=1e-5, loss=1e-5, grads=1e-5),
       "bfloat16": dict(logits=2e-2, loss=2e-3, grads=5e-2)}


def _rel_err(got, want):
    got = np.asarray(got.detach().to(torch.float32).numpy()
                     if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _batch(cfg):
    b = TokenStream(cfg, seed=3).next_batch(2, 32)
    b["weights"] = np.array([1.0, 0.5], np.float32)
    return b


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, dtype, attn_impl):
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype,
                              attn_impl=attn_impl)
    jparams, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tol = TOL[dtype]

    jlogits, _ = jtf.forward(jparams, jcfg, jbatch["tokens"])
    with torch.no_grad():
        logits, aux = tf.forward(params, cfg, tbatch["tokens"])
    assert float(aux) == 0.0        # a dense model has no MoE aux loss
    assert logits.dtype == getattr(torch, dtype)
    assert tuple(logits.shape) == (2, 32, cfg.padded_vocab_size)
    assert _rel_err(logits, jlogits) <= tol["logits"]

    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jbatch), has_aux=True)(jparams)
    leaves, treedef = tree_flatten(params)
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, aux = tf.lm_loss(arena.tree_unflatten(treedef, leaves), cfg,
                           tbatch)
    assert aux["count"].item() == float(jaux["count"]) == 1.5 * 31
    assert _rel_err(loss, jloss) <= tol["loss"]
    assert _rel_err(aux["loss_sum"], jaux["loss_sum"]) <= tol["loss"]
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        assert g.shape == jg.shape and g.dtype == torch.float32
        assert _rel_err(g, jg) <= tol["grads"]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_arena_layout_match_jax(arch):
    """The same leaf names, shapes and dtypes as JAX's init, stacked
    layers along dim 0, and ``make_layout`` (from the meta device)
    giving JAX's row offsets; the draws follow JAX's distributions."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    shapes = model.param_shapes()
    jl, jdef = jax.tree_util.tree_flatten_with_path(jparams)
    names = [jax.tree_util.keystr(p) for p, _ in jl]
    leaves, _ = tree_flatten(params)
    metas, _ = tree_flatten(shapes)
    assert len(leaves) == len(metas) == len(jl)
    for name, (_, j), p, m in zip(names, jl, leaves, metas):
        assert tuple(p.shape) == tuple(m.shape) == j.shape, name
        assert p.dtype == m.dtype == torch.float32, name
        assert m.device.type == "meta" and p.device.type == "cpu"
    carried = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    assert tree_flatten(params)[1] == tree_flatten(carried)[1]
    jlay = jarena.make_layout(jparams)
    lay = arena.make_layout(shapes)
    assert lay.row_offsets == tuple(jlay.row_offsets)
    assert lay.rows == jlay.rows and lay.shapes == tuple(jlay.shapes)
    # distributions: ones/zeros exactly where JAX has them, normal leaves
    # with JAX's 1/sqrt(fan_in) scale (per-layer fan_in, never n_layers)
    for name, (_, j), p in zip(names, jl, leaves):
        j = np.asarray(j)
        if np.all(j == 1.0) or np.all(j == 0.0):
            np.testing.assert_array_equal(p.numpy(), j, err_msg=name)
        else:
            fan_in = j.shape[-2] if "layers" in name else j.shape[0]
            if "tok_emb" in name:
                fan_in = cfg.d_model
            std = float(p.std())
            assert abs(std - fan_in ** -0.5) < 0.15 * fan_in ** -0.5, name


def test_full_width_qwen_arena_from_shapes():
    """qwen1.5-0.5b FULL on the meta device: 14 leaves, 464,118,784
    parameters and an arena of 3,625,984 rows, with nothing allocated."""
    from repro_torch.configs import get_config
    model = build_model(get_config("qwen1.5-0.5b"), device="cpu")
    shapes = model.param_shapes()
    leaves, _ = tree_flatten(shapes)
    assert len(leaves) == 14
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in leaves) == 464_118_784
    assert arena.make_layout(shapes).rows == 3_625_984
    assert tuple(shapes["layers"]["attn"]["wq"].shape) == (24, 1024, 1024)


def test_dummy_batch_feeds_the_loss():
    """``Model.dummy_batch`` (the JAX API's random LM batch): token ids
    below the unpadded vocab, unit weights, and a finite loss over
    (S - 1) tokens a sequence."""
    cfg = get_smoke_config("yi-6b")
    model = build_model(cfg, device="cpu")
    batch = model.dummy_batch(3, 16, torch.Generator().manual_seed(1))
    assert batch["tokens"].shape == (3, 16)
    assert batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].max()) < cfg.vocab_size
    assert torch.equal(batch["weights"], torch.ones(3))
    with torch.no_grad():
        loss, aux = model.loss(model.init(torch.Generator().manual_seed(0)),
                               batch)
    assert aux["count"].item() == 3 * 15 and torch.isfinite(loss)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_long_sequence_attention_runs_in_q_blocks_as_in_jax(arch,
                                                            monkeypatch):
    """Past the chunk threshold the plain attention core runs in exact
    q-blocks in both packages (dense blocks, and zamba2's shared block):
    logits, loss and every gradient leaf agree with JAX in f32 (1e-5;
    zamba2's decay leaves 5e-5, as in ``test_torch_hybrid_slice.py``),
    and the port never forms a score over the whole (S, S). Both
    packages' thresholds are lowered here (S = 64 over a threshold of
    32, q-blocks of 16) so that the SMOKE configs take the chunked
    path."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    S, chunk = 64, 16
    decay_leaves = ("['layers']['mamba']['a_log']",
                    "['layers']['mamba']['dt_bias']")
    for mod in (jlayers, layers):
        monkeypatch.setattr(mod, "_CHUNK_THRESHOLD", 32)
        monkeypatch.setattr(mod, "_Q_CHUNK", chunk)
    jchunked, jcalls = jlayers.chunked_gqa_attend, []

    def jax_chunked(q, k, v, mask_fn, softcap=None):
        jcalls.append(q.shape[1])
        return jchunked(q, k, v, mask_fn, softcap, chunk=chunk)

    attend, scores = layers.gqa_attend, []

    def port_attend(q, k, v, mask, softcap=None):
        scores.append((q.shape[1], k.shape[1], tuple(mask.shape)))
        return attend(q, k, v, mask, softcap)

    monkeypatch.setattr(jlayers, "chunked_gqa_attend", jax_chunked)
    monkeypatch.setattr(layers, "gqa_attend", port_attend)
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              attn_impl="xla")
    jparams, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    batch = TokenStream(cfg, seed=3).next_batch(2, S)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tol = TOL["float32"]

    jlogits, _ = jtf.forward(jparams, jcfg, jbatch["tokens"])
    with torch.no_grad():
        logits, _ = tf.forward(params, cfg, tbatch["tokens"])
    assert _rel_err(logits, jlogits) <= tol["logits"]
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jbatch), has_aux=True)(jparams)
    leaves, treedef = tree_flatten(params)
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, _ = tf.lm_loss(arena.tree_unflatten(treedef, leaves), cfg, tbatch)
    assert _rel_err(loss, jloss) <= tol["loss"]
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(grads) == len(jleaves)
    for g, (path, jg) in zip(grads, jleaves):
        name = jax.tree_util.keystr(path)
        limit = 5e-5 if name in decay_leaves else tol["grads"]
        assert _rel_err(g, jg) <= limit, (name, _rel_err(g, jg))
    assert jcalls and set(jcalls) == {S}
    assert scores and set(scores) == {(chunk, S, (chunk, S))}


# -- the remat knobs: block_remat="dots" and rc.remat="whole_loss" ------------
REMAT_ARCHS = ["qwen1.5-0.5b", "xlstm-125m"]


def _remat_grads(arch, block_remat="full", remat="none"):
    """The worker's f32 gradient on one batch of the SMOKE model, through
    ``ambdg.loss_with_remat`` (the loss every LM strategy takes)."""
    from repro_torch.configs import base
    from repro_torch.core.ambdg import loss_with_remat
    from repro_torch.core.anytime import accumulate_scan
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              block_remat=block_remat)
    model = build_model(cfg, device="cpu")
    rc = base.RunConfig(model=cfg, shape=base.TRAIN_4K, remat=remat)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    g, _, m = accumulate_scan(loss_with_remat(model, rc),
                              model.init(torch.Generator().manual_seed(0)),
                              batch, 1)
    return tree_flatten(g)[0], float(m["loss_sum"])


@pytest.mark.parametrize("knob", ["block_remat=dots", "remat=whole_loss",
                                  "remat=ablation_name"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_knobs_give_the_gradient_of_full(arch, knob):
    """``block_remat="dots"`` (JAX's checkpoint_dots) and
    ``rc.remat="whole_loss"`` (JAX's ``_loss_with_remat``; any other
    value leaves the loss as it is, as in JAX) recompute what "full"
    recomputes or less: the same loss and each gradient leaf within 1e-6
    of its largest element (ROADMAP C.9: the CPU's embedding gradient
    need not repeat bit for bit)."""
    name, value = knob.split("=")
    want, want_loss = _remat_grads(arch)
    got, loss = _remat_grads(arch, **{name: value})
    assert loss == want_loss
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def _bytes_held_for_backward(fn):
    """The bytes of every storage the forward ``fn()`` made that is still
    alive when it returns (what autograd and the checkpoints keep for
    the backward, and the output). ``saved_tensors_hooks`` cannot count
    them: a checkpointed region saves through the checkpoint's own hooks,
    and the "dots" policy keeps the products' outputs in its cache."""
    import gc
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    s = t.untyped_storage()
                    self.made.setdefault(s._cdata, (StorageWeakRef(s),
                                                    s.nbytes()))
            return out

    with Watch() as watch:
        out = fn()
    gc.collect()
    held = sum(n for ref, n in watch.made.values() if not ref.expired())
    del out
    return held


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_modes_order_the_bytes_held_for_backward(arch):
    """After the forward of the SMOKE model, "full" holds fewer bytes for
    the backward than "dots" (which keeps the matrix products' outputs
    too), and "dots" fewer than "none" (which keeps everything)."""
    held = {}
    for remat in ("full", "dots", "none"):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32", block_remat=remat)
        model = build_model(cfg, device="cpu")
        leaves, treedef = tree_flatten(model.init(
            torch.Generator().manual_seed(0)))
        params = arena.tree_unflatten(
            treedef, [x.requires_grad_(True) for x in leaves])
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        held[remat] = _bytes_held_for_backward(
            lambda: model.loss(params, batch)[0])
    assert held["full"] < held["dots"] < held["none"], held
