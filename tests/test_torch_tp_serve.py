"""Decoding and serving on a mesh with ``model > 1`` for every LM family
(``dist.tensor_parallel``'s decode layout, ``serve.engine`` on a mesh),
on gloo CPU ranks.

The ranks are spawned once per world size (2 and 4), both at once,
while the parent computes the references: JAX's unsharded
``decode_step`` on JAX's init (carried to the port with
``convert.params_from_jax``; each rank cuts its blocks from it) and the
port's ``1x1x1`` engines. SMOKE configs, f32 compute and an f32 cache
(ROADMAP C.13); the xLSTM's sLSTM ``w_h`` rescaled to fan-in head_dim
(C.16), its config with ``seq_parallel=True``, which the training
forward refuses at ``model > 1`` and the decode serves.

Each decode case runs 8 teacher-forced steps of 4 slots at the ragged
positions t, t + 3, t + 5, t + 1 through ``continuous_decode_step``:
  * the ranks' vocab blocks of the logits, joined (and their rows over
    ``data``), equal JAX's within 1e-5 of the largest element; the next
    tokens are the joined logits' first argmax;
  * the rank's fresh cache equals its block of JAX's init
    (``tensor_parallel.cut_cache``), and after the steps its block of
    JAX's cache within 1e-5 of the leaf's largest element;
  * the census equals ``wire_model.decode_axis_bytes`` times the steps.
World 2, ``1x1x2``: qwen1.5-0.5b, qwen3-1.7b (q/k norms), yi-6b,
mixtral-8x7b einsum and gather (a window of 8: the rolling cache wraps),
zamba2-2.7b, seamless-m4t (its memory filled by hand, as JAX's serve
path never fills it, C.17), paligemma-3b (the whole-kv route) and
xlstm-125m. World 4: chatglm3-6b on ``1x1x4`` (whole kv), qwen1.5-0.5b
and zamba2 on ``1x2x2`` (the slots over ``data``).

The engine: the golden serve trace (``tests/golden/serve_trace.json``,
with its publisher: the popped whole tree cut to the rank's blocks) is
exact on ``1x1x2``, on ``1x2x1`` and on ``2x1x1`` (pods replicate);
``api.serve`` on each family over 16 steps gives the ``1x1x1`` engine's
trace and tokens (``1x1x2``; qwen1.5 also on ``1x2x1``, with its slots
over ``data``; chatglm3 on ``1x1x4``, qwen1.5 and zamba2 on ``1x2x2``),
its census ``decode_axis_bytes`` times the decode steps. A tie across
vocab blocks goes to the lowest index. The train loop's publish at
``model > 1`` still raises (ROADMAP A.11 part 2, item 7).
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MeshConfig

B, MAX_LEN, STEPS = 4, 16, 8
TOL = 1e-5
# label -> (arch, mesh, config overrides)
CASES = {
    "qwen1.5-1x1x2": ("qwen1.5-0.5b", (1, 1, 2), {}),
    "qwen3-1x1x2": ("qwen3-1.7b", (1, 1, 2), {}),
    "yi-1x1x2": ("yi-6b", (1, 1, 2), {}),
    "mixtral-einsum-1x1x2": ("mixtral-8x7b", (1, 1, 2),
                             {"moe_impl": "einsum", "sliding_window": 8}),
    "mixtral-gather-1x1x2": ("mixtral-8x7b", (1, 1, 2),
                             {"moe_impl": "gather", "sliding_window": 8}),
    "zamba2-1x1x2": ("zamba2-2.7b", (1, 1, 2), {}),
    "seamless-1x1x2": ("seamless-m4t-large-v2", (1, 1, 2), {}),
    "paligemma-1x1x2": ("paligemma-3b", (1, 1, 2), {}),
    "xlstm-1x1x2": ("xlstm-125m", (1, 1, 2), {"seq_parallel": True}),
    "chatglm3-1x1x4": ("chatglm3-6b", (1, 1, 4), {}),
    "qwen1.5-1x2x2": ("qwen1.5-0.5b", (1, 2, 2), {}),
    "zamba2-1x2x2": ("zamba2-2.7b", (1, 2, 2), {}),
}
# the engine through api.serve: label -> (decode case whose config it
# serves, mesh)
SERVE = {
    "qwen1.5-1x1x2": ("qwen1.5-1x1x2", (1, 1, 2)),
    "qwen3-1x1x2": ("qwen3-1x1x2", (1, 1, 2)),
    "yi-1x1x2": ("yi-1x1x2", (1, 1, 2)),
    "mixtral-1x1x2": ("mixtral-gather-1x1x2", (1, 1, 2)),
    "zamba2-1x1x2": ("zamba2-1x1x2", (1, 1, 2)),
    "seamless-1x1x2": ("seamless-1x1x2", (1, 1, 2)),
    "paligemma-1x1x2": ("paligemma-1x1x2", (1, 1, 2)),
    "xlstm-1x1x2": ("xlstm-1x1x2", (1, 1, 2)),
    "qwen1.5-1x2x1": ("qwen1.5-1x1x2", (1, 2, 1)),
    "chatglm3-1x1x4": ("chatglm3-1x1x4", (1, 1, 4)),
    "qwen1.5-1x2x2": ("qwen1.5-1x2x2", (1, 2, 2)),
    "zamba2-1x2x2": ("zamba2-1x2x2", (1, 2, 2)),
}
SERVE_STEPS = 16
GOLDEN = ((1, 1, 2), (1, 2, 1), (2, 1, 1))
# a cross-block tie: the whole (4, 8) logits, two blocks of 4 columns
TIE = np.array([[0, 1, 5, 2, 0, 3, 5, 1],       # 2 and 6: the lowest
                [0, 1, 2, 3, 4, 5, 6, 1],       # 6 alone
                [0, 7, 1, 7, 0, 7, 0, 0],       # 1, 3 and 5
                [0, 0, 0, 0, 0, 0, 0, 9]],      # the last (pad) column
               np.float32)


def _world(shape):
    return int(np.prod(shape))


def _cfg(label):
    arch, _, kw = CASES[label]
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", **kw)


def _build(cfg):
    """The model of ``cfg`` on the CPU; the xLSTM's init rescales the
    sLSTM's ``w_h`` to fan-in head_dim (whole on every rank)."""
    from repro_torch.models.api import build_model
    model = build_model(cfg, device="cpu")
    if cfg.xlstm is None:
        return model
    return dataclasses.replace(model, init_fn=lambda dev, gen: _rescale(
        model.init_fn(dev, gen), cfg))


def _rescale(params, cfg):
    from repro_torch.models.xlstm import slstm_dims
    nh, hd, _ = slstm_dims(cfg)
    w = params["slstm_layers"]["slstm"]["w_h"]
    if w.device.type != "meta":
        with torch.no_grad():
            w.mul_((nh / hd) ** 0.5)
    return params


def _tensors(tree_np):
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(tree_np)
    return tree_unflatten(treedef, [torch.from_numpy(np.array(x))
                                    for x in leaves])


def _serve_rc(cfg, shape):
    from repro_torch.configs.base import RunConfig, ServeConfig, TRAIN_4K
    return RunConfig(model=cfg, shape=TRAIN_4K, mesh=MeshConfig(*shape),
                     serve=ServeConfig(slots=B, max_len=32, max_new=4,
                                       arrival_rate=0.9, prompt_len_min=2,
                                       prompt_len_max=6, seed=7))


def _catch(fn):
    """None, or the message of what ``fn()`` raised."""
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}"


# ---------------------------------------------------------------------------
# Both sides
# ---------------------------------------------------------------------------
def _serve(cfg, rc, n_steps=SERVE_STEPS):
    """``api.serve`` under the active mesh (or none) with an f32 cache:
    (the trace, every slot's tokens, the completions, the decode
    steps)."""
    from repro_torch import api
    m = _build(cfg)
    engine, queue = api.serve(m, rc, device="cpu")
    engine.cache, _ = m.init_decode_state(B, rc.serve.max_len, torch.float32)
    engine._cache0, _ = m.init_decode_state(B, rc.serve.max_len,
                                            torch.float32)
    trace = engine.serve(queue, n_steps)
    return {"trace": trace, "outs": [list(o) for o in engine._out],
            "completions": list(engine.completions),
            "decode_steps": sum(ev["active"] > 0 for ev in trace)}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
def _decode_case(label, inp):
    """This rank's fresh cache, each step's logits block and next tokens,
    its cache after the steps and the census."""
    from repro_torch.core.arena import make_layout, tree_flatten
    from repro_torch.dist.collectives import require_mesh, wire_census
    from repro_torch.dist.context import active_mesh
    from repro_torch.dist.tensor_parallel import (cache_dims, cut_cache,
                                                  cut_params, model_axis,
                                                  model_dims, slot_rows)
    from repro_torch.serve.engine import continuous_decode_step
    cfg = _cfg(label)
    m = _build(cfg)
    mesh = active_mesh()
    layout = make_layout(m.whole_param_shapes())
    params = cut_params(_tensors(inp["params"]), model_dims(
        cfg, layout, m.param_axes(), mesh), model_axis())
    fresh, caxes = m.init_decode_state(B, MAX_LEN, torch.float32)
    coords = require_mesh("the decode case").coords
    cache = cut_cache(cfg, _tensors(inp["cache0"]),
                      cache_dims(cfg, caxes, B, mesh), mesh, coords)
    rows = slot_rows(B)
    logits = []

    def decode(p, c, t, pos):
        out = m.decode_step(p, c, t, pos)
        logits.append(out[0][:, -1].numpy().copy())
        return out

    nxt = []
    with torch.no_grad(), wire_census() as census:
        for t in range(STEPS):
            n, cache = continuous_decode_step(
                decode, params, cache,
                torch.from_numpy(rows.of(inp["tokens"][t])),
                torch.from_numpy(rows.of(inp["pos"][t])),
                torch.ones((rows.size,), dtype=torch.bool), rows)
            nxt.append(n.numpy().copy())
    return {"fresh": [x.numpy() for x in tree_flatten(fresh)[0]],
            "logits": np.stack(logits), "next": np.stack(nxt),
            "cache": [x.numpy() for x in tree_flatten(cache)[0]],
            "coords": coords, "census": dict(census.bytes)}


def _golden(shape):
    """``test_torch_cuda.serve_golden_trace`` on ``shape``: the
    publisher holds the whole tree (published from the 1x1x1 init) and
    the engine keeps its blocks of each pop."""
    from test_torch_cuda import _serve_model
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.arena import make_layout
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import Engine, RequestQueue, WeightPublisher
    model = _serve_model("qwen1.5-0.5b", "cpu")
    whole = model.init(torch.Generator().manual_seed(0))
    sc = ServeConfig(slots=3, max_len=32, max_new=4, arrival="poisson",
                     arrival_rate=0.7, publish_period=3, staleness_bound=6,
                     prompt_len_min=2, prompt_len_max=6, seed=5)
    with make_mesh(MeshConfig(*shape), "cpu"):
        engine = Engine(model, sc.slots, sc.max_len)
    queue = RequestQueue(sc, model.cfg.vocab_size)
    pub = WeightPublisher(make_layout(whole), sc, device="cpu")
    engine.attach_publisher(pub)
    rows = []
    for t in range(40):
        slot = pub.publish(whole, t) if t % sc.publish_period == 0 else -1
        stale = engine.refresh_weights(t) if t % 5 == 0 else None
        arrived = queue.step()
        ev = engine.step(queue)
        rows.append({"step": t, "arrived": arrived, "admits": ev["admits"],
                     "evicts": ev["evicts"], "active": ev["active"],
                     "queued": ev["queued"], "publish_slot": slot,
                     "staleness": stale})
    return rows, (engine.stats.completed, engine.stats.admitted), sc


def _ties():
    """The tie logits' argmax on 1x1x2 (each rank its block) and the
    census of the exchange."""
    from repro_torch.dist.collectives import wire_census
    from repro_torch.dist.tensor_parallel import model_axis, vocab_argmax
    from repro_torch.launch.mesh import make_mesh
    with make_mesh(MeshConfig(1, 1, 2), "cpu"):
        ax = model_axis()
        block = torch.from_numpy(TIE).chunk(2, dim=-1)[ax.rank].contiguous()
        with wire_census() as census:
            got = vocab_argmax(block, ax)
    return got.tolist(), dict(census.bytes)


def _publish_refusal():
    """``train`` with ``rc.serve.publish_period > 0`` on 1x1x2."""
    from repro_torch.configs.base import (AmbdgConfig, RunConfig,
                                          ServeConfig, TRAIN_4K)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import LoopConfig, train
    cfg = _cfg("qwen1.5-1x1x2")
    rc = RunConfig(model=cfg, shape=dataclasses.replace(
        TRAIN_4K, seq_len=8, global_batch=2), mesh=MeshConfig(1, 1, 2),
        ambdg=AmbdgConfig(tau=1, n_microbatches=1, b_bar=2.0),
        serve=ServeConfig(publish_period=1))
    return _catch(lambda: train(
        _build(cfg), rc, LoopConfig(n_steps=1, n_workers=1,
                                    samples_per_worker=2),
        device="cpu", mesh=make_mesh(rc.mesh, "cpu")))


def _run_rank(rank, world, tmp):
    import torch.distributed as dist

    from repro_torch.dist.collectives import wire_census
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=world)
    with open(f"{tmp}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    res = {"decode": {}, "serve": {}, "golden": {}}
    try:
        for label, (_, shape, _) in CASES.items():
            if _world(shape) == world:
                with make_mesh(MeshConfig(*shape), "cpu"):
                    res["decode"][label] = _decode_case(label,
                                                        inputs[label])
        for label, (case, shape) in SERVE.items():
            if _world(shape) == world:
                with make_mesh(MeshConfig(*shape), "cpu"):
                    with wire_census() as census:
                        res["serve"][label] = _serve(
                            _cfg(case), _serve_rc(_cfg(case), shape))
                res["serve"][label]["census"] = dict(census.bytes)
        if world == 2:
            for shape in GOLDEN:
                res["golden"][shape] = _golden(shape)
            res["ties"] = _ties()
            res["publish"] = _publish_refusal()
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The references and the spawns
# ---------------------------------------------------------------------------
def _jax_models(label):
    """(JAX's config and decode module, its init as numpy with the
    xLSTM's ``w_h`` rescaled)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import encdec as jed
    from repro.models import transformer as jtf
    arch, _, kw = CASES[label]
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               compute_dtype="float32", **kw)
    jm = jed if jcfg.family == "encdec" else jtf
    params, _ = jm.init(jax.random.PRNGKey(0), jcfg)
    params = jax.tree.map(np.asarray, jax.device_get(params))
    if jcfg.family == "ssm":
        from repro_torch.models.xlstm import slstm_dims
        nh, hd, _ = slstm_dims(_cfg(label))
        w = params["slstm_layers"]["slstm"]
        w["w_h"] = (w["w_h"] * np.float32((nh / hd) ** 0.5)).astype(
            np.float32)
    return jcfg, jm, params


def _inputs():
    """Per decode case: JAX's init, the tokens and positions of every
    step, JAX's fresh cache (seamless's memory K/V filled with seeded
    draws)."""
    import jax
    import jax.numpy as jnp
    out = {}
    for i, label in enumerate(CASES):
        jcfg, jm, params = _jax_models(label)
        rng = np.random.default_rng(100 + i)
        cache, _ = jm.init_decode_state(jcfg, B, MAX_LEN, jnp.float32)
        cache = jax.tree.map(np.asarray, jax.device_get(cache))
        if "mem_k" in cache:
            for k in ("mem_k", "mem_v"):
                cache[k] = rng.standard_normal(cache[k].shape).astype(
                    np.float32)
        out[label] = {
            "params": params, "cache0": cache,
            "tokens": rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)
                                   ).astype(np.int32),
            "pos": np.array([[t, t + 3, t + 5, t + 1] for t in range(STEPS)],
                            np.int32)}
    return out


def _jax_decode(label, inp):
    """JAX's unsharded ``decode_step`` over the steps: (the logits (steps,
    B, V), the cache after them as numpy leaves in sorted-key order)."""
    import jax
    import jax.numpy as jnp
    jcfg, jm, _ = _jax_models(label)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, jcfg, c, t, pos))
    params = jax.tree.map(jnp.asarray, inp["params"])
    cache = jax.tree.map(jnp.asarray, inp["cache0"])
    logits = []
    for t in range(STEPS):
        out, cache = step(params, cache, jnp.asarray(inp["tokens"][t]),
                          jnp.asarray(inp["pos"][t]))
        logits.append(np.asarray(out[:, -1]))
    from repro_torch.core.arena import tree_flatten
    return np.stack(logits), tree_flatten(jax.tree.map(np.asarray, cache))[0]


def _start(world, tmp, inputs):
    import torch.multiprocessing as mp
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return mp.spawn(_run_rank, args=(world, str(tmp)), nprocs=world,
                    join=False)


def _results(ctx, world, tmp):
    while not ctx.join():
        pass
    runs = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The references (parent, while the ranks run) and every rank's
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inputs = _inputs()
        tmp2 = tmp_path_factory.mktemp("world2")
        tmp4 = tmp_path_factory.mktemp("world4")
        spawns = [(_start(2, tmp2, inputs), 2, tmp2),
                  (_start(4, tmp4, inputs), 4, tmp4)]
        out = {"inputs": inputs, "jax": {}, "stacked": {}}
        try:
            for label in CASES:
                out["jax"][label] = _jax_decode(label, inputs[label])
            for label, (case, _) in SERVE.items():
                out["stacked"][label] = _serve(
                    _cfg(case), _serve_rc(_cfg(case), (1, 1, 1)))
        finally:
            for ctx, world, tmp in spawns:
                out[f"w{world}"] = _results(ctx, world, tmp)
        return out
    finally:
        torch.set_num_threads(threads)


def _ranks(ref, shape):
    return ref[f"w{_world(shape)}"]


def _cut_jax(label, leaves, coords):
    """The block of JAX's cache leaves (sorted-key order) the rank at
    ``coords`` holds."""
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.dist.tensor_parallel import cache_dims, cut_cache
    from repro_torch.models.api import build_model
    cfg = _cfg(label)
    mesh = MeshConfig(*CASES[label][1])
    _, caxes = build_model(cfg, device="cpu").init_decode_state(
        B, MAX_LEN, torch.float32)
    treedef = tree_flatten(caxes)[1]
    whole = tree_unflatten(treedef, [torch.from_numpy(np.array(x))
                                     for x in leaves])
    cut = cut_cache(cfg, whole, cache_dims(cfg, caxes, B, mesh), mesh,
                    coords)
    return [x.numpy() for x in tree_flatten(cut)[0]]


def _joined(label, ranks):
    """Each step's whole logits (steps, B, V) from the ranks' blocks:
    the vocab blocks of each data coordinate's model ranks in order, the
    data coordinates' rows in order."""
    shape = CASES[label][1]
    by = {(r["decode"][label]["coords"]["data"],
           r["decode"][label]["coords"]["model"]): r["decode"][label]
          for r in ranks if r["decode"][label]["coords"]["pod"] == 0}
    rows = [np.concatenate([by[(d, m)]["logits"] for m in range(shape[2])],
                           axis=-1) for d in range(shape[1])]
    return np.concatenate(rows, axis=1) if B % shape[1] == 0 else rows[0]


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label", list(CASES))
def test_decode_logits_equal_jax_unsharded(ref, label):
    """The joined logits of 8 teacher-forced ragged steps equal JAX's
    unsharded ``decode_step`` within 1e-5 of the largest element; every
    rank's next tokens are the joined logits' first argmax."""
    want, _ = ref["jax"][label]
    got = _joined(label, _ranks(ref, CASES[label][1]))
    assert got.shape == want.shape, (got.shape, want.shape)
    gap = float(np.abs(got - want).max())
    assert gap <= TOL * float(np.abs(want).max()), (label, gap)
    for r in _ranks(ref, CASES[label][1]):
        np.testing.assert_array_equal(r["decode"][label]["next"],
                                      np.argmax(got, axis=-1))


@pytest.mark.parametrize("label", list(CASES))
def test_decode_cache_blocks_equal_jax(ref, label):
    """Each rank's fresh cache is its block of JAX's init exactly (the
    serve profile's layout: its rows of the slots, its heads) and its
    cache after the steps its block of JAX's within 1e-5 of the leaf's
    largest element."""
    from repro_torch.core.arena import tree_flatten
    inp = ref["inputs"][label]
    zero = dict(inp["cache0"])
    for k in ("mem_k", "mem_v"):
        if k in zero:
            zero[k] = np.zeros_like(zero[k])
    _, final = ref["jax"][label]
    for r in _ranks(ref, CASES[label][1]):
        got = r["decode"][label]
        fresh = _cut_jax(label, tree_flatten(zero)[0], got["coords"])
        assert len(got["fresh"]) == len(fresh)
        for a, b in zip(got["fresh"], fresh):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        want = _cut_jax(label, final, got["coords"])
        for i, (a, b) in enumerate(zip(got["cache"], want)):
            assert a.shape == b.shape, (label, i, a.shape, b.shape)
            gap = float(np.abs(a - b).max())
            assert gap <= TOL * (float(np.abs(b).max()) or 1.0), \
                (label, i, gap)


@pytest.mark.parametrize("label", list(CASES))
def test_decode_census_equals_the_wire_model(ref, label):
    """The bytes of each rank's steps, by (tag, dtype) over ``model`` and
    ``data``, equal ``decode_axis_bytes`` times the steps."""
    from repro_torch.launch.wire_model import decode_axis_bytes
    _, shape, _ = CASES[label]
    one = decode_axis_bytes(_cfg(label), B, shape[2], shape[1])
    want = {k: STEPS * v for k, v in one.items()}
    assert ("tp_logits", "f64") in want and ("tp_act", "f32") in want
    for r in _ranks(ref, shape):
        got = {(tag, dt): n for (_, dt, tag), n in
               r["decode"][label]["census"].items()}
        assert got == want, (label, got, want)


@pytest.mark.parametrize("label", list(SERVE))
def test_api_serve_gives_the_stacked_engines_tokens(ref, label):
    """``api.serve`` on the mesh, 16 steps of the seeded Poisson queue:
    every rank's trace, slot tokens and completions equal the 1x1x1
    engine's; the census is ``decode_axis_bytes`` times the decode
    steps."""
    from repro_torch.launch.wire_model import decode_axis_bytes
    case, shape = SERVE[label]
    want = ref["stacked"][label]
    assert want["completions"], label
    one = decode_axis_bytes(_cfg(case), B, shape[2], shape[1])
    census = {k: want["decode_steps"] * v for k, v in one.items()}
    for r in _ranks(ref, shape):
        got = r["serve"][label]
        for key in ("trace", "outs", "completions", "decode_steps"):
            assert got[key] == want[key], (label, key)
        assert {(tag, dt): n for (_, dt, tag), n in
                got["census"].items()} == census, label


@pytest.mark.parametrize("shape", GOLDEN, ids=["1x1x2", "1x2x1", "2x1x1"])
def test_golden_serve_trace_on_the_mesh(ref, shape):
    """The golden serve trace, exact on every rank (the publisher's pops
    cut to the rank's blocks on 1x1x2; 3 slots on 1x2x1, which ``data``
    does not split, replicated as JAX's resolver falls back; pods
    replicate)."""
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "serve_trace.json")
    with open(path) as f:
        want = json.load(f)
    for r in ref["w2"]:
        rows, counts, sc = r["golden"][shape]
        served = [x["staleness"] for x in rows if x["staleness"] is not None]
        assert served and all(0 <= s <= sc.staleness_bound for s in served)
        assert rows == want["trace"]
        assert counts == (want["completed"], want["admitted"])


def test_vocab_argmax_ties_go_to_the_lowest_index(ref):
    """Each rank's block's max and first index, exchanged: ties across
    blocks and inside one go to the lowest global index, as
    ``jnp.argmax`` (and ``torch.argmax`` on the whole) take them; the
    exchange is one f64 (value, index) pair a row."""
    want = torch.argmax(torch.from_numpy(TIE), dim=-1).tolist()
    assert want == [2, 6, 1, 7]
    for r in ref["w2"]:
        got, census = r["ties"]
        assert got == want
        assert census == {("model", "f64", "tp_logits"): 4 * 16}


def test_train_publish_on_the_model_axis_still_refuses(ref):
    """The train loop's weight publication at ``model > 1`` is the
    sharded publish ring (ROADMAP A.11 part 2, item 7)."""
    for r in ref["w2"]:
        msg = r["publish"]
        assert msg is not None and msg.startswith("NotImplementedError") \
            and "A.11 part 2, item 7" in msg, msg


@pytest.mark.parametrize("label", ["qwen1.5-1x2x2", "zamba2-1x2x2"])
def test_slots_split_over_data(ref, label):
    """On 1x2x2 each data rank holds 2 of the 4 slots (its block of the
    cache's batch dim) and every rank's next tokens cover all 4."""
    for r in _ranks(ref, CASES[label][1]):
        got = r["decode"][label]
        assert got["logits"].shape[1] == B // 2
        assert got["next"].shape == (STEPS, B)
        assert all(x.shape[1] == B // 2 for x in got["cache"])
