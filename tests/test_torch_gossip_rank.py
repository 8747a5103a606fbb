"""The per-rank gossip of the port (``gossip_impl="shard_map"``: one
worker a rank of a ``torch.distributed`` world, each stencil term a
point-to-point exchange), on 4 gloo CPU ranks spawned once for the
module.

Held, on the same inputs:
  * the per-rank rounds (``consensus.gossip_rounds_shard*``: plain,
    masked with worker 2 dead, int8 with error feedback; ring, torus
    and complete at n = 4, 3 rounds) against the port's dense fold and
    JAX's fold run op by op (``jax.disable_jit``), bit for bit, and
    their census under the "gossip" tag against
    ``launch.wire_model.gossip_round_bytes`` times the rounds, exactly;
  * decentralized amb-linreg SMOKE on a ring of 4, one worker a rank
    (``train``, "auto" resolving to the per-rank route), 4 steps with
    compression none, int8 and an elastic churn process, against the
    stacked dense run in one process: z, the residual, the params,
    ``loss`` and ``applied_count`` bit for bit; ``grad_norm`` and
    ``consensus_error`` sum whole messages in an all-reduce, so they
    are held to rtol 1e-6 (measured: equal here). The checkpoint the
    ranks join on rank 0 (``checkpoint.save_sharded``) is the dense
    run's, key for key, and JAX's ``restore`` reads it;
  * a restart from a checkpoint at step 2, bit for bit;
  * the train CLI's ``main`` in the ranks' world (``--strategy
    decentralized``), against the dense run of its run config;
  * the refusals: a world of another size than n_workers, a pod mesh
    around the strategy, the publication channel.
"""
import dataclasses
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import base as jbase
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import consensus as jcons
from repro.models.api import build_model as jax_build_model
from repro.train import checkpoint as jckpt
from repro_torch.configs import base, get_smoke_config
from repro_torch.core import consensus
from repro_torch.launch.wire_model import gossip_round_bytes

N, ROWS, ROUNDS, STEPS, SPW = 4, 2, 3, 4, 4
TOPOLOGIES = ("ring", "torus", "complete")
FOLDS = ("none", "masked", "int8")
ACTIVE = np.array([1.0, 1.0, 0.0, 1.0], np.float32)      # worker 2 dead
RUNS = {"none": {}, "int8": {"compression": "int8"},
        "churn": {"elastic": dict(process="churn", p_fail=0.3,
                                  p_recover=0.5, seed=3)}}
CLI = ["--arch", "amb-linreg", "--smoke", "--device", "cpu", "--strategy",
       "decentralized", "--steps", "4", "--n-workers", str(N),
       "--samples-per-worker", str(SPW), "--gossip-rounds", str(ROUNDS),
       "--gossip-compression", "int8"]


def _messages(topology, fold):
    rng = np.random.default_rng(TOPOLOGIES.index(topology) * 3
                                + FOLDS.index(fold))
    x = rng.standard_normal((N, ROWS, 128)).astype(np.float32)
    res = (1e-3 * rng.standard_normal((N, ROWS, 128))).astype(np.float32)
    return x, res


def _rc(cfgs, model_cfg, gossip_impl="auto", compression="none",
        elastic=None):
    extra = {} if elastic is None else {
        "elastic": cfgs.ElasticConfig(**elastic)}
    total = N * SPW
    return cfgs.RunConfig(
        model=model_cfg,
        shape=dataclasses.replace(cfgs.TRAIN_4K, seq_len=0,
                                  global_batch=total),
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(tau=1, n_microbatches=2, b_bar=float(total),
                               smoothness_L=1.0, proximal="l2_ball",
                               radius_C=12.0),
        strategy="decentralized",
        consensus=cfgs.ConsensusConfig(topology="ring", n_workers=N,
                                       rounds=ROUNDS, gossip_impl=gossip_impl,
                                       compression=compression), **extra)


def _loop(ckpt_dir, n_steps=STEPS, ckpt_every=STEPS):
    from repro_torch.train.loop import LoopConfig
    return LoopConfig(n_steps=n_steps, n_workers=N, samples_per_worker=SPW,
                      log_every=1, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)


def _ckpt_leaves(ckpt_dir):
    path = max(Path(ckpt_dir).glob("step_*"))
    with np.load(path / "state.npz") as f:
        return {k: f[k] for k in f.files}


def _rank_folds(rank, group):
    """Every fold case on this rank's worker: {(topology, fold): (the
    folded message, the residual or None, the "gossip" census)}."""
    from repro_torch.dist.collectives import wire_census
    out = {}
    for topology in TOPOLOGIES:
        for fold in FOLDS:
            x, res = (torch.from_numpy(a[rank:rank + 1])
                      for a in _messages(topology, fold))
            r_out = None
            with wire_census() as census:
                if fold == "none":
                    y = consensus.gossip_rounds_shard(x, group, topology, N,
                                                      ROUNDS)
                elif fold == "masked":
                    y = consensus.gossip_rounds_shard_masked(
                        x, group, topology, N, ROUNDS,
                        torch.from_numpy(ACTIVE))
                else:
                    y, r_out = consensus.gossip_rounds_shard_int8(
                        x, res, group, topology, N, ROUNDS)
            out[(topology, fold)] = (y.numpy(), None if r_out is None
                                     else r_out.numpy(),
                                     census.select(tag="gossip"))
    return out


def _refusals(world):
    """The messages of what the per-rank route refuses."""
    from repro_torch import api
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train
    errors = {}

    def catch(name, fn):
        try:
            fn()
            errors[name] = None
        except Exception as e:  # noqa: BLE001 - the message is the result
            errors[name] = f"{type(e).__name__}: {e}"

    cfg = get_smoke_config("amb-linreg")
    model = build_model(cfg, device="cpu")
    rc = _rc(base, cfg, gossip_impl="shard_map")
    catch("world", lambda: api.build(model, rc.replace(
        consensus=dataclasses.replace(rc.consensus, n_workers=2)),
        device="cpu"))
    pods = rc.replace(mesh=base.MeshConfig(n_pods=2, data=2, model=1))
    mesh = make_mesh(pods.mesh, "cpu")
    with mesh:
        catch("mesh", lambda: api.build(model, pods, device="cpu"))
    catch("publish", lambda: train(
        model, rc.replace(serve=dataclasses.replace(rc.serve,
                                                    publish_period=1)),
        _loop(None), device="cpu"))
    return errors


def _run_rank(rank, world, init_file, out_dir):
    import torch.distributed as dist

    from repro_torch.dist.collectives import wire_census
    from repro_torch.launch import train as train_cli
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        with open(f"{out_dir}/folds{rank}.pkl", "wb") as f:
            pickle.dump(_rank_folds(rank, dist.new_group(list(range(N)))),
                        f)
        results = {}
        cfg = get_smoke_config("amb-linreg")
        model = build_model(cfg, device="cpu")
        for label, knobs in RUNS.items():
            ck = f"{out_dir}/{label}"
            with wire_census() as census:
                out = train(model, _rc(base, cfg, **knobs), _loop(ck),
                            device="cpu")
            results[label] = {"history": out["history"],
                              "census": dict(census.bytes),
                              "state": _ckpt_leaves(ck) if rank == 0
                              else None}
        # a restart from a checkpoint written at step 2 of 4
        ck = f"{out_dir}/restart"
        rc = _rc(base, cfg, compression="int8")
        train(model, rc, _loop(ck, n_steps=2, ckpt_every=2), device="cpu")
        out = train(model, rc, _loop(ck), device="cpu")
        results["restart"] = {"history": out["history"],
                              "state": _ckpt_leaves(ck) if rank == 0
                              else None}
        # the CLI checkpoints every 50 steps: each rank writes its
        # worker's slice of the final state
        from repro_torch.train.checkpoint import _flatten_with_paths
        out = train_cli.main(CLI)
        results["cli"] = {"history": out["history"]}
        with open(f"{out_dir}/cli{rank}.pkl", "wb") as f:
            pickle.dump({k: v.numpy() for k, v in
                         _flatten_with_paths(out["state"])}, f)
        results["errors"] = _refusals(world)
        if rank == 0:
            with open(f"{out_dir}/results.pkl", "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("gossip_rank")
    mp.spawn(_run_rank, args=(N, str(tmp / "init"), str(tmp)), nprocs=N)
    with open(tmp / "results.pkl", "rb") as f:
        results = pickle.load(f)
    results["dir"] = tmp
    cli = []
    for r in range(N):
        with open(tmp / f"cli{r}.pkl", "rb") as f:
            cli.append(pickle.load(f))
    # the workers' slices joined along the worker axis, as the dense
    # state stacks them (t and step are whole on every rank)
    results["cli"]["state"] = {
        k: v if k in (".t", ".step") else
        np.concatenate([c[k] for c in cli]) for k, v in cli[0].items()}
    folds = []
    for r in range(N):
        with open(tmp / f"folds{r}.pkl", "rb") as f:
            folds.append(pickle.load(f))
    # each case: (the workers' messages stacked, their residuals or
    # None, each rank's census)
    results["folds"] = {
        case: (np.concatenate([fo[case][0] for fo in folds]),
               None if folds[0][case][1] is None else
               np.concatenate([fo[case][1] for fo in folds]),
               [fo[case][2] for fo in folds])
        for case in folds[0]}
    return results


def _dense_and_jax(topology, fold):
    """(the port's dense fold, JAX's op by op) of the case's messages:
    (values, residual or None) each."""
    x, res = _messages(topology, fold)
    xt = torch.from_numpy(x)
    with jax.disable_jit():
        if fold == "none":
            dense = (consensus.run_consensus_fold(xt, topology, ROUNDS), None)
            jx = (jcons.run_consensus_fold(jnp.asarray(x), topology, ROUNDS),
                  None)
        elif fold == "masked":
            dense = (consensus.run_consensus_fold_masked(
                xt, topology, ROUNDS, torch.from_numpy(ACTIVE)), None)
            jx = (jcons.run_consensus_fold_masked(
                jnp.asarray(x), topology, ROUNDS, jnp.asarray(ACTIVE)), None)
        else:
            dense = consensus.run_consensus_fold_int8(
                xt, torch.from_numpy(res), topology, ROUNDS)
            jx = jcons.run_consensus_fold_int8(
                jnp.asarray(x), jnp.asarray(res), topology, ROUNDS)
    as_np = lambda pair: tuple(None if a is None else np.asarray(a)
                               for a in pair)
    return as_np(dense), as_np(jx)


def _dense_run(knobs, ckpt_dir):
    """The stacked dense run of ``knobs`` in this process: (history, its
    checkpoint's leaves)."""
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train
    cfg = get_smoke_config("amb-linreg")
    out = train(build_model(cfg, device="cpu"),
                _rc(base, cfg, gossip_impl="dense", **knobs),
                _loop(str(ckpt_dir)), device="cpu")
    return out["history"], _ckpt_leaves(ckpt_dir)


CASES = [(t, f) for t in TOPOLOGIES for f in FOLDS]


@pytest.mark.parametrize("topology,fold", CASES,
                         ids=[f"{t}-{f}" for t, f in CASES])
def test_per_rank_fold_matches_dense_and_jax(ranks, topology, fold):
    got, got_res, _ = ranks["folds"][(topology, fold)]
    (dense, dense_res), (jx, jx_res) = _dense_and_jax(topology, fold)
    np.testing.assert_array_equal(got, dense)
    np.testing.assert_array_equal(got, jx)
    if fold == "int8":
        np.testing.assert_array_equal(got_res, dense_res)
        np.testing.assert_array_equal(got_res, jx_res)


@pytest.mark.parametrize("topology,fold", CASES,
                         ids=[f"{t}-{f}" for t, f in CASES])
def test_per_rank_fold_census_is_the_wire_model(ranks, topology, fold):
    """Every rank's "gossip" bytes: one round's model times the rounds,
    exactly (the masked fold exchanges what the plain one does)."""
    *_, census = ranks["folds"][(topology, fold)]
    one = gossip_round_bytes(topology, N, ROWS,
                             "int8" if fold == "int8" else "none")
    want = {dt: ROUNDS * b for dt, b in one.items()}
    assert census == [want] * N


@pytest.mark.parametrize("label", list(RUNS))
def test_per_rank_run_matches_dense(ranks, label, tmp_path):
    """z, the residual, the params (every leaf of the joined checkpoint),
    ``loss`` and ``applied_count`` bit for bit; the two whole-message
    metrics to the all-reduce's summation order."""
    hist_d, state_d = _dense_run(RUNS[label], tmp_path)
    got = ranks[label]
    assert len(got["history"]) == len(hist_d) == STEPS
    for a, b in zip(got["history"], hist_d):
        for key in ("loss", "applied_count", "local_count", "step"):
            assert a[key] == b[key], (key, a, b)
        for key in ("grad_norm", "consensus_error"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=0,
                                       err_msg=key)
    if label == "churn":
        alive = [h["active_workers"] for h in hist_d]
        assert min(alive) < N, alive       # the mask took a worker out
        assert [h["active_workers"] for h in got["history"]] == alive
    assert sorted(got["state"]) == sorted(state_d)
    for key, want in state_d.items():
        assert got["state"][key].shape == want.shape, key
        np.testing.assert_array_equal(got["state"][key], want, err_msg=key)


@pytest.mark.parametrize("label", list(RUNS))
def test_per_rank_run_census(ranks, label):
    """A run's census on rank 0: the gossip's bytes are the wire model's
    round times the rounds and steps; the workers' counts and loss sums
    cross in one f32 all-gather a step; the metrics' all-reduces run on
    the worker axis."""
    census = ranks[label]["census"]
    by_tag = {}
    for (axis, dtype, tag), n in census.items():
        assert axis == "worker", (axis, tag)
        by_tag.setdefault(tag, {})[dtype] = n
    rows = len(next(iter(ranks[label]["state"][".z"])))
    one = gossip_round_bytes("ring", N, rows,
                             RUNS[label].get("compression", "none"))
    assert by_tag["gossip"] == {dt: ROUNDS * STEPS * b
                                for dt, b in one.items()}
    assert by_tag["worker_counts"] == {"f32": STEPS * (N - 1) * 2 * 4}
    assert set(by_tag) == {"gossip", "worker_counts", "metrics"}


def test_per_rank_restart_resumes_exactly(ranks, tmp_path):
    """2 steps, a checkpoint joined on rank 0, a restart to step 4 (each
    rank's worker cut from the file): the stacked 4-step run's state
    and its last two steps' losses."""
    hist_d, state_d = _dense_run({"compression": "int8"}, tmp_path)
    got = ranks["restart"]
    assert sorted(got["state"]) == sorted(state_d)
    for key, want in state_d.items():
        np.testing.assert_array_equal(got["state"][key], want, err_msg=key)
    assert [h["loss"] for h in got["history"]] == \
        [h["loss"] for h in hist_d[2:]]


def test_per_rank_checkpoint_restores_in_jax(ranks):
    """JAX's ``restore`` reads the checkpoint the ranks joined into a
    JAX decentralized state of the same run, leaf for leaf."""
    jcfg = jax_smoke_config("amb-linreg")
    js = japi.build(jax_build_model(jcfg),
                    _rc(jbase, jcfg, gossip_impl="dense",
                        compression="int8"))
    template = js.init_state(jax.random.PRNGKey(0))
    ck = ranks["dir"] / "int8"
    restored, _ = jckpt.restore(str(ck), template)
    leaves = _ckpt_leaves(ck)
    flat, _ = jax.tree_util.tree_flatten_with_path(restored)
    assert len(flat) == len(leaves)
    for path, leaf in flat:
        key = jax.tree_util.keystr(path, simple=True, separator="/")
        want = next(v for k, v in leaves.items()
                    if k.lstrip(".").replace(".", "") == key)
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=key)


def test_train_cli_runs_one_worker_a_rank(ranks):
    """``launch.train.main`` with ``--strategy decentralized`` in a world
    of ``--n-workers`` ranks takes the per-rank route; its metrics and
    its checkpoint are the dense run's of its run config."""
    from repro_torch.launch.train import parse_args, run_config
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    rc = run_config(parse_args(CLI))
    assert rc.consensus.gossip_impl == "auto"
    rc = rc.replace(consensus=dataclasses.replace(rc.consensus,
                                                  gossip_impl="dense"))
    from repro_torch.train.checkpoint import _flatten_with_paths
    want = train(build_model(rc.model, device="cpu"), rc,
                 LoopConfig(n_steps=4, n_workers=N, samples_per_worker=SPW),
                 device="cpu")
    got = ranks["cli"]
    assert len(got["history"]) == len(want["history"]) == 1
    for key in ("step", "loss", "applied_count"):
        assert got["history"][-1][key] == want["history"][-1][key], key
    state_d = {k: v.numpy() for k, v in _flatten_with_paths(want["state"])}
    assert sorted(got["state"]) == sorted(state_d)
    for key, v in state_d.items():
        np.testing.assert_array_equal(got["state"][key], v, err_msg=key)


@pytest.mark.parametrize("what, exc, text", [
    ("world", "RuntimeError", "2 workers need a world of 2 ranks; the "
     "world has 4"),
    ("mesh", "NotImplementedError", "does not compose with a pod mesh"),
    ("publish", "NotImplementedError", "A.11 part 2, item 7"),
])
def test_per_rank_route_refuses(ranks, what, exc, text):
    msg = ranks["errors"][what]
    assert msg is not None and msg.startswith(exc) and text in msg, msg
