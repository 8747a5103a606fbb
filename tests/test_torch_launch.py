"""The port's launchers (``repro_torch.launch``) against the JAX
package's: ``parse_mesh``/``mesh_label`` on a grid of specs, the train
CLI's ``RunConfig`` for the same argument lists, and the serve CLI's
stats lines at SMOKE on the CPU. The port's CLIs run on the card unless
``--device cpu`` is given.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
import repro.launch.train as jtrain
from repro.launch import mesh as jmesh
from repro_torch.launch import mesh, serve, train

SPECS = ["16x16", "8x8", "1x8x8", "2x16x16", "2x8x8", "4x1x1", "1x1",
         "3X2", "1x1x1"]
BAD_SPECS = ["", "16", "axb", "2x2x2x2", "0x8", "2x-1x4", "8x8x"]


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS)
def test_parse_mesh_and_label_match_jax(spec):
    try:
        want = jmesh.parse_mesh(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.parse_mesh(spec)
        assert str(got.value) == str(e)
        return
    got = mesh.parse_mesh(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.shape == want.shape and got.axis_names == want.axis_names
    assert mesh.mesh_label(got) == jmesh.mesh_label(want)
    assert mesh.parse_mesh(mesh.mesh_label(got)) == got
    for multi in (False, True):
        assert dataclasses.asdict(mesh.mesh_config(multi)) == \
            dataclasses.asdict(jmesh.mesh_config(multi))


def test_only_a_one_device_mesh_is_made():
    """Without a process group only a one-device mesh is made: a larger
    one raises, naming the missing world, ``model > 1`` included; JAX's
    TPU pod mesh raises whatever the world (512 chips)."""
    one = mesh.make_mesh(mesh.parse_mesh("1x1"), device="cpu")
    assert one.shape == (1, 1) and one.devices == (torch.device("cpu"),)
    assert one.device_mesh is None
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_mesh(mesh.parse_mesh("2x1x1"), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_mesh(mesh.parse_mesh("1x2x2"), device="cpu")
    with pytest.raises(NotImplementedError, match="512 chips"):
        mesh.make_production_mesh(multi_pod=True)


ARGVS = [
    ["--arch", "qwen1.5-0.5b", "--smoke"],
    ["--arch", "qwen1.5-0.5b", "--seq-len", "1024", "--n-workers", "2",
     "--samples-per-worker", "1", "--steps", "3", "--optimizer", "adam"],
    ["--arch", "amb-linreg", "--smoke", "--strategy", "decentralized",
     "--topology", "torus", "--gossip-rounds", "3", "--gossip-compression",
     "int8", "--optimizer", "sgd", "--tau", "2", "--t-p", "1.5"],
    ["--arch", "zamba2-2.7b", "--smoke", "--delay-process", "heavy_tail",
     "--delay-min", "2", "--delay-seed", "7", "--fixed-alpha",
     "--batch-schedule", "delay_aware", "--batch-b0", "8", "--batch-cap",
     "64", "--elastic-process", "churn", "--churn-rate", "0.1",
     "--shape", "prefill_32k", "--batch", "64"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_train_cli_builds_jax_run_config(argv, monkeypatch):
    """The same flags give the same ``RunConfig`` (every field but the
    port's own ``model.scan_impl``) and loop. JAX's ``train`` is replaced
    by a stub for the call, which records its arguments."""
    seen = {}

    def stub(model, rc, loop, log_fn=None):
        seen.update(rc=rc, loop=loop)
        return {"history": [{"loss": 0.0}]}

    monkeypatch.setattr(jtrain, "train", stub)
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + argv)
    jtrain.main()
    rc = train.run_config(train.parse_args(argv))
    got, want = dataclasses.asdict(rc), dataclasses.asdict(seen["rc"])
    assert got["model"].pop("scan_impl") == "xla"
    assert got == want
    args = train.parse_args(argv)
    assert (args.steps, args.n_workers, args.samples_per_worker) == (
        seen["loop"].n_steps, seen["loop"].n_workers,
        seen["loop"].samples_per_worker)


def test_train_cli_runs_on_the_cpu_only_when_asked(capsys):
    out = train.main(["--arch", "amb-linreg", "--smoke", "--steps", "2",
                      "--optimizer", "sgd", "--n-workers", "2",
                      "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("done: 1 log points, final loss ")
    assert np.isfinite(out["history"][-1]["loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--arch", "amb-linreg", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen1.5-0.5b", "--smoke", "--publish-period", "4",
     "--n-steps", "24"],
    ["--arch", "zamba2-2.7b", "--smoke", "--slots", "3", "--arrival",
     "bursty", "--n-steps", "20", "--max-new", "6"],
])
def test_serve_cli_prints_jax_stats(argv, monkeypatch, capsys):
    """Every line the serve CLI prints equals JAX's: arrivals, admits,
    completions, token counts, the publisher's pops and staleness and the
    completed requests' lengths. None of them depends on the sampled
    tokens, which differ (the two packages draw their init weights from
    different generators): a request ends at ``max_new`` tokens or at
    ``max_len``, never at a sampled token."""
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve"] + argv)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    out = serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) >= 3
    if "--publish-period" in argv:
        s = out["engine"].stats
        assert s.publish_pops > 0 and s.staleness_max <= 4
