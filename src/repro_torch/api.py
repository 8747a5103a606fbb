"""``repro_torch.api``: the front end of the port.

    import repro_torch.api as api
    from repro_torch.models.api import build_model

    model    = build_model(cfg, device="cuda")
    strategy = api.build(model, rc, device="cuda")   # rc.strategy picks it
    state    = strategy.init_state()
    state, metrics = strategy.train_step(state, batch)

Registered strategies (``api.available_strategies()``):

    "ambdg"   the paper: anytime minibatch + delayed gradients
    "amb"     synchronous baseline (tau = 0, idle round trips)
    "kbatch"  fixed-minibatch K-batch baseline (Dutta et al.)
    "decentralized"  the paper's Sec. V: no master, each worker's dual
              through r gossip rounds (``rc.consensus``; the dense fold,
              int8 gossip, the masked fold under an elastic process)

``api.simulate(name_or_strategy, problem, ...)`` runs the cluster
simulator (``repro_torch.sim``) through the same registry:

    problem = SimProblem(cfg, n_workers=10, seed=0, device="cuda")
    trace   = api.simulate("ambdg", problem, t_p=2.5, t_c=10.0,
                           total_time=250.0, timing=ShiftedExponential(),
                           opt_cfg=rc.ambdg)

``api.serve(model, rc, publisher=None)`` builds the continuous-
batching engine and the seeded request queue of ``rc.serve``
(``repro_torch.serve``), on a mesh too (every rank of the world):

    engine, queue = api.serve(model, rc, publisher=out["publisher"])
    trace         = engine.serve(queue, n_steps)

    with make_mesh(parse_mesh("1x2x2"), "cuda"):   # in each rank
        engine, queue = api.serve(model, rc)
    trace = engine.serve(queue, n_steps)

``device`` defaults to "cuda" and raises when CUDA is absent; only a
caller that asks for the CPU runs there.
"""
from __future__ import annotations

from repro_torch.configs.base import RunConfig
from repro_torch.core.strategy import (  # noqa: F401  (re-exports)
    StalenessSchedule, Strategy, TimelineModel, available_strategies,
    get_strategy, register)
from repro_torch.device import resolve_device
from repro_torch.models.api import Model


def build(model: Model, rc: RunConfig, device="cuda") -> Strategy:
    """Construct the strategy named by ``rc.strategy`` on ``device``
    (the device ``model`` was built for)."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, the strategy "
                         f"was asked for {device}")
    return get_strategy(rc.strategy)(model, rc)


def serve(model: Model, rc: RunConfig, publisher=None, device="cuda"):
    """The continuous-batching engine and the seeded request queue of
    ``rc.serve``, on ``device`` (the device ``model`` was built for).
    Returns (engine, queue); pass the train loop's ``WeightPublisher``
    to attach the bounded-staleness weight channel
    (``engine.refresh_weights(now)`` pops the freshest due snapshot).

    Under an active mesh (the ``launch.mesh.make_mesh`` the caller made
    and entered, every rank of its world calling ``serve`` alike) the
    engine serves on the serve profile's layout: the slots over
    ``data`` where it divides them, the weights' and the cache's heads
    over ``model``, pods replicated (``serve.engine``)."""
    from repro_torch.serve import Engine, RequestQueue
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, the engine "
                         f"was asked for {device}")
    engine = Engine(model, rc.serve.slots, rc.serve.max_len, seed=rc.seed)
    queue = RequestQueue(rc.serve, model.cfg.vocab_size)
    if publisher is not None:
        engine.attach_publisher(publisher)
    return engine, queue


def simulate(strategy, problem, **kw):
    """Run the cluster simulator for one registered strategy; keyword
    arguments go to the engine the strategy class declares
    (``Strategy.sim_engine``): ``simulate_anytime`` for the epoch
    timeline, ``simulate_kbatch`` for the event-driven arrival heap.
    Returns the engine's ``Trace``; the gradients run on
    ``problem.device``.

    ``strategy`` is a registered name or a built ``Strategy``: a built
    one brings its seeded ``rc.delay`` process, ``rc.elastic`` worker
    process and ``rc.batch_schedule`` controller into the engine where
    its config has one (and, for k-batch, ``t_p``, the epoch clock both
    processes need). An explicit keyword argument wins."""
    from repro_torch.sim import simulate_anytime, simulate_kbatch
    if isinstance(strategy, Strategy):
        cls, name = type(strategy), type(strategy).name
        dp = strategy.delay_process()
        if dp is not None and "delay_process" not in kw:
            kw["delay_process"] = dp
            if cls.sim_engine == "kbatch":
                kw.setdefault("t_p", strategy.rc.ambdg.t_p)
        wp = strategy.worker_process(problem.n_workers)
        if wp is not None and "worker_process" not in kw:
            kw["worker_process"] = wp
            if cls.sim_engine == "kbatch":
                kw.setdefault("t_p", strategy.rc.ambdg.t_p)
        bs = strategy.batch_schedule()
        if bs is not None and "batch_schedule" not in kw:
            kw["batch_schedule"] = bs
    else:
        cls, name = get_strategy(strategy), strategy
    if cls.sim_engine == "kbatch":
        return simulate_kbatch(problem, **kw)
    if cls.sim_engine == "anytime":
        return simulate_anytime(problem, scheme=name, **kw)
    raise NotImplementedError(
        f"strategy {name!r} declares no simulator engine "
        f"(Strategy.sim_engine); run it on the device via "
        f"repro_torch.api.build and repro_torch.train.loop.train")


__all__ = ["Strategy", "StalenessSchedule", "TimelineModel",
           "available_strategies", "build", "get_strategy", "register",
           "serve", "simulate"]
