"""The Strategy protocol of the port (``repro/core/strategy.py``): one
surface for every algorithm variant, registered by name and built
through ``repro_torch.api.build(model, rc, device)`` from
``rc.strategy``:

    strategy = repro_torch.api.build(model, rc, device="cuda")
    state    = strategy.init_state(generator)
    state, metrics = strategy.train_step(state, batch)
    strategy.staleness_schedule()   # how stale applied gradients are
    Strategy.timeline_model()       # wall-clock algebra of the simulator

The port registers AMB-DG, its synchronous degenerate AMB, the K-batch
baseline and the decentralized gossip of the paper's Sec. V (the dense
fold in one process, or one worker a rank of a ``torch.distributed``
world).
``repro_torch.api.simulate`` runs a strategy's cluster simulator engine
(``Strategy.sim_engine``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Type

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import ambdg, anytime, consensus
from repro_torch.core import arena as arena_mod
from repro_torch.core import dual_averaging as da
from repro_torch.models.api import Model


class StalenessSchedule(NamedTuple):
    """How stale the gradients applied by each master update are."""
    kind: str          # "delayed" | "sync" | "random" | "gossip"
    tau: int           # deterministic delay in epochs (0 = fresh)
    description: str


class TimelineModel(NamedTuple):
    """Wall-clock algebra of a scheme (paper Sec. III / Fig. 1), used by
    the cluster simulator. The closed forms are the EXACT float
    expressions the golden traces pin: keep them literally as the JAX
    package writes them.

    ``event_driven`` schemes (k-batch) have no closed form: their update
    times come out of the simulator's arrival heap."""
    scheme: str
    event_driven: bool
    # (t_p, t_c) -> wall time of one epoch
    epoch_duration: Optional[Callable[[float, float], float]] = None
    # (t, t_p, t_c) -> wall time of the master's t-th update
    update_time: Optional[Callable[[int, float, float], float]] = None
    # (total_time, t_p, t_c) -> number of updates fitting the budget
    n_updates: Optional[Callable[[float, float, float], int]] = None


class Strategy:
    """Base class: subclasses assign ``init_state`` / ``train_step`` in
    ``__init__`` and implement the two schedule probes."""

    name: str = "?"
    # the simulator engine that runs this scheme: "anytime" (epoch
    # timeline), "kbatch" (event-driven arrival heap) or None (on the
    # device only)
    sim_engine: Optional[str] = None
    # does the device step read the elastic active mask as
    # batch["active"]? The master-ful strategies do not (a dead worker's
    # samples carry weight 0 in the anytime weights and eq. (5) stays
    # exact); the decentralized gossip does under an elastic process
    # (its stencil renormalizes around dead neighbours). The host loop
    # ships the mask exactly when this is True.
    consumes_active_mask: bool = False

    def __init__(self, model: Model, rc: RunConfig):
        from repro_torch.core.batch_schedule import resolve_targets
        from repro_torch.core.worker_process import validate_elastic
        # every strategy reads rc.elastic and rc.batch_schedule: a bad
        # config raises at build time, not at the first draw
        validate_elastic(rc.elastic)
        resolve_targets(rc.batch_schedule, rc.ambdg.b_bar)
        self.model = model
        self.rc = rc

    def staleness_schedule(self) -> StalenessSchedule:
        raise NotImplementedError

    @classmethod
    def timeline_model(cls) -> TimelineModel:
        raise NotImplementedError

    def delay_process(self):
        """The seeded ``core.delay_process`` instance this strategy's
        ``rc.delay`` configures, or None under the fixed process. The
        host loop draws each step's ``batch["delay"]`` from it, and
        ``api.simulate`` feeds it to the simulator engine."""
        if self.rc.delay.process == "fixed":
            return None
        from repro_torch.core.delay_process import make_delay_process
        return make_delay_process(self.rc.delay, self.rc.ambdg.tau)

    def worker_process(self, n_workers: int):
        """The seeded ``core.worker_process`` instance this strategy's
        ``rc.elastic`` configures for ``n_workers`` workers, or None
        under the static process. The host loop folds one draw per step
        into the anytime weights; ``api.simulate`` feeds it to the
        engine (per-epoch draws for the anytime schemes, epoch-indexed
        churn on the K-batch arrival heap)."""
        if self.rc.elastic.process == "static":
            return None
        from repro_torch.core.worker_process import make_worker_process
        return make_worker_process(self.rc.elastic, n_workers)

    def batch_schedule(self):
        """The seeded ``core.batch_schedule`` controller this strategy's
        ``rc.batch_schedule`` configures, or None under the fixed
        schedule. The host loop draws one target per step (shipped as
        ``batch["b_sched"]``); ``api.simulate`` feeds the same sequence
        to the engine (per-epoch targets, per-job sizes for K-batch)."""
        if self.rc.batch_schedule.schedule == "fixed":
            return None
        from repro_torch.core.batch_schedule import make_batch_schedule
        return make_batch_schedule(self.rc.batch_schedule,
                                   self.rc.ambdg.b_bar, self.rc.ambdg.tau)


_REGISTRY: Dict[str, Type[Strategy]] = {}


def register(cls: Type[Strategy]) -> Type[Strategy]:
    """Class decorator: make ``cls`` constructible by name."""
    if cls.name in _REGISTRY:
        raise ValueError(f"strategy {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    return cls


def get_strategy(name: str) -> Type[Strategy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _require_fixed_delay(rc: RunConfig, name: str, why: str):
    """Strategies without a master delay ring refuse a stochastic
    ``rc.delay`` (a knob ignored in silence is worse than an error)."""
    if rc.delay.process != "fixed":
        raise ValueError(
            f"strategy {name!r} does not support the stochastic delay "
            f"process {rc.delay.process!r}: {why}")


@register
class AmbdgStrategy(Strategy):
    """Anytime minibatch with delayed gradients: anytime accumulation
    -> tau-deep delay ring -> dual averaging, on the arena master (or
    the pytree reference). A stochastic ``rc.delay`` runs the
    delay-tolerant ring."""

    name = "ambdg"
    sim_engine = "anytime"

    def __init__(self, model: Model, rc: RunConfig):
        super().__init__(model, rc)
        self.init_state, self.train_step = ambdg.build_step_fns(model, rc)

    def staleness_schedule(self) -> StalenessSchedule:
        from repro_torch.core.delay_process import resolve_bounds
        dc = self.rc.delay
        if dc.process != "fixed":
            lo, hi = resolve_bounds(dc, self.rc.ambdg.tau)
            adaptive = ("delay-adaptive alpha" if dc.adaptive_alpha
                        else "worst-case alpha")
            return StalenessSchedule(
                "random", hi,
                f"stochastic tau_t in [{lo}, {hi}] from the seeded "
                f"{dc.process!r} delay process (delay-tolerant ring, "
                f"{adaptive})")
        tau = self.rc.ambdg.tau
        return StalenessSchedule(
            "delayed" if tau else "sync", tau,
            "deterministic tau = ceil(T_c / T_p) after pipeline fill")

    @classmethod
    def timeline_model(cls) -> TimelineModel:
        # workers never idle: epochs tile at T_p; the t-th update lands
        # half a round trip after epoch t ends (paper Fig. 1)
        return TimelineModel(
            scheme=cls.name, event_driven=False,
            epoch_duration=lambda t_p, t_c: t_p,
            update_time=lambda t, t_p, t_c: t * t_p + 0.5 * t_c,
            n_updates=lambda total, t_p, t_c:
                max(int((total - 0.5 * t_c) // t_p), 0))


@register
class AmbStrategy(Strategy):
    """Synchronous AMB (Ferdinand et al.): the AMB-DG step with tau = 0
    on the device; the wall-clock penalty (workers idle through the
    round trip) lives in the timeline model."""

    name = "amb"
    sim_engine = "anytime"

    def __init__(self, model: Model, rc: RunConfig):
        _require_fixed_delay(rc, self.name, "the synchronous baseline "
                             "blocks on every round trip")
        rc = rc.replace(ambdg=dataclasses.replace(rc.ambdg, tau=0))
        super().__init__(model, rc)
        self.init_state, self.train_step = ambdg.build_step_fns(model, rc)

    def staleness_schedule(self) -> StalenessSchedule:
        return StalenessSchedule("sync", 0, "fresh gradients every epoch")

    @classmethod
    def timeline_model(cls) -> TimelineModel:
        return TimelineModel(
            scheme=cls.name, event_driven=False,
            epoch_duration=lambda t_p, t_c: t_p + t_c,
            update_time=lambda t, t_p, t_c: t * t_p + (t - 0.5) * t_c,
            n_updates=lambda total, t_p, t_c:
                max(int((total - t_p - 0.5 * t_c) // (t_p + t_c)) + 1, 0))


class KBatchState(NamedTuple):
    """The on-device step's state: the master-pipeline state plus the
    parameter version ``ref_epoch`` the next gradients refer to, so the
    staleness comes from the state, never from arrival order."""
    base: ambdg.TrainState
    ref_epoch: torch.Tensor    # () int32


@register
class KBatchStrategy(Strategy):
    """Fixed per-message minibatch. The K arrivals per update and the
    random staleness are event-driven and live in the simulator
    (``core.kbatch.KBatchMaster`` in ``sim.simulate_kbatch``, K from
    ``AmbdgConfig.kbatch_K``); the on-device step is its synchronous
    degenerate: every worker's message arrives together, the staleness
    is 0, and the step is the tau = 0 master pipeline on fixed-size
    minibatches. A stochastic ``rc.delay`` is validated here and
    consumed by the simulator (per-message uplink jitter)."""

    name = "kbatch"
    sim_engine = "kbatch"

    def __init__(self, model: Model, rc: RunConfig):
        from repro_torch.core.delay_process import resolve_bounds
        resolve_bounds(rc.delay, rc.ambdg.tau)
        self.delay_cfg = rc.delay
        self._nominal_tau = rc.ambdg.tau
        rc = rc.replace(ambdg=dataclasses.replace(rc.ambdg, tau=0),
                        delay=dataclasses.replace(rc.delay, process="fixed",
                                                  tau_max=0))
        super().__init__(model, rc)
        init_base, step_base = ambdg.build_step_fns(model, rc)
        device = model.device

        def init_state(generator=None) -> KBatchState:
            return KBatchState(base=init_base(generator),
                               ref_epoch=torch.ones((), dtype=torch.int32,
                                                    device=device))

        def train_step(state: KBatchState, batch):
            base, metrics = step_base(state.base, batch)
            metrics["staleness"] = metrics["step"] - state.ref_epoch
            return KBatchState(base=base,
                               ref_epoch=state.ref_epoch + 1), metrics

        self.init_state = init_state
        self.train_step = train_step

    def delay_process(self):
        # the on-device step stripped rc.delay to fixed; the simulator's
        # process comes from the configured one, with the nominal tau
        if self.delay_cfg.process == "fixed":
            return None
        from repro_torch.core.delay_process import make_delay_process
        return make_delay_process(self.delay_cfg, self._nominal_tau)

    def batch_schedule(self):
        # the device step runs the tau = 0 degenerate, but the
        # delay-aware schedule refers to the configured nominal
        # staleness (the event-driven simulator's regime)
        if self.rc.batch_schedule.schedule == "fixed":
            return None
        from repro_torch.core.batch_schedule import make_batch_schedule
        return make_batch_schedule(self.rc.batch_schedule,
                                   self.rc.ambdg.b_bar, self._nominal_tau)

    def staleness_schedule(self) -> StalenessSchedule:
        extra = ""
        if self.delay_cfg.process != "fixed":
            extra = (f"; uplink times jittered by the seeded "
                     f"{self.delay_cfg.process!r} delay process in the "
                     f"event-driven simulator")
        return StalenessSchedule(
            "random", 0,
            "random per-message staleness (update t applies messages "
            "with ref_epoch <= t; distribution from the arrival heap)"
            + extra)

    @classmethod
    def timeline_model(cls) -> TimelineModel:
        return TimelineModel(scheme=cls.name, event_driven=True)


# ---------------------------------------------------------------------------
# Decentralized AMB-DG (paper Sec. V): gossip consensus, no master
# ---------------------------------------------------------------------------
class DecentralizedState(NamedTuple):
    params: Any              # per-worker stacked tree: leaves (n, *shape) f32
    z: torch.Tensor          # (n, rows, 128) f32: per-worker duals, arena form
    # (n, rows, 128) f32: the int8 gossip's per-worker error-feedback
    # residual (zero under compression="none")
    residual: torch.Tensor
    t: torch.Tensor          # () int32: dual-averaging epoch counter
    step: torch.Tensor       # () int32: steps taken


@register
class DecentralizedStrategy(Strategy):
    """No master: each of ``rc.consensus.n_workers`` workers holds its own
    dual z_i in arena form and its own parameters w_i. Each epoch every
    worker computes an anytime gradient at w_i on its chunk of the batch,
    forms m_i = n (b_i z_i + g_i) / b(t), and the messages run r rounds
    of the topology's stencil fold (``core.consensus``); the result is
    the new z_i, and w_i = prox(z_i) per worker. r comes from eq. (24)
    with ``rc.consensus`` (or its explicit ``rounds``).

    ``rc.consensus.gossip_impl``: "dense" runs the stencil fold on the
    stacked (n, rows, 128) messages in one process; "shard_map" runs one
    worker a rank (JAX's name for its per-device fold): worker i is rank
    i of an initialised ``torch.distributed`` world of exactly n_workers
    ranks, in a worker group the strategy makes over it
    (``dist.collectives.worker_group``), and each neighbour term is a
    point-to-point exchange (``consensus.gossip_rounds_shard*``). Each
    rank holds worker i's params, z and residual with a leading dim of
    1, takes block i of n of the batch (``train.loop`` cuts it), computes
    only its worker's gradient, and runs the stacked step's arithmetic
    on its slice: the state and ``loss`` and ``applied_count`` equal the
    dense run's bit for bit (the workers' counts and loss sums are
    all-gathered and folded in worker order); ``grad_norm`` and
    ``consensus_error`` sum whole messages over the workers in an
    all-reduce, so they agree to its summation order. "auto" picks
    "shard_map" exactly when an initialised world has n_workers ranks
    (JAX: the device count equals n_workers), else "dense". Neither
    composes with a pod mesh of more than one rank (nor does JAX's).
    ``rc.consensus.compression="int8"`` quantizes each round's message
    to int8 with per-row bf16 scales and carries the quantization error
    in ``DecentralizedState.residual``. Under a non-static ``rc.elastic``
    the step reads the epoch's (n,) 0/1 mask as ``batch["active"]``: the
    masked fold reroutes dead neighbours' weight to the self term, and
    dead workers' z and params carry over bit for bit."""

    name = "decentralized"
    sim_engine = None          # on the device only

    def __init__(self, model: Model, rc: RunConfig):
        _require_fixed_delay(rc, self.name,
                             "gossip consensus exchanges fresh local duals "
                             "every epoch (no master delay ring to jitter)")
        super().__init__(model, rc)
        ambdg.check_anytime_impl(rc)
        if rc.ambdg.proximal not in ("l2", "l2_ball"):
            raise ValueError(f"unknown proximal {rc.ambdg.proximal!r}")
        cc = rc.consensus
        self._elastic = rc.elastic.process != "static"
        self.consumes_active_mask = self._elastic
        if self._elastic and cc.compression == "int8":
            raise ValueError(
                "decentralized elastic churn does not compose with int8 "
                "gossip compression: a dead worker cannot quantize its "
                "message or carry error feedback for rounds it never ran; "
                "use compression='none' with a non-static rc.elastic")
        if cc.compression not in consensus.COMPRESSION_MODES:
            raise ValueError(f"unknown gossip compression "
                             f"{cc.compression!r}")
        from repro_torch.dist.context import active_mesh
        mesh = active_mesh()
        if mesh is not None and mesh.n_devices > 1:
            raise NotImplementedError(
                "the decentralized strategy does not compose with a pod "
                f"mesh of {mesh.n_devices} ranks (nor does JAX's: its "
                "gossip runs on a private ('worker',) mesh): train it "
                "without mesh=, one worker a rank (gossip_impl="
                "'shard_map') or the dense fold in one process")
        self.Q = consensus.gossip_matrix(cc.topology, cc.n_workers)
        self.lam2 = consensus.lambda2(self.Q)
        self.rounds = cc.rounds if cc.rounds > 0 else consensus.min_rounds(
            cc.delta, cc.n_workers, cc.msg_norm_J, self.lam2)
        self.layout = arena_mod.make_layout(model.param_shapes())
        self.gossip_impl = self._resolve_gossip_impl(cc)
        # the per-rank route's worker group (None on the dense fold)
        self.workers = None
        if self.gossip_impl == "shard_map":
            from repro_torch.dist.collectives import worker_group
            self.workers = worker_group(cc.n_workers)
        # the neighbour index tensors, once, on the strategy's device
        consensus.stencil_on(cc.topology, cc.n_workers, model.device)
        self.init_state, self.train_step = self._build()

    @staticmethod
    def _resolve_gossip_impl(cc) -> str:
        impl = cc.gossip_impl
        if impl == "auto":
            # JAX's rule: one device per worker picks the per-device
            # fold; the run's devices are the ranks of its world (one
            # device a rank), and without a process group the per-rank
            # route cannot run
            import torch.distributed as dist
            n_dev = (dist.get_world_size() if dist.is_available()
                     and dist.is_initialized() else 0)
            impl = "shard_map" if n_dev == cc.n_workers else "dense"
        if impl not in ("dense", "shard_map"):
            raise ValueError(f"unknown gossip_impl {cc.gossip_impl!r}")
        return impl

    def _gossip_fn(self):
        """(m0, residual, active) -> (z, residual'): the fold, int8 with
        error feedback, or masked under churn; on the stacked messages
        or, per rank, on this worker's."""
        cc = self.rc.consensus
        topology, rounds, n = cc.topology, self.rounds, cc.n_workers
        if self.workers is not None:
            group = self.workers.group
            if cc.compression == "int8":
                return lambda m0, res, active: \
                    consensus.gossip_rounds_shard_int8(
                        m0, res, group, topology, n, rounds)
            if self._elastic:
                return lambda m0, res, active: (
                    consensus.gossip_rounds_shard_masked(
                        m0, group, topology, n, rounds, active), res)
            return lambda m0, res, active: (
                consensus.gossip_rounds_shard(m0, group, topology, n,
                                              rounds), res)
        if cc.compression == "int8":
            return lambda m0, res, active: consensus.run_consensus_fold_int8(
                m0, res, topology, rounds)
        if self._elastic:
            return lambda m0, res, active: (
                consensus.run_consensus_fold_masked(m0, topology, rounds,
                                                    active), res)
        return lambda m0, res, active: (
            consensus.run_consensus_fold(m0, topology, rounds), res)

    def shard_specs(self, state):
        """Per rank: the checkpoint path and spec of each leaf of
        ``state`` that the rank holds worker i's slice of (params, z,
        residual; ``dist.sharding.gossip_specs``), for
        ``checkpoint.save_sharded`` and ``restore(..., shard=)`` with the
        sizes ``{"worker": n}``; None on the dense fold."""
        if self.workers is None:
            return None
        from repro_torch.dist.sharding import gossip_specs
        from repro_torch.train.checkpoint import _flatten_with_paths
        specs = gossip_specs()
        return {path: specs.msg if path in (".z", ".residual")
                else specs.scalar
                for path, _ in _flatten_with_paths(state)
                if path.split("/")[0] in (".params", ".z", ".residual")}

    def _build(self):
        model, rc = self.model, self.rc
        cfg = rc.ambdg
        n = rc.consensus.n_workers
        wg = self.workers
        # the workers this process holds: all n, or worker i of rank i
        n_local = n if wg is None else 1
        layout = self.layout
        device = model.device
        loss_fn = ambdg.loss_with_remat(model, rc)
        gossip = self._gossip_fn()
        elastic = self._elastic
        variable_batch = rc.batch_schedule.schedule != "fixed"

        def init_state(generator: Optional[torch.Generator] = None
                       ) -> DecentralizedState:
            # every worker starts at the same point, in f32
            params = arena_mod.tree_map(
                lambda p: p.to(torch.float32).unsqueeze(0).repeat(
                    (n_local,) + (1,) * p.dim()), model.init(generator))
            zeros = lambda: torch.zeros(
                (n_local, layout.rows, arena_mod.LANES),
                dtype=torch.float32, device=device)
            return DecentralizedState(
                params=params, z=zeros(), residual=zeros(),
                t=torch.zeros((), dtype=torch.int32, device=device),
                step=torch.zeros((), dtype=torch.int32, device=device))

        def per_worker_grads(params, batch):
            """JAX's ``vmap`` over the workers as a loop: worker i runs the
            anytime accumulation at its own slice of the stacked params on
            its chunk of the batch (the first ``batch["n_active"]``
            microbatches of it under "while_dynamic"). Per rank the batch
            is this worker's chunk. Returns (flat grads (n_local, rows,
            128), counts (n_local,), loss sums (n_local,))."""
            batch, n_active = anytime.pop_n_active(batch, n_local)
            for k, x in batch.items():
                if x.shape[0] % n_local:
                    raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows "
                                     f"does not split over {n} workers")
            chunks = {k: x.reshape((n_local, x.shape[0] // n_local)
                                   + tuple(x.shape[1:]))
                      for k, x in batch.items()}
            g_flat = torch.zeros((n_local, layout.rows, arena_mod.LANES),
                                 dtype=torch.float32, device=device)
            counts, losses = [], []
            for i in range(n_local):
                g, c, m = ambdg.accumulate(
                    rc, loss_fn, arena_mod.tree_map(lambda p: p[i], params),
                    {k: x[i] for k, x in chunks.items()}, n_active[i])
                arena_mod.flatten_tree(layout, g, out=g_flat[i])
                counts.append(c)
                losses.append(m["loss_sum"])
                del g
            return g_flat, torch.stack(counts), torch.stack(losses)

        def every_worker(b, loss):
            """The (n,) counts and loss sums of every worker: this
            process's own, or per rank all-gathered in worker order."""
            if wg is None:
                return b, loss
            from repro_torch.dist.collectives import all_gather
            stats = all_gather(torch.stack([b[0], loss[0]]).to(
                torch.float32), wg.group, n, axis="worker",
                tag="worker_counts")
            return stats[:, 0].contiguous(), stats[:, 1].contiguous()

        def mine(x):
            """This process's rows of an (n,) per-worker vector."""
            return x if wg is None else x[wg.rank:wg.rank + 1]

        def metric_sums(g_flat, z_new, active):
            """(the norm of the gradients' sum over the workers, the
            consensus error of z); per rank each sums whole messages in
            an all-reduce over the workers (tagged "metrics")."""
            if wg is None:
                grad_sum = torch.sum(g_flat, dim=0)
                err = (consensus.consensus_error_masked(
                    z_new.reshape(n, -1), active) if elastic
                    else consensus.consensus_error(z_new.reshape(n, -1)))
                return torch.sqrt(torch.sum(torch.square(grad_sum))), err
            import torch.distributed as dist

            from repro_torch.dist.collectives import all_reduce
            on = {"axis": "worker", "tag": "metrics"}
            grad_sum = all_reduce(g_flat[0].clone(), wg.group, **on)
            v = z_new.reshape(1, -1)
            if elastic:
                a = active.reshape(-1, 1)
                total = all_reduce(v * mine(a), wg.group, **on)
                mean = torch.div(total, torch.clamp(torch.sum(a), min=1.0))
                dev = torch.linalg.vector_norm((v - mean) * mine(a), dim=-1)
            else:
                mean = torch.div(all_reduce(v.clone(), wg.group, **on), n)
                dev = torch.linalg.vector_norm(v - mean, dim=-1)
            err = all_reduce(torch.amax(dev), wg.group,
                             op=dist.ReduceOp.MAX, **on)
            return torch.sqrt(torch.sum(torch.square(grad_sum))), err

        def train_step(state: DecentralizedState, batch: Dict):
            active = None
            if elastic:
                if "active" not in batch:
                    raise ValueError(
                        "decentralized elastic step needs the per-epoch "
                        "active mask as batch['active'] (the host loop "
                        "ships the (n_workers,) 0/1 vector the worker "
                        "process drew)")
                active = batch["active"].to(torch.float32).reshape(n)
                batch = {k: v for k, v in batch.items() if k != "active"}
            b_sched = None
            if variable_batch:
                if "b_sched" not in batch:
                    raise ValueError(
                        f"rc.batch_schedule.schedule="
                        f"{rc.batch_schedule.schedule!r} needs a per-step "
                        "batch['b_sched'] scalar (the host loop draws it "
                        "from core.batch_schedule)")
                b_sched = batch["b_sched"].to(torch.float32)
                batch = {k: v for k, v in batch.items() if k != "b_sched"}
            g_flat, b_own, loss_own = per_worker_grads(state.params, batch)
            with torch.no_grad():
                b, loss = every_worker(b_own, loss_own)
                # the effective fleet size the Sec.-V messages scale by:
                # n, or the alive count under churn
                scale = torch.sum(active) if elastic else n
                total_b = torch.sum(b)
                denom = torch.clamp(total_b, min=1e-12)
                # m_i(0) = n (b_i z_i + g_i) / b(t)  (paper Sec. V)
                m0 = torch.div(
                    scale * (state.z * mine(b)[:, None, None] + g_flat),
                    denom)
                z_new, res_new = gossip(m0, state.residual, active)
                if elastic:
                    # dead workers are frozen spectators
                    z_new = torch.where(mine(active)[:, None, None] > 0,
                                        z_new, state.z)
                t_next = state.t + 1
                a = da.alpha(t_next.to(torch.float32) + 1.0, cfg, b=b_sched)
                w = -a * z_new
                if cfg.proximal == "l2_ball":
                    # each worker projects onto its own ball; each norm
                    # is reduced on its own, so the stacked and the
                    # per-rank steps sum it alike (on the card a
                    # reduction's split follows its number of outputs,
                    # ROADMAP C.19)
                    norms = torch.sqrt(torch.stack(
                        [torch.sum(torch.square(w[i]))
                         for i in range(n_local)]))
                    proj = torch.clamp(torch.div(
                        da._const(cfg.radius_C, norms),
                        torch.clamp(norms, min=1e-12)), max=1.0)
                    w = w * proj[:, None, None]
                params = arena_mod.unflatten_tree(layout, w, cast=False)
                if elastic:
                    alive = mine(active) > 0
                    params = arena_mod.tree_map(
                        lambda new, old: torch.where(
                            alive.reshape((n_local,) + (1,) * (new.dim() - 1)),
                            new, old), params, state.params)
                g_norm, err = metric_sums(g_flat, z_new, active)
                metrics = {
                    "loss": torch.div(torch.sum(loss), denom),
                    "applied_count": total_b,
                    "local_count": total_b,
                    "grad_norm": torch.div(g_norm, denom),
                    "consensus_error": err,
                    "step": state.step + 1,
                }
                if elastic:
                    metrics["active_workers"] = scale
                if rc.consensus.debug_messages:
                    # the exact messages this step gossiped (per rank:
                    # this worker's), for an oracle to fold again
                    metrics["gossip_m0"] = m0
                    metrics["gossip_r0"] = state.residual
                    if elastic:
                        metrics["gossip_active"] = active
            return DecentralizedState(params=params, z=z_new,
                                      residual=res_new, t=t_next,
                                      step=state.step + 1), metrics

        return init_state, train_step

    def staleness_schedule(self) -> StalenessSchedule:
        return StalenessSchedule(
            "gossip", 0,
            f"fresh local gradients; r={self.rounds} gossip rounds "
            f"(eq. 24: delta={self.rc.consensus.delta}, "
            f"lambda2={self.lam2:.4f}) bound the consensus error")

    @classmethod
    def timeline_model(cls) -> TimelineModel:
        # synchronous epochs like AMB: the gossip exchange rides the
        # round trip T_c between compute epochs
        return TimelineModel(
            scheme=cls.name, event_driven=False,
            epoch_duration=lambda t_p, t_c: t_p + t_c,
            update_time=lambda t, t_p, t_c: t * t_p + (t - 0.5) * t_c,
            n_updates=lambda total, t_p, t_c:
                max(int((total - t_p - 0.5 * t_c) // (t_p + t_c)) + 1, 0))
