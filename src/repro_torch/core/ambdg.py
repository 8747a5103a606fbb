"""AMB-DG composed train step: anytime accumulation -> delayed pod
exchange -> dual-averaging update (ported from ``repro/core/ambdg.py``).

``build_step_fns(model, rc, device)`` returns ``(init_state,
train_step)``:

    state = init_state(generator)
    state, metrics = train_step(state, batch)

Batch leaves are tensors on the model's device with the global batch on
dim 0; per-sample ``weights`` carry the anytime mask b_i(t). Gradients
are summed per pod chunk (the pod axis is a written-out leading
dimension), pushed into the tau-deep ring, and the popped tau-old entry,
summed over pods, feeds dual averaging: z(t+1) = z(t) + g(t - tau).
tau = 0 is the synchronous AMB update. ``train_step`` updates the arena
buffers and z in place: pass each state once and keep the returned one.

``rc.delay`` selects the staleness process. "fixed" runs the static
ring (layout v2). A stochastic process (jitter, heavy_tail, bursty)
runs the delay-tolerant ring (layout v3, ``arena.push_pop_variable``)
on a per-step ``batch["delay"]`` the host loop draws from
``core.delay_process``, with the delay-adaptive step size
(``rc.delay.adaptive_alpha``); its metrics add ``tau_applied``.

``rc.master_impl`` selects the master pipeline: "arena" (the default)
keeps the delay ring and z in the flat (rows, 128) arena and runs the
CUDA kernels on the card; "pytree" is the per-leaf reference
(``core.delayed`` + ``optim.make_optimizer``), which launches no kernel
and equals the arena master bit for bit (``proximal="l2"``; ``l2_ball``
to the ball norm's summation order). The stochastic delay runs on the
arena only, as in the JAX package.

``rc.batch_schedule`` selects the minibatch-target schedule: "fixed"
keeps the static ``b_bar`` in the step size; an adaptive schedule
(linear, adadamp, delay_aware) reads the per-step target the host loop
draws from ``core.batch_schedule`` as a 0-dim ``batch["b_sched"]``
tensor on the device, which replaces ``b_bar`` in alpha. It runs on
the arena master only, as in the JAX package.

Under a multi-rank ``P x D x M`` mesh (``launch.mesh``; an active
``dist.context`` profile of more than one device) the step is the
sharded master, ZeRO-like: each rank gets its block of the batch (its
share of its pod's microbatches, the same on every ``model`` rank),
runs it (at ``model > 1`` on its parameter blocks, the tensor
parallelism of the dense, MoE and hybrid LMs, ``dist.tensor_parallel``),
turns the gradient into its block of the whole tree's arena rows
(``_grad_rows``: the model blocks gathered leaf by leaf, then
reduce-scattered over ``data``), pushes and pops its row shard through
the ring (``arena.push_pop``'s sharded route: the pods cross in the
ring's collectives), updates z on its rows, all-gathers w over ``data x
model`` to rebuild the whole parameters (``dual_averaging.
update_arena``) and keeps its model blocks of them.
The pods' counts and losses cross in one small gather, so the metrics
are global on every rank. amb and kbatch share this step; the pytree
master, sgd and adam, and the dynamic trip over more than one data
rank raise (ROADMAP A.11 part 2, item 4).

``rc.remat="whole_loss"`` wraps the whole loss in
``torch.utils.checkpoint`` (``loss_with_remat``, the same for every
strategy that takes a gradient of an LM). Every knob the port does not
carry yet raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import RunConfig
from repro_torch.core import anytime, delayed
from repro_torch.core import arena as arena_mod
from repro_torch.core import dual_averaging as _da
from repro_torch.core.delayed import pod_sum
from repro_torch.models.api import Model


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    buffer: Optional[delayed.DelayBuffer]    # pytree master path
    arena: Optional[arena_mod.GradArena]     # arena master path
    step: torch.Tensor                       # () int32


def check_supported(rc: RunConfig) -> None:
    """Raise ``NotImplementedError`` for every knob of ``rc`` the port's
    step does not carry yet (never ignore one silently)."""
    if rc.master_impl not in ("arena", "pytree"):
        raise ValueError(f"unknown master_impl {rc.master_impl!r}; "
                         "expected 'arena' or 'pytree'")
    if rc.master_impl == "pytree" and rc.delay.process != "fixed":
        raise ValueError(
            "stochastic delay processes run on the arena master pipeline "
            "only (rc.master_impl='arena'); the pytree reference path keeps "
            "the paper's fixed tau")
    if rc.master_impl == "pytree" and rc.batch_schedule.schedule != "fixed":
        raise ValueError(
            "adaptive batch schedules run on the arena master pipeline "
            "only (rc.master_impl='arena'); the pytree reference path keeps "
            "the paper's static b_bar")
    check_anytime_impl(rc)


def check_anytime_impl(rc: RunConfig) -> None:
    if rc.ambdg.anytime_impl not in ("scan_masked", "while_dynamic"):
        raise ValueError(f"unknown anytime_impl {rc.ambdg.anytime_impl!r}; "
                         "expected 'scan_masked' or 'while_dynamic'")


def accumulate(rc: RunConfig, loss_fn, params, chunk, n_active,
               n_mb: Optional[int] = None):
    """One chunk's (grad_sum, count, metrics) by ``rc.ambdg.anytime_impl``:
    the masked accumulation over every microbatch (``n_mb``, by default
    ``rc.ambdg.n_microbatches``), or the dynamic trip over the first
    ``n_active`` (None: all)."""
    n_mb = rc.ambdg.n_microbatches if n_mb is None else n_mb
    if rc.ambdg.anytime_impl == "while_dynamic":
        return anytime.accumulate_while(loss_fn, params, chunk, n_mb,
                                        n_active)
    return anytime.accumulate_scan(loss_fn, params, chunk, n_mb)


def loss_with_remat(model: Model, rc: RunConfig):
    """``model.loss``, under ``torch.utils.checkpoint`` as a whole when
    ``rc.remat == "whole_loss"`` (JAX's ``_loss_with_remat``: any other
    value leaves it as it is; the blocks' own remat is
    ``ModelConfig.block_remat``)."""
    if rc.remat == "whole_loss":
        return lambda p, b: checkpoint(model.loss, p, b, use_reentrant=False)
    return model.loss


def arena_master_update(layout, opt, params, opt_state, arena_state,
                        pod_grads, pod_counts, compression: str = "none",
                        b_sched=None):
    """The master pipeline on the flat arena: rotate the delay ring with
    this step's pod-stacked gradient tree and apply the optimizer to the
    popped sum. ``b_sched`` threads an adaptive batch schedule's target
    into the step size (None: the static ``b_bar``). Returns (params,
    opt_state, arena_state, grad_sum_flat, count)."""
    if arena_state is not None:
        grad_sum, count, arena_state = arena_mod.push_pop(
            layout, arena_state, pod_grads, pod_counts, compression)
    else:  # tau = 0: synchronous exchange, then one flat scatter
        leaves, treedef = arena_mod.tree_flatten(pod_grads)
        summed = arena_mod.tree_unflatten(treedef,
                                          [pod_sum(g) for g in leaves])
        grad_sum = arena_mod.flatten_tree(layout, summed)
        count = torch.sum(pod_counts)
    params, opt_state = opt.update(opt_state, params, grad_sum, count,
                                   b_sched=b_sched)
    return params, opt_state, arena_state, grad_sum, count


def pytree_master_update(opt, params, opt_state, buffer, pod_grads,
                         pod_counts, compression: str = "none"):
    """The per-leaf reference master (the JAX step's ``master_impl=
    "pytree"`` branch): rotate the delay buffer (or, for tau = 0, sum the
    pods), normalize by the popped count and apply the pytree optimizer.
    Launches no kernel. Returns (params, opt_state, buffer, g, count), g
    the normalized gradient tree."""
    if buffer is not None:
        grad_sum, count, buffer = delayed.push_pop(buffer, pod_grads,
                                                   pod_counts, compression)
    else:
        grad_sum = arena_mod.tree_map(pod_sum, pod_grads)
        count = torch.sum(pod_counts)
    g = anytime.normalize(grad_sum, count)
    params, opt_state = opt.update(opt_state, params, g)
    return params, opt_state, buffer, g, count


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares (JAX's ``optax_global_norm``)."""
    leaves, _ = arena_mod.tree_flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


class MeshShard(NamedTuple):
    """A rank's place in the step under a multi-rank mesh."""
    ranks: Any                 # dist.collectives.Ranks
    rows_local: int            # the arena rows it holds
    data_group: Any            # its pod's ranks over 'data' (None: D = 1)
    rows_group: Any            # the group its rows shard over (None: 1)
    n_mb: int                  # its microbatches of its pod's chunk
    ax: Any                    # tensor_parallel.ModelAxis (None: M = 1)
    dims: Any                  # each leaf's model-cut dim (None: M = 1)


def _mesh_shard(rc: RunConfig, layout, model) -> Optional[MeshShard]:
    """None off the mesh; under an active multi-rank mesh the rank's
    shard, after refusing every knob the sharded step does not carry
    (each names ROADMAP A.11 part 2, item 4, or, for a family the model
    axis does not carry, item 6)."""
    ranks = arena_mod.sharded_route("the AMB-DG train step")
    if ranks is None:
        return None
    from repro_torch.dist import tensor_parallel
    from repro_torch.dist.context import active_mesh
    if active_mesh() != rc.mesh:
        raise ValueError(f"the active mesh {active_mesh()} is not the run's "
                         f"rc.mesh {rc.mesh}")
    if layout is None:
        raise NotImplementedError(
            "master_impl='pytree' under a multi-rank mesh: the sharded "
            "master is the arena's (the pytree master's sharding is "
            "ROADMAP A.11 part 2, item 4)")
    if rc.optimizer != "dual_averaging":
        raise NotImplementedError(
            f"optimizer={rc.optimizer!r} under a multi-rank mesh: the "
            "sharded master runs dual averaging; sgd and adam on row "
            "shards are ROADMAP A.11 part 2, item 4")
    n_data, n_model = ranks.sizes["data"], ranks.sizes["model"]
    tensor_parallel.check_model_axis(rc.model, n_model)
    if n_data > 1 and rc.ambdg.anytime_impl == "while_dynamic":
        raise NotImplementedError(
            "anytime_impl='while_dynamic' with data > 1: splitting the "
            "dynamic trip over a pod's ranks is ROADMAP A.11 part 2, "
            "item 4")
    n_mb = rc.ambdg.n_microbatches
    if n_mb % n_data:
        raise ValueError(f"{n_mb} microbatches a pod do not split over "
                         f"its {n_data} data ranks")
    rows_local, _, group = arena_mod.shard_rows(layout, ranks)
    if rows_local * n_data * n_model != layout.rows:
        raise ValueError(f"the arena's {layout.rows} rows do not split "
                         f"over {n_data} x {n_model} data x model ranks")
    ax = tensor_parallel.model_axis()
    dims = None if ax is None else tensor_parallel.model_dims(
        rc.model, layout, model.param_axes(), rc.mesh)
    return MeshShard(ranks, rows_local,
                     ranks.group("data") if n_data > 1 else None, group,
                     n_mb // n_data, ax, dims)


def _grad_rows(layout, shard: MeshShard, grads):
    """The gradient -> rows bridge: the rank's (rows_local, 128) block
    of the pod's gradient in the whole tree's arena rows. Leaf by leaf,
    a model-cut leaf's blocks are all-gathered over ``model`` (the
    transient holds one whole leaf, never the whole gradient; the
    leaves whose gradient each rank holds a part of were summed over
    ``model`` in the backward, ``dist.tensor_parallel``), and the rows
    of the data ranks' blocks this rank's model coordinate names (block
    d M + m for every d) are copied into one buffer, which is
    reduce-scattered over ``data``. At ``model = 1`` the buffer is
    ``flatten_tree``'s."""
    from repro_torch.dist.collectives import all_gather, reduce_scatter_rows
    from repro_torch.dist.tensor_parallel import join_leaf
    ranks, rl = shard.ranks, shard.rows_local
    n_data, n_model = ranks.sizes["data"], ranks.sizes["model"]
    m = ranks.coords["model"]
    leaves, _ = arena_mod.tree_flatten(grads)
    dims = shard.dims or [None] * len(leaves)
    lanes = arena_mod.LANES
    buf = torch.zeros((n_data, rl, lanes), dtype=torch.float32,
                      device=leaves[0].device)
    for leaf, dim, ofs, size, rc in zip(leaves, dims, layout.row_offsets,
                                        layout.sizes, layout.row_counts):
        if dim is not None:
            leaf = join_leaf(all_gather(leaf, shard.ax.group, n_model,
                                        axis="model", tag="grad_leaves"
                                        ).unbind(0), dim)
        flat = leaf.reshape(-1)
        for d in range(n_data):
            b0 = (d * n_model + m) * rl
            lo, hi = max(ofs, b0), min(ofs + rc, b0 + rl)
            if lo < hi:
                e0, e1 = (lo - ofs) * lanes, min(size, (hi - ofs) * lanes)
                buf[d, lo - b0:hi - b0].reshape(-1)[:e1 - e0].copy_(
                    flat[e0:e1])
    if n_data == 1:
        return buf[0]
    return reduce_scatter_rows(buf.reshape(n_data * rl, lanes),
                               shard.data_group, n_data, axis="data",
                               tag="grad_rows")


def _shard_grads(rc, loss_fn, layout, shard: MeshShard, params, batch):
    """The sharded twin of ``pod_chunk_grads``: ``batch`` is this rank's
    block of the global batch (``train.loop`` cuts it by the batch's
    spec: its share of its pod's microbatches, the same on every
    ``model`` rank). The rank accumulates its microbatches (under
    ``model > 1`` the gradient of its parameter blocks) and
    ``_grad_rows`` turns the sum into its block of the pod's arena rows.
    The pods' counts and loss sums come from one gather over every rank
    (one ``model`` rank's a data rank). Returns (the rank's (1,
    rows_local, 128) gradient rows, counts (n_pods,), loss sums
    (n_pods,))."""
    from repro_torch.dist.collectives import all_gather, axis_label
    ranks = shard.ranks
    batch, (n_active,) = anytime.pop_n_active(batch, 1)
    grads, count, metrics = accumulate(rc, loss_fn, params, batch, n_active,
                                       n_mb=shard.n_mb)
    flat = _grad_rows(layout, shard, grads)
    stats = torch.stack([count, metrics["loss_sum"]]).to(torch.float32)
    sizes = ranks.sizes
    world = sizes["pod"] * sizes["data"] * sizes["model"]
    stats = all_gather(stats, None, world,
                       axis=axis_label(("pod", "data", "model"), sizes),
                       tag="pod_counts").reshape(
        sizes["pod"], sizes["data"], sizes["model"], 2)[:, :, 0]
    per_pod = stats[:, 0] if stats.shape[1] == 1 else torch.sum(stats, 1)
    return flat[None], per_pod[:, 0], per_pod[:, 1]


def _shard_pod_sum(shard: MeshShard, pod_grads):
    """tau = 0 under a mesh: the rank's rows summed over every pod."""
    from repro_torch.dist.collectives import all_reduce
    return all_reduce(delayed.pod_sum(pod_grads).clone(),
                      shard.ranks.group("pod"), axis="pod", tag="pod_pop")


def shard_specs(layout, state, mesh, model=None) -> Dict[str, Any]:
    """The checkpoint path and spec of each leaf of ``state`` that a
    rank holds a shard of under a multi-rank ``mesh`` (a MeshConfig):
    z's rows (``arena_slot_specs``'s row spec), the arena's buffers
    (``arena.arena_shard_specs``) and, at ``model > 1``, the parameters
    ``model`` cuts (``tensor_parallel.param_specs`` of ``model``, which
    that needs); every other leaf is whole on every rank. A ``KBatchState``'s lie under its base. ``train.loop`` writes
    and restores the sharded state's checkpoints with them."""
    from repro_torch.dist.sharding import arena_slot_specs
    if hasattr(state, "base"):
        return {f".base/{k}": s for k, s in
                shard_specs(layout, state.base, mesh, model).items()}
    out = {".opt_state/.z": arena_slot_specs(mesh, layout.rows)[2]}
    if mesh.model > 1:
        from repro_torch.dist.tensor_parallel import param_specs
        out.update({f".params/{k}": s for k, s in param_specs(
            model.cfg, layout, model.param_axes(), mesh).items()})
    if state.arena is not None:
        out.update({f".arena/{k}": s for k, s in arena_mod.arena_shard_specs(
            layout, state.arena, mesh).items()})
    return out


def build_step_fns(model: Model, rc: RunConfig):
    """The AMB-DG step factory, internal to the strategies (user code
    goes through ``repro_torch.api.build``)."""
    from repro_torch.core.delay_process import resolve_bounds
    from repro_torch.optim import make_arena_optimizer, make_optimizer
    check_supported(rc)
    # rc.batch_schedule is validated by the strategy that builds this
    variable_batch = rc.batch_schedule.schedule != "fixed"
    device = model.device
    n_pods = rc.mesh.n_pods
    tau = rc.ambdg.tau
    variable_delay = rc.delay.process != "fixed"
    _, tau_max = resolve_bounds(rc.delay, tau)   # validates rc.delay
    # a stochastic delay's ring holds its cap: tau_max + 1 slots
    ring_tau = tau_max if variable_delay else tau
    compression = rc.ambdg.pod_compression
    if compression not in ("none", "int8"):
        raise ValueError(f"unknown pod_compression {compression!r}")
    use_arena = rc.master_impl == "arena"
    loss_fn = loss_with_remat(model, rc)
    if use_arena:
        # shapes only (the meta device), as JAX builds it from eval_shape:
        # no second parameter set is allocated or drawn
        # the whole tree's layout, whatever 'model' cuts of the params
        layout = arena_mod.make_layout(model.whole_param_shapes())
        opt = make_arena_optimizer(rc, layout, device)
    else:
        opt = make_optimizer(rc)

    # under a multi-rank mesh: the rank's pod and rows (None off it)
    shard = _mesh_shard(rc, layout if use_arena else None, model)

    def init_state(generator: Optional[torch.Generator] = None) -> TrainState:
        params = model.init(generator)   # on a mesh, every rank's alike
        if not use_arena:
            return TrainState(
                params=params, opt_state=opt.init(params),
                buffer=delayed.init_buffer(params, tau, n_pods, compression),
                arena=None,
                step=torch.zeros((), dtype=torch.int32, device=device))
        local = None if shard is None else (1, shard.rows_local)
        return TrainState(
            params=params,
            opt_state=(opt.init() if shard is None else
                       _da.init_arena(layout, device, rows=local[1])),
            buffer=None,
            arena=arena_mod.init_arena(layout, ring_tau, n_pods,
                                       compression, device=device,
                                       variable=variable_delay,
                                       local=local),
            step=torch.zeros((), dtype=torch.int32, device=device))

    def pod_chunk_grads(params, batch):
        """Pod-stacked (grads {k: (n_pods, ...)}, counts (n_pods,), loss
        sums (n_pods,)): each pod's chunk of the batch on its own (the
        first ``batch["n_active"]`` microbatches of it under
        "while_dynamic"). On a mesh, ``_shard_grads``."""
        if shard is not None:
            return _shard_grads(rc, loss_fn, layout, shard, params, batch)
        batch, n_active = anytime.pop_n_active(batch, n_pods)
        chunks = [batch] if n_pods == 1 else [
            {k: v.reshape((n_pods, v.shape[0] // n_pods)
                          + tuple(v.shape[1:]))[p] for k, v in batch.items()}
            for p in range(n_pods)]
        out = [accumulate(rc, loss_fn, params, c, a)
               for c, a in zip(chunks, n_active)]
        per_pod = [arena_mod.tree_flatten(g)[0] for g, _, _ in out]
        treedef = arena_mod.tree_flatten(out[0][0])[1]
        grads = arena_mod.tree_unflatten(
            treedef, [torch.stack(leaves) for leaves in zip(*per_pod)])
        counts = torch.stack([c for _, c, _ in out])
        losses = torch.stack([m["loss_sum"] for _, _, m in out])
        return grads, counts, losses

    ring_cap = torch.full((), float(ring_tau), dtype=torch.float32,
                          device=device)

    def variable_master_update(state, pod_grads, pod_counts, delay,
                               b_sched):
        """The delay-tolerant master step: the v3 rotation, then dual
        averaging with the observed staleness (or, without
        ``adaptive_alpha``, the ring's cap). Returns (params, opt_state,
        arena_state, grad_sum_flat, count, tau_obs)."""
        grad_sum, count, tau_obs, arena_state = arena_mod.push_pop_variable(
            layout, state.arena, pod_grads, pod_counts, delay, compression)
        # zero-arrival contract: a step with nothing applied reports the
        # ring's cap, never 0, which would tell the adaptive alpha the
        # stalled step was perfectly fresh
        tau_obs = torch.where(count > 0.0, tau_obs, ring_cap)
        params, opt_state = opt.update(
            state.opt_state, state.params, grad_sum, count,
            tau_obs=(tau_obs if rc.delay.adaptive_alpha
                     else float(ring_tau)), b_sched=b_sched)
        return params, opt_state, arena_state, grad_sum, count, tau_obs

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        tau_obs = None
        if variable_delay:
            if "delay" not in batch:
                raise ValueError(
                    f"rc.delay.process={rc.delay.process!r} needs a "
                    "per-step batch['delay'] scalar (the host loop "
                    "draws it from core.delay_process)")
            delay = batch["delay"]
            batch = {k: v for k, v in batch.items() if k != "delay"}
        b_sched = None
        if variable_batch:
            if "b_sched" not in batch:
                raise ValueError(
                    f"rc.batch_schedule.schedule="
                    f"{rc.batch_schedule.schedule!r} needs a per-step "
                    "batch['b_sched'] scalar (the host loop draws it "
                    "from core.batch_schedule)")
            # a 0-dim f32 tensor on the device: alpha reads it there
            b_sched = batch["b_sched"].to(torch.float32)
            batch = {k: v for k, v in batch.items() if k != "b_sched"}
        pod_grads, pod_counts, pod_loss = pod_chunk_grads(state.params, batch)
        buffer = arena_state = None      # the master not in use keeps None
        with torch.no_grad():
            if not use_arena:
                params, opt_state, buffer, g, count = pytree_master_update(
                    opt, state.params, state.opt_state, state.buffer,
                    pod_grads, pod_counts, compression)
                g_norm = global_norm(g)
            else:
                if variable_delay:
                    (params, opt_state, arena_state, grad_sum, count,
                     tau_obs) = variable_master_update(state, pod_grads,
                                                       pod_counts, delay,
                                                       b_sched)
                elif shard is not None and state.arena is None:
                    # tau = 0: the rank's rows summed over the pods now
                    grad_sum = _shard_pod_sum(shard, pod_grads)
                    count = torch.sum(pod_counts)
                    params, opt_state = opt.update(
                        state.opt_state, state.params, grad_sum, count,
                        b_sched=b_sched)
                    arena_state = None
                else:
                    params, opt_state, arena_state, grad_sum, count = \
                        arena_master_update(layout, opt, state.params,
                                            state.opt_state, state.arena,
                                            pod_grads, pod_counts,
                                            compression, b_sched=b_sched)
                if shard is not None and shard.ax is not None:
                    # the rank's model blocks of the whole tree
                    from repro_torch.dist.tensor_parallel import cut_params
                    params = cut_params(params, shard.dims, shard.ax)
                # scalar divide after the reduce: the value of norm(g / c)
                sq = torch.sum(torch.square(grad_sum))
                if shard is not None and shard.rows_group is not None:
                    from repro_torch.dist.collectives import all_reduce
                    sq = all_reduce(sq, shard.rows_group,
                                    axis=arena_mod.rows_axis(shard.ranks),
                                    tag="metrics")
                g_norm = torch.sqrt(sq) / torch.clamp(count, min=1e-12)
            local = torch.sum(pod_counts)
            metrics = {
                "loss": torch.sum(pod_loss) / torch.clamp(local, min=1e-12),
                "applied_count": count,
                "local_count": local,
                "grad_norm": g_norm,
                "step": state.step + 1,
            }
            if tau_obs is not None:
                # the staleness the step size used: the ring's cap on
                # a step with no arrival (applied_count == 0 flags it)
                metrics["tau_applied"] = tau_obs
        return TrainState(params=params, opt_state=opt_state, buffer=buffer,
                          arena=arena_state, step=state.step + 1), metrics

    return init_state, train_step
