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


def accumulate(rc: RunConfig, loss_fn, params, chunk, n_active):
    """One chunk's (grad_sum, count, metrics) by ``rc.ambdg.anytime_impl``:
    the masked accumulation over every microbatch, or the dynamic trip
    over the first ``n_active`` (None: all)."""
    n_mb = rc.ambdg.n_microbatches
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
        layout = arena_mod.make_layout(model.param_shapes())
        opt = make_arena_optimizer(rc, layout, device)
    else:
        opt = make_optimizer(rc)

    def init_state(generator: Optional[torch.Generator] = None) -> TrainState:
        params = model.init(generator)
        if not use_arena:
            return TrainState(
                params=params, opt_state=opt.init(params),
                buffer=delayed.init_buffer(params, tau, n_pods, compression),
                arena=None,
                step=torch.zeros((), dtype=torch.int32, device=device))
        return TrainState(
            params=params, opt_state=opt.init(), buffer=None,
            arena=arena_mod.init_arena(layout, ring_tau, n_pods,
                                       compression, device=device,
                                       variable=variable_delay),
            step=torch.zeros((), dtype=torch.int32, device=device))

    def pod_chunk_grads(params, batch):
        """Pod-stacked (grads {k: (n_pods, ...)}, counts (n_pods,), loss
        sums (n_pods,)): each pod's chunk of the batch on its own (the
        first ``batch["n_active"]`` microbatches of it under
        "while_dynamic")."""
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
                else:
                    params, opt_state, arena_state, grad_sum, count = \
                        arena_master_update(layout, opt, state.params,
                                            state.opt_state, state.arena,
                                            pod_grads, pod_counts,
                                            compression, b_sched=b_sched)
                # scalar divide after the reduce: the value of norm(g / c)
                g_norm = (torch.sqrt(torch.sum(torch.square(grad_sum)))
                          / torch.clamp(count, min=1e-12))
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
