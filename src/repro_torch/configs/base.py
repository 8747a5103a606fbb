"""Config system of the PyTorch port.

The port's own copy of ``repro/configs/base.py``: the same frozen
dataclasses, with the same fields and defaults, so that a ``RunConfig``
built from either package describes the same run. The port imports
nothing of the JAX package, this module included.

The port reads a subset of the knobs; every knob it does not carry yet
raises ``NotImplementedError`` where it would be consumed (see
``core/ambdg.py``, ``core/strategy.py`` and ``train/loop.py``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"          # xLSTM-style (mLSTM/sLSTM blocks)
HYBRID = "hybrid"    # zamba2: mamba2 backbone + shared attention
ENCDEC = "encdec"    # seamless: encoder-decoder
VLM = "vlm"          # paligemma: patch-embedding stub + prefix-LM decoder
LINREG = "linreg"    # paper's own linear-regression experiment
CNN = "cnn"          # paper's own CIFAR-style CNN experiment

LM_FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM)
# the MoE dispatch routes (``models/moe.py``); JAX runs einsum for any
# other name, the port raises
MOE_IMPLS = ("einsum", "gather")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    dispatch_group: int = 4096


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD parameters (used by hybrid + ssm families)."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block layout: which layer indices are sLSTM (rest mLSTM)."""
    slstm_every: int = 2
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333333
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # defaults to d_model // n_heads
    # --- attention flavour ---
    rope_theta: float = 10000.0
    rope_partial: float = 1.0
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    prefix_lm: bool = False
    logit_softcap: Optional[float] = None
    # --- ffn / norms ---
    act: str = "silu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- family-specific ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    shared_attn_every: int = 0
    n_encoder_layers: int = 0
    cross_attention: bool = False
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0
    # --- paper's own problems ---
    linreg_dim: int = 0
    image_size: int = 0
    n_classes: int = 0
    # --- implementation knobs (perf levers, not architecture) ---
    # "einsum" (the dense one-hot capacity dispatch) | "gather" (the
    # scatter/gather routing); both drop the same assignments
    moe_impl: str = "einsum"
    # "xla" (plain PyTorch attention, the JAX model's gqa_attend) |
    # "flash" (the port's CUDA flash-attention kernels on the card)
    attn_impl: str = "xla"
    # "xla" (the plain chunked SSD scan, the JAX model's ssd_chunked) |
    # "kernel" (the port's CUDA linear-scan kernel on the card)
    scan_impl: str = "xla"
    scan_unroll: bool = False
    seq_parallel: bool = False
    block_remat: str = "full"
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256, as in the JAX package:
        the embedding and the logits cover the padded range; real token
        ids never index the pad."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        """Does this arch admit an O(1)/O(window) per-token decode state?"""
        if self.family in (SSM, HYBRID):
            return True
        return self.sliding_window is not None

    def n_params(self) -> int:
        """Analytic parameter count, as the JAX package counts it (every
        expert; the unpadded vocab; qk-norm scales, the Mamba2 conv bias
        and dt bias not counted; for the xLSTM, JAX's formula, which is
        not its leaves' count, ROADMAP C.15; for the CNN, JAX's count of
        a smaller net than the one it builds; for the ENCDEC, no
        frame_proj, and for the VLM, the stub as its n_frontend_tokens
        positions, C.17)."""
        return _count_params(self)

    def n_active_params(self) -> int:
        """Parameters touched per token (MOE: only the routed experts)."""
        return _count_params(self, active_only=True)


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    if cfg.family == LINREG:
        return cfg.linreg_dim
    if cfg.family == CNN:
        return _cnn_param_count(cfg)
    if cfg.family not in LM_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
    if cfg.qkv_bias:
        attn += (nq + 2 * nkv) * hd
    emb = cfg.vocab_size * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    total = emb + head + d
    if cfg.family in (DENSE, VLM):
        total += cfg.n_layers * (attn + 3 * d * cfg.d_ff + 2 * d)
        # JAX counts the VLM's stub as its positional table's rows alone
        # (the model builds patch_proj (d, d) and patch_pos (P, d):
        # ROADMAP C.17)
        return total + (cfg.n_frontend_tokens if cfg.frontend else 0)
    if cfg.family == ENCDEC:
        # JAX leaves out frame_proj (d, d), which the model builds (C.17)
        enc = attn + 3 * d * cfg.d_ff + 2 * d
        dec = 2 * attn + 3 * d * cfg.d_ff + 3 * d
        return (total + cfg.n_encoder_layers * enc + cfg.n_layers * dec
                + d)        # the encoder's final norm
    if cfg.family == MOE:
        m = cfg.moe
        n_used = m.top_k if active_only else m.n_experts
        moe_ffn = d * m.n_experts + n_used * 3 * d * cfg.d_ff
        return total + cfg.n_layers * (attn + moe_ffn + 2 * d)
    if cfg.family == SSM:
        # JAX's formula, which counts 8 d^2 for the sLSTM gates (the
        # model has w_x and a block-diagonal w_h) and 2 d_in for the
        # mLSTM gates (the model has w_i, w_f of (d_in, n_heads) and their
        # biases): more than the leaves the model builds (ROADMAP C.15)
        x = cfg.xlstm
        d_in_m = int(x.proj_factor_mlstm * d)
        n_sl = cfg.n_layers // x.slstm_every
        n_ml = cfg.n_layers - n_sl
        mlstm = (d * 2 * d_in_m + 3 * d_in_m * d_in_m + 2 * d_in_m
                 + d_in_m * d + 2 * d)
        slstm = 8 * d * d + 3 * d * int(x.proj_factor_slstm * d) + 2 * d
        return total + n_ml * mlstm + n_sl * slstm
    s = cfg.ssm
    d_in = s.expand * d
    nh = d_in // s.head_dim
    mamba2 = (d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
              + s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
              + d_in * d + 2 * nh + d_in)
    # one shared attention + MLP block, counted once
    return (total + cfg.n_layers * (mamba2 + 2 * d)
            + attn + 3 * d * cfg.d_ff + 2 * d)


def _cnn_param_count(cfg: ModelConfig) -> int:
    """The JAX package's CNN count, kept as it is: "6 conv layers + 3
    fc", which is not the network ``models/cnn.py`` builds (9 convs and
    5 fc: 6,805,642 parameters at FULL; ROADMAP C.10)."""
    chans = [3, 64, 64, 128, 128, 256, 256]
    total = 0
    for cin, cout in zip(chans[:-1], chans[1:]):
        total += 3 * 3 * cin * cout + cout
    feat = 256 * (cfg.image_size // 8) * (cfg.image_size // 8)
    for fin, fout in [(feat, 512), (512, 128), (128, cfg.n_classes)]:
        total += fin * fout + fout
    return total


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# AMB-DG technique knobs (paper Sec. III)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AmbdgConfig:
    # Timeline (paper): compute epoch T_p, round-trip T_c, staleness tau.
    t_p: float = 2.5
    t_c: float = 10.0
    tau: int = 1
    # Microbatches a shard accumulates per epoch; the anytime weights
    # mask the samples a worker did not finish.
    n_microbatches: int = 4
    # "scan_masked" (the port's only mode: a Python loop over every
    # microbatch) | "while_dynamic" (not ported yet)
    anytime_impl: str = "scan_masked"
    # Dual averaging step size: alpha(t)^-1 = L + sqrt((t+tau)/b_bar)
    smoothness_L: float = 1.0
    b_bar: float = 600.0
    # Proximal psi: "l2" (psi = 0.5||w||^2) or "l2_ball" (radius C)
    proximal: str = "l2"
    radius_C: float = 0.0
    # Cross-pod gradient compression: "none" | "int8"
    pod_compression: str = "none"
    # K-batch baseline: the master updates on every K-th arriving message
    kbatch_K: int = 10

    @property
    def staleness(self) -> int:
        """tau = ceil(T_c / T_p), the paper's deterministic delay."""
        return max(int(math.ceil(self.t_c / self.t_p)), 0)


@dataclass(frozen=True)
class DelayConfig:
    """Staleness process of the cross-pod exchange (``core.delay_process``).
    ``"fixed"`` keeps tau_t = tau on the static ring; a stochastic
    process (jitter, heavy_tail, bursty) draws tau_t per step within
    ``[delay_min, tau_max]`` on the delay-tolerant ring, with the
    delay-adaptive step size unless ``adaptive_alpha`` is False."""
    process: str = "fixed"      # fixed | jitter | heavy_tail | bursty
    tau_max: int = 0
    delay_min: int = 1
    jitter: int = 1
    tail_alpha: float = 1.1
    p_burst: float = 0.1
    p_exit: float = 0.3
    seed: int = 0
    adaptive_alpha: bool = True


@dataclass(frozen=True)
class ElasticConfig:
    """Elastic-worker process (``core.worker_process``): ``"static"``
    keeps every worker alive at speed 1.0."""
    process: str = "static"   # static | heterogeneous | churn | crash_restart
    speed_sigma: float = 0.5
    speed_min: float = 0.05
    p_fail: float = 0.05
    p_recover: float = 0.5
    mttf: float = 50.0
    mttr: float = 5.0
    seed: int = 0


@dataclass(frozen=True)
class BatchScheduleConfig:
    """Adaptive minibatch schedule b(t) (``core.batch_schedule``):
    ``"fixed"`` keeps the timing-driven anytime target."""
    schedule: str = "fixed"   # fixed | linear | adadamp | delay_aware
    b0: int = 0
    b_min: int = 1
    b_cap: int = 0
    growth_rate: float = 1.0
    growth_factor: float = 2.0
    ema: float = 0.3
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    """Train-while-serve: the continuous-batching engine fed by
    staleness-bounded weight publication (``repro_torch.serve``).

      * ``slots``/``max_len``/``max_new`` size the engine: ``slots``
        sequences share one fixed-slot KV / recurrent cache of depth
        ``max_len``; finished sequences are evicted and new requests
        admitted every decode step (``serve/engine.py``).
      * ``arrival`` names the seeded request arrival process
        (``serve/request_queue.py``): "poisson" draws
        Poisson(``arrival_rate``) requests a decode step, "bursty" a
        Gilbert-Elliott chain with Poisson(``burst_rate``) inside a
        burst; prompts have seeded lengths in [prompt_len_min,
        prompt_len_max].
      * every ``publish_period`` master steps the train loop pushes a
        ``w = -alpha z`` snapshot into the publish ring (int8 rows with
        bf16 scales, ``serve/publisher.py``); servers pop the freshest
        snapshot at most ``staleness_bound`` master steps old.
        ``publish_period = 0`` turns the channel off.
    """
    slots: int = 4
    max_len: int = 128
    max_new: int = 16
    # master steps between published snapshots; 0 = channel off
    publish_period: int = 0
    # the largest age (master steps) of a servable snapshot; ring depth
    # staleness_bound // publish_period + 1
    staleness_bound: int = 4
    arrival: str = "poisson"    # poisson | bursty
    arrival_rate: float = 0.5   # mean new requests a decode step
    burst_rate: float = 4.0     # "bursty": the rate inside a burst
    p_burst: float = 0.1        # "bursty": P(normal -> burst) a step
    p_exit: float = 0.3         # "bursty": P(burst -> normal) a step
    prompt_len_min: int = 4
    prompt_len_max: int = 12
    seed: int = 0


@dataclass(frozen=True)
class ConsensusConfig:
    """Decentralized AMB-DG (paper Sec. V): gossip-consensus knobs.

    Workers exchange messages through a doubly-stochastic matrix Q for
    ``rounds`` gossip rounds an epoch; ``rounds=0`` derives the count
    from eq. (24) with (delta, msg_norm_J) and lambda_2(Q).
    """
    topology: str = "ring"        # "ring" | "torus" | "complete"
    n_workers: int = 8
    delta: float = 0.05           # consensus-error target of eq. (24)
    msg_norm_J: float = 1.0       # message-norm bound J of eq. (24)
    rounds: int = 0               # 0 = derive from eq. (24)
    # "dense" folds the stacked messages in one process; "shard_map" runs
    # one worker a rank of an initialised torch.distributed world of
    # n_workers ranks (each term a point-to-point exchange); "auto" picks
    # it exactly when such a world is initialised, else "dense"
    gossip_impl: str = "auto"
    # "none" exchanges f32 messages; "int8" quantizes each round's
    # message per row with bf16 scales and carries the error in
    # DecentralizedState.residual
    compression: str = "none"
    # also return the pre-gossip messages ("gossip_m0", "gossip_r0")
    # in the step's metrics, for an oracle to fold again; keep False in
    # training loops (their metrics are scalars)
    debug_messages: bool = False


@dataclass(frozen=True)
class MeshConfig:
    n_pods: int = 1
    data: int = 16
    model: int = 16

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (("pod", "data", "model") if self.n_pods > 1
                else ("data", "model"))

    @property
    def shape(self) -> Tuple[int, ...]:
        return ((self.n_pods, self.data, self.model) if self.n_pods > 1
                else (self.data, self.model))

    @property
    def n_devices(self) -> int:
        return self.n_pods * self.data * self.model


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    ambdg: AmbdgConfig = field(default_factory=AmbdgConfig)
    # "ambdg" | "amb" | "kbatch" | "decentralized"
    strategy: str = "ambdg"
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    delay: DelayConfig = field(default_factory=DelayConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    batch_schedule: BatchScheduleConfig = field(default_factory=BatchScheduleConfig)
    optimizer: str = "dual_averaging"
    remat: str = "none"
    # "arena" (the port's only master pipeline) | "pytree" (not ported)
    master_impl: str = "arena"
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
