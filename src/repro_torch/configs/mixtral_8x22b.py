"""Mixtral 8x22B [arXiv:2401.04088; hf] — MoE 8 experts top-2, SWA."""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="mixtral-8x22b",
    family=MOE,
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1e6,
    sliding_window=4096,
    act="silu",
    moe=MoEConfig(n_experts=8, top_k=2, dispatch_group=2048),
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family=MOE,
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    head_dim=16,
    sliding_window=32,
    act="silu",
    moe=MoEConfig(n_experts=4, top_k=2),
)
