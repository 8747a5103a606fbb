"""Mixtral 8x7B [arXiv:2401.04088; hf] — MoE 8 experts top-2, SWA."""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    family=MOE,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1e6,
    sliding_window=4096,
    act="silu",
    moe=MoEConfig(n_experts=8, top_k=2),
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    family=MOE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    sliding_window=32,
    act="silu",
    moe=MoEConfig(n_experts=4, top_k=2),
)
