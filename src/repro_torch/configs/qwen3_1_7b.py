"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family; hf] — qk_norm, GQA kv=8."""
from repro_torch.configs.base import DENSE, ModelConfig

FULL = ModelConfig(
    name="qwen3-1.7b",
    family=DENSE,
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=True,
    act="silu",
)

SMOKE = ModelConfig(
    name="qwen3-1.7b-smoke",
    family=DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
    qk_norm=True,
    tie_embeddings=True,
    act="silu",
)
