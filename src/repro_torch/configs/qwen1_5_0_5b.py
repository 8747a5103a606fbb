"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B; hf] — dense MHA with QKV bias."""
from repro_torch.configs.base import DENSE, ModelConfig

FULL = ModelConfig(
    name="qwen1.5-0.5b",
    family=DENSE,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    act="silu",
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke",
    family=DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
    qkv_bias=True,
    tie_embeddings=True,
    act="silu",
)
