"""ChatGLM3-6B [arXiv:2406.12793; hf] — 2d (partial) RoPE, GQA kv=2."""
from repro_torch.configs.base import DENSE, ModelConfig

FULL = ModelConfig(
    name="chatglm3-6b",
    family=DENSE,
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    rope_partial=0.5,       # 2d RoPE: rotate half of each head dim
    qkv_bias=True,          # chatglm uses bias on qkv
    act="silu",
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke",
    family=DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
    rope_partial=0.5,
    qkv_bias=True,
    act="silu",
)
