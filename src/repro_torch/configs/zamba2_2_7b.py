"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attn.

54 Mamba2 layers (d_model 2560, ssm_state 64); one *shared* full
attention+MLP block (32 heads, d_ff 10240) interleaved every 6 layers.
Zamba2's per-invocation LoRA on the shared block is omitted, as in the
JAX package's config.
"""
from repro_torch.configs.base import HYBRID, ModelConfig, SSMConfig

FULL = ModelConfig(
    name="zamba2-2.7b",
    family=HYBRID,
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    act="gelu",
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    family=HYBRID,
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    shared_attn_every=2,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=32),
    act="gelu",
)
