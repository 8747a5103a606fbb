"""Yi-6B [arXiv:2403.04652; hf] — llama-arch GQA kv=4."""
from repro_torch.configs.base import DENSE, ModelConfig

FULL = ModelConfig(
    name="yi-6b",
    family=DENSE,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5e6,
    act="silu",
)

SMOKE = ModelConfig(
    name="yi-6b-smoke",
    family=DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
    act="silu",
)
