"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf] — encoder-decoder, audio stub.

The w2v-BERT speech frontend is a stub: the batch carries precomputed
frame embeddings (B, S_src, d_model). Backbone: 24-layer bidirectional
encoder + 24-layer text decoder with cross-attention, d=1024, 16 heads
of 64 (MHA), d_ff=8192, vocab 256206. The JAX package's config, letter
for letter.
"""
from repro_torch.configs.base import ENCDEC, ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family=ENCDEC,
    n_layers=24,               # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    cross_attention=True,
    frontend="w2vbert_stub",
    act="gelu",
)

SMOKE = ModelConfig(
    name="seamless-m4t-large-v2-smoke",
    family=ENCDEC,
    n_layers=2,
    n_encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
    cross_attention=True,
    frontend="w2vbert_stub",
    act="gelu",
)
