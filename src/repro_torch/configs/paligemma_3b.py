"""PaliGemma-3B [arXiv:2407.07726; hf] — SigLIP stub + gemma decoder.

The image frontend is a stub: the batch carries precomputed patch
embeddings (256 patches at 224px/14px patching), which a learned
``patch_proj`` and ``patch_pos`` place in front of the text. The
backbone is the gemma-2b decoder: 18 layers, d=2048, MQA (one kv head),
head_dim 256, GeGLU d_ff=16384, vocab 257216, tied embeddings,
prefix-LM attention over the image prefix. The JAX package's config,
letter for letter.
"""
from repro_torch.configs.base import VLM, ModelConfig

FULL = ModelConfig(
    name="paligemma-3b",
    family=VLM,
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    act="gelu",
    prefix_lm=True,
    tie_embeddings=True,
    frontend="siglip_stub",
    n_frontend_tokens=256,
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke",
    family=VLM,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    act="gelu",
    prefix_lm=True,
    tie_embeddings=True,
    frontend="siglip_stub",
    n_frontend_tokens=16,
)
