"""xLSTM 125M [arXiv:2405.04517; unverified] — alternating sLSTM/mLSTM.

12 blocks (d_model 768, 4 heads): every second is an sLSTM block (a
strict recurrence with a gated FFN of int(1.3333333 * d) = 1023), the
rest mLSTM blocks (an up-projection to d_in = 2 d = 1536, heads of 384).
The config's ``head_dim`` (192) is the sLSTM's; the mLSTM's head dim is
``models.xlstm.mlstm_dims``'s. The JAX package's config, letter for
letter.
"""
from repro_torch.configs.base import SSM, ModelConfig, XLSTMConfig

FULL = ModelConfig(
    name="xlstm-125m",
    family=SSM,
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                       # xLSTM blocks carry their own projections
    vocab_size=50304,
    head_dim=192,
    tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=2),
)

SMOKE = ModelConfig(
    name="xlstm-125m-smoke",
    family=SSM,
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    head_dim=32,
    tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=2),
)
