"""The paper's own linear-regression problem (Sec. VI-A).

d = 10^4, noise sigma^2 = 1e-3, n = 10 workers, shifted-exponential
compute model (lambda=2/3, xi=1), T_p = 2.5, T_c = 10 => tau = 4.
"""
from repro_torch.configs.base import LINREG, ModelConfig

FULL = ModelConfig(
    name="amb-linreg",
    family=LINREG,
    n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    linreg_dim=10_000,
)

SMOKE = ModelConfig(
    name="amb-linreg-smoke",
    family=LINREG,
    n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    linreg_dim=128,
)
