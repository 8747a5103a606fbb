"""The paper's CIFAR-10 CNN experiment (Sec. VI-B), offline stand-in.

The paper trains a 14-layer conv/fc net on CIFAR-10 over n = 4 workers
with induced T_c = 10 s, T_p = 10 s. Offline the same net shape trains
on a synthetic 32x32x3 10-class stream (``data.synthetic.
ImageClassStream``).
"""
from repro_torch.configs.base import CNN, ModelConfig

FULL = ModelConfig(
    name="amb-cnn",
    family=CNN,
    n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    image_size=32,
    n_classes=10,
)

SMOKE = ModelConfig(
    name="amb-cnn-smoke",
    family=CNN,
    n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    image_size=16,
    n_classes=10,
)
