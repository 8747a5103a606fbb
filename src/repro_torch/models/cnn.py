"""The paper's CIFAR-10 network (Sec. VI-B), ported from
``repro/models/cnn.py``: 14 layers, 9 conv and 5 fc, with the
cross-entropy loss. It trains on the synthetic image stream
(``data.synthetic.ImageClassStream``).

The leaves keep the JAX names and layouts (``conv{i}_w`` HWIO (3, 3,
cin, cout), ``conv{i}_b``, ``fc{i}_w`` (fin, fout), ``fc{i}_b``), so a
JAX parameter tree carries across as it is (``convert.params_from_jax``).
Images arrive NHWC as in JAX; the forward permutes them once to NCHW for
``conv2d`` and back before the flatten, so the first fc layer reads the
features in JAX's (H, W, C) order. The convolutions and products are
cuDNN and cuBLAS calls on the card: the JAX package runs them outside
any Pallas kernel too. On the card cuDNN runs f32 convolutions in TF32
unless ``torch.backends.cudnn.allow_tf32`` is False; the model leaves
that switch to its caller.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamFactory

_CONV_CHANNELS = [3, 64, 64, 64, 128, 128, 128, 256, 256, 256]  # 9 convs
_FC_WIDTHS = [1024, 512, 256, 128]                              # + n_classes


def init(cfg: ModelConfig, generator, device, with_axes: bool = False) -> Dict:
    """He-initialized conv weights and 1/sqrt(fan_in) fc weights, zero
    biases, drawn in JAX's leaf order from the CPU ``generator``;
    ``with_axes``: (params, their logical axes)."""
    f = ParamFactory(generator, torch.float32, device)
    for i, (cin, cout) in enumerate(zip(_CONV_CHANNELS[:-1],
                                        _CONV_CHANNELS[1:])):
        f.param(f"conv{i}_w", (3, 3, cin, cout), (None, None, None, "mlp"),
                scale=(2.0 / (3 * 3 * cin)) ** 0.5)   # He init
        f.param(f"conv{i}_b", (cout,), ("mlp",), init="zeros")
    widths = [_feature_dim(cfg)] + _FC_WIDTHS + [cfg.n_classes]
    for i, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        f.param(f"fc{i}_w", (fin, fout), ("embed", "mlp"))
        f.param(f"fc{i}_b", (fout,), ("mlp",), init="zeros")
    return (f.params, f.axes) if with_axes else f.params


def _feature_dim(cfg: ModelConfig) -> int:
    side = cfg.image_size // 8       # three 2x pools (after conv 2, 5, 8)
    return 256 * side * side


def forward(params, cfg: ModelConfig, images) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits (B, n_classes)."""
    h = images.permute(0, 3, 1, 2)
    for i in range(9):
        w = params[f"conv{i}_w"].to(h.dtype).permute(3, 2, 0, 1)  # OIHW
        h = F.relu(F.conv2d(h, w, params[f"conv{i}_b"].to(h.dtype),
                            padding=1))           # 3x3 SAME
        if i % 3 == 2:
            h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # JAX's NHWC order
    n_fc = len(_FC_WIDTHS) + 1
    for i in range(n_fc):
        h = h @ params[f"fc{i}_w"].to(h.dtype) + params[f"fc{i}_b"].to(h.dtype)
        if i < n_fc - 1:
            h = F.relu(h)
    return h


def loss(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """batch: {"images": (B, H, W, 3), "labels": (B,), "weights": (B,)}.
    Returns the weighted SUM of the per-sample cross entropy and
    {"count", "loss_sum", "acc_sum"}."""
    images, labels = batch["images"], batch["labels"].long()
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones(images.shape[0], dtype=torch.float32,
                             device=images.device)
    logits = forward(params, cfg, images)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[:, None])[:, 0]
    loss_sum = torch.sum(-ll * weights)
    count = torch.sum(weights)
    acc = torch.sum((torch.argmax(logits, -1) == labels) * weights)
    return loss_sum, {"count": count, "loss_sum": loss_sum, "acc_sum": acc}
