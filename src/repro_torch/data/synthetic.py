"""Synthetic data streams (the paper's linear regression, its CNN's
image stand-in for CIFAR-10, and the LM token stream with the VLM's and
the encoder-decoder's stub inputs), seeded numpy: the
same bytes as the JAX package's ``repro/data/synthetic.py`` for the same
seed and cursor, so both frameworks train on identical batches.

Streams are deterministic functions of (seed, cursor), so a restart
resumes a stream exactly from its ``state_dict``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import CNN, ENCDEC, LINREG, VLM, ModelConfig


@dataclass
class LinRegStream:
    """Paper Sec. VI-A: zeta ~ N(0,I_d); y = zeta^T w* + eps,
    eps ~ N(0, 1e-3). ``seed`` fixes the problem (w*); ``sample_seed``
    fixes the stream."""
    dim: int
    seed: int = 0
    sample_seed: Optional[int] = None
    noise_var: float = 1e-3

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.w_star = rng.standard_normal(self.dim).astype(np.float32)
        if self.sample_seed is None:
            self.sample_seed = self.seed
        self._cursor = 0

    def next_batch(self, n: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.sample_seed + 1, self._cursor))
        self._cursor += 1
        x = rng.standard_normal((n, self.dim)).astype(np.float32)
        noise = (self.noise_var ** 0.5) * rng.standard_normal(n)
        y = (x @ self.w_star + noise).astype(np.float32)
        return {"x": x, "y": y,
                "weights": np.ones((n,), np.float32)}

    def state_dict(self):
        return {"cursor": self._cursor}

    def load_state_dict(self, s):
        self._cursor = int(s["cursor"])


@dataclass
class ImageClassStream:
    """Synthetic stand-in for CIFAR-10 (Sec. VI-B): class-conditional
    Gaussian blobs, so training learns something measurable. ``seed``
    fixes the class prototypes; ``sample_seed`` the stream."""
    image_size: int = 32
    n_classes: int = 10
    seed: int = 0
    sample_seed: Optional[int] = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.prototypes = rng.standard_normal(
            (self.n_classes, self.image_size, self.image_size, 3)
        ).astype(np.float32)
        if self.sample_seed is None:
            self.sample_seed = self.seed
        self._cursor = 0

    def next_batch(self, n: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.sample_seed + 1, self._cursor))
        self._cursor += 1
        labels = rng.integers(0, self.n_classes, size=n)
        noise = rng.standard_normal(
            (n, self.image_size, self.image_size, 3)).astype(np.float32)
        images = 0.5 * self.prototypes[labels] + noise
        return {"images": images, "labels": labels.astype(np.int32),
                "weights": np.ones((n,), np.float32)}

    def state_dict(self):
        return {"cursor": self._cursor}

    def load_state_dict(self, s):
        self._cursor = int(s["cursor"])


@dataclass
class TokenStream:
    """Synthetic LM token stream: Zipf(1.3) token ids clipped to the
    vocab, so the loss has structure, with the VLM's and the encoder-
    decoder's stub inputs: ``patches`` (batch, n_frontend_tokens, d) in
    front of a text of seq - n_frontend_tokens tokens, and ``frames``
    (batch, seq, d), standard normal, drawn after the tokens from the
    same generator (JAX's ``TokenStream``, draw for draw)."""
    cfg: ModelConfig
    seed: int = 0
    sample_seed: Optional[int] = None

    def __post_init__(self):
        if self.sample_seed is None:
            self.sample_seed = self.seed
        self._cursor = 0

    def next_batch(self, batch: int, seq: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.sample_seed + 1, self._cursor))
        self._cursor += 1
        cfg = self.cfg
        n_text = seq - cfg.n_frontend_tokens if cfg.family == VLM else seq
        z = rng.zipf(1.3, size=(batch, n_text))
        tokens = np.minimum(z, cfg.vocab_size - 1).astype(np.int32)
        out = {"tokens": tokens, "weights": np.ones((batch,), np.float32)}
        if cfg.family == VLM:
            out["patches"] = rng.standard_normal(
                (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == ENCDEC:
            out["frames"] = rng.standard_normal(
                (batch, seq, cfg.d_model)).astype(np.float32)
        return out

    def state_dict(self):
        return {"cursor": self._cursor}

    def load_state_dict(self, s):
        self._cursor = int(s["cursor"])


def make_stream(cfg: ModelConfig, seed: int = 0,
                sample_seed: Optional[int] = None):
    if cfg.family == LINREG:
        return LinRegStream(cfg.linreg_dim, seed, sample_seed)
    if cfg.family == CNN:
        return ImageClassStream(cfg.image_size, cfg.n_classes, seed,
                                sample_seed)
    return TokenStream(cfg, seed, sample_seed)
