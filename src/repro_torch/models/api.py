"""Unified model API of the port.

``build_model(cfg, device)`` returns a ``Model`` with the JAX package's
interface (``repro/models/api.py``), so the strategies never special-
case architectures:

    params         = model.init(generator)
    loss_sum, aux  = model.loss(params, batch)       # SUM + counts
    shapes         = model.param_shapes()             # on "meta"
    shapes         = model.whole_param_shapes()       # whatever the mesh
    axes           = model.param_axes()               # logical axes
    shapes         = model.input_shapes(batch, seq)   # LM batch shapes
    batch          = model.dummy_batch(batch_size, seq_len, generator)
    cache, caxes   = model.init_decode_state(batch, max_len)
    logits, cache  = model.decode_step(params, cache, tokens, pos)

``params`` is a nested dict of tensors on ``model.device``. Families:
the paper's linear regression (an ``nn.Module`` evaluated at the given
tensors through ``functional_call``), the paper's CNN (``models.cnn``),
the DENSE transformers, the MOE mixtrals, the SSM xLSTM, the HYBRID
zamba2 and the VLM paligemma (``models.transformer``, functions over
the tree), and the ENCDEC seamless-m4t (``models.encdec``). The decode
path (``init_decode_state``, ``decode_step``) serves the LM families.

Under an active mesh with ``model > 1`` (``launch.mesh``; every LM
family) ``init``, ``param_shapes`` and ``loss`` work on the rank's
blocks of the parameters (``dist.tensor_parallel``); ``dummy_batch``
stays the global batch. Under an active mesh ``init_decode_state`` gives
the rank's block of the decode cache on the serve profile's layout (its
rows of the slots where ``data`` splits them, its heads at ``model >
1``), ``decode_step`` takes the rank's rows of the tokens and positions
and, at ``model > 1``, returns the rank's vocab block of the logits
(``tensor_parallel.vocab_argmax`` takes their argmax over every rank's).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import (CNN, DENSE, ENCDEC, HYBRID, LINREG,
                                      MOE, SSM, VLM, ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import linear as linear_mod
from repro_torch.models import transformer as tf_mod


# the LM families: the transformer's, and the encoder-decoder
_LM = (DENSE, HYBRID, MOE, SSM, VLM, ENCDEC)
_META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    # (device, CPU generator or None) -> params on that device
    init_fn: Callable[[torch.device, Optional[torch.Generator]], Dict]
    loss_fn: Callable[[Dict, Dict], tuple]
    # () -> the logical-axes tree of ``init``'s tree
    axes_fn: Callable[[], Dict]

    def init(self, generator: Optional[torch.Generator] = None) -> Dict:
        return self.init_fn(self.device, generator)

    def param_shapes(self) -> Dict:
        """The parameter tree on the ``meta`` device: shapes and dtypes,
        no memory and no draws (JAX's ``eval_shape`` of ``init``); the
        rank's blocks under an active mesh with ``model > 1``."""
        return self.init_fn(torch.device("meta"), None)

    def whole_param_shapes(self) -> Dict:
        """``param_shapes`` of the whole tree, whatever mesh is active:
        the arena's rows are laid out from it."""
        from repro_torch.dist.context import sharding_profile
        with sharding_profile(None):
            return self.param_shapes()

    def param_axes(self) -> Dict:
        """Each leaf's logical sharding axes (``models.common``), the
        tree of JAX's ``shapes_and_axes(model.init)``; the same names for
        a rank's blocks under tensor parallelism."""
        return self.axes_fn()

    def input_shapes(self, batch: int, seq: int) -> Dict:
        """The shapes of an LM batch's leaves (JAX's ``input_specs``):
        tokens, weights, the VLM's ``patches``, the encoder-decoder's
        ``frames``."""
        cfg = self.cfg
        if cfg.family not in _LM:
            raise NotImplementedError(
                f"input_shapes is for the LM families, not {cfg.family!r} "
                "(as JAX's input_specs)")
        n_text = seq - cfg.n_frontend_tokens if cfg.family == VLM else seq
        out = {"tokens": (batch, n_text), "weights": (batch,)}
        if cfg.family == VLM:
            out["patches"] = (batch, cfg.n_frontend_tokens, cfg.d_model)
        if cfg.family == ENCDEC:
            out["frames"] = (batch, seq, cfg.d_model)
        return out

    def loss(self, params: Dict, batch: Dict):
        return self.loss_fn(params, batch)

    def dummy_batch(self, batch: int, seq: int,
                    generator: Optional[torch.Generator] = None) -> Dict:
        """Random tokens (LM families; with the VLM's ``patches`` (batch,
        n_frontend_tokens, d) in front of seq - n_frontend_tokens text
        tokens, the encoder-decoder's ``frames`` (batch, seq, d)) or
        images and labels (the CNN; ``seq`` unused) on the model's
        device."""
        if self.cfg.family == LINREG:
            raise NotImplementedError("dummy_batch is for the LM families "
                                      "and the CNN; the linear regression "
                                      "draws from data.synthetic."
                                      "LinRegStream")
        ones = torch.ones((batch,), dtype=torch.float32, device=self.device)
        if self.cfg.family == CNN:
            side = self.cfg.image_size
            images = torch.randn((batch, side, side, 3), generator=generator)
            labels = torch.randint(0, self.cfg.n_classes, (batch,),
                                   generator=generator, dtype=torch.int32)
            return {"images": images.to(self.device),
                    "labels": labels.to(self.device), "weights": ones}
        cfg = self.cfg
        n_text = seq - cfg.n_frontend_tokens if cfg.family == VLM else seq
        tokens = torch.randint(0, cfg.vocab_size, (batch, n_text),
                               generator=generator, dtype=torch.int32)
        out = {"tokens": tokens.to(self.device), "weights": ones}
        if cfg.family == VLM:
            out["patches"] = torch.randn(
                (batch, cfg.n_frontend_tokens, cfg.d_model),
                generator=generator).to(self.device)
        if cfg.family == ENCDEC:
            out["frames"] = torch.randn((batch, seq, cfg.d_model),
                                        generator=generator).to(self.device)
        return out

    def _decoder(self):
        """The module of the family's decode path."""
        if self.cfg.family not in _LM:
            raise NotImplementedError(
                f"model family {self.cfg.family!r} has no decode path")
        return encdec_mod if self.cfg.family == ENCDEC else tf_mod

    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16):
        """(the decode cache on the model's device, its logical-axes
        tree) for ``batch`` slots of ``max_len`` positions (the LM
        families; KV entries in ``dtype``); under an active mesh the
        rank's block of it."""
        return self._decoder().init_decode_state(self.cfg, batch, max_len,
                                                 dtype, self.device)

    def decode_step(self, params: Dict, cache: Dict, tokens, pos):
        """One token for every slot: (logits (B, 1, padded vocab), the
        cache, updated in place); under an active mesh B is the rank's
        rows of the cache and, at ``model > 1``, the logits its vocab
        block (B, 1, padded vocab / model)."""
        return self._decoder().decode_step(params, self.cfg, cache, tokens,
                                           pos)


def _seeded_init(init):
    """``init(device, generator)`` with a CPU generator seeded 0 where
    the caller gives none (none is drawn from on the meta device)."""
    def init_fn(device, generator):
        if generator is None and device.type != "meta":
            generator = torch.Generator().manual_seed(0)
        return init(device, generator)
    return init_fn


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model for ``cfg`` on ``device`` ("cuda" unless the caller
    asks for the CPU; raises when CUDA is asked for and absent)."""
    device = resolve_device(device)
    if cfg.family == LINREG:
        module = linear_mod.LinearRegression(cfg, device)
        # w(1) = 0 in the paper: the generator draws nothing
        return Model(cfg, device,
                     init_fn=lambda dev, generator=None:
                         linear_mod.init(cfg, dev),
                     loss_fn=lambda p, b: torch.func.functional_call(
                         module, p, (b,)),
                     axes_fn=lambda: dict(linear_mod.AXES))
    if cfg.family == ENCDEC:
        encdec_mod.check_supported(cfg)
        return Model(cfg, device, init_fn=_seeded_init(
                         lambda dev, gen: encdec_mod.init(cfg, gen, dev)),
                     loss_fn=lambda p, b: encdec_mod.loss(p, cfg, b),
                     axes_fn=lambda: encdec_mod.init(cfg, None, _META,
                                                     with_axes=True)[1])
    if cfg.family in _LM:
        tf_mod.check_supported(cfg)
        return Model(cfg, device, init_fn=_seeded_init(
                         lambda dev, gen: tf_mod.init(cfg, gen, dev)),
                     loss_fn=lambda p, b: tf_mod.lm_loss(p, cfg, b),
                     axes_fn=lambda: tf_mod.init(cfg, None, _META,
                                                 with_axes=True)[1])
    if cfg.family == CNN:
        return Model(cfg, device, init_fn=_seeded_init(
                         lambda dev, gen: cnn_mod.init(cfg, gen, dev)),
                     loss_fn=lambda p, b: cnn_mod.loss(p, cfg, b),
                     axes_fn=lambda: cnn_mod.init(cfg, None, _META,
                                                  with_axes=True)[1])
    raise ValueError(f"unknown model family {cfg.family!r}")
