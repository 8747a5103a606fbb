"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

The port registers every architecture of the JAX package's zoo: the
paper's linear regression and CNN, the four DENSE transformers, the
HYBRID zamba2 (Mamba2 layers with a shared attention block), the two
MOE mixtrals (top-2 experts, a sliding window), the SSM xLSTM (mLSTM
and sLSTM blocks), the ENCDEC seamless-m4t-large-v2 (a bidirectional
encoder over stub frames, a decoder with cross-attention) and the VLM
paligemma-3b (stub patches in front of a prefix-LM decoder). Each module
exposes ``FULL`` (the published config) and ``SMOKE`` (a reduced
same-family config for the CPU tests).
"""
from __future__ import annotations

from repro_torch.configs import (amb_cnn, amb_linreg, chatglm3_6b,
                                 mixtral_8x7b, mixtral_8x22b, paligemma_3b,
                                 qwen1_5_0_5b, qwen3_1_7b,
                                 seamless_m4t_large_v2, xlstm_125m, yi_6b,
                                 zamba2_2_7b)
from repro_torch.configs.base import (  # noqa: F401
    CNN, DENSE, ENCDEC, HYBRID, LINREG, LM_FAMILIES, MOE, SSM, VLM,
    AmbdgConfig, BatchScheduleConfig, ConsensusConfig, DelayConfig,
    ElasticConfig, MeshConfig, ModelConfig, MoEConfig, RunConfig,
    ServeConfig, ShapeConfig, TRAIN_4K)

_MODULES = {
    "mixtral-8x7b": mixtral_8x7b,
    "mixtral-8x22b": mixtral_8x22b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "yi-6b": yi_6b,
    "chatglm3-6b": chatglm3_6b,
    "qwen3-1.7b": qwen3_1_7b,
    "zamba2-2.7b": zamba2_2_7b,
    "xlstm-125m": xlstm_125m,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "paligemma-3b": paligemma_3b,
    "amb-linreg": amb_linreg,
    "amb-cnn": amb_cnn,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows "
                       f"{sorted(_MODULES)}")
    return _MODULES[arch].FULL


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows "
                       f"{sorted(_MODULES)}")
    return _MODULES[arch].SMOKE
