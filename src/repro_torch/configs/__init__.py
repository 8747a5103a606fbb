"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

The port registers the architectures it can train; the rest of the JAX
package's zoo follows in later slices (ROADMAP A).
"""
from __future__ import annotations

from repro_torch.configs import amb_linreg
from repro_torch.configs.base import (  # noqa: F401
    CNN, DENSE, ENCDEC, HYBRID, LINREG, LM_FAMILIES, MOE, SSM, VLM,
    AmbdgConfig, BatchScheduleConfig, ConsensusConfig, DelayConfig,
    ElasticConfig, MeshConfig, ModelConfig, RunConfig, ServeConfig,
    ShapeConfig, TRAIN_4K)

_MODULES = {
    "amb-linreg": amb_linreg,
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
