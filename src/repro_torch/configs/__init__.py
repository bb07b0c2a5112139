"""Config registry: the architectures the port runs."""

from typing import Dict

from .base import (
    ArchConfig,
    MEMORY_CLASSES,
    MLAConfig,
    MoEConfig,
    ModelSpec,
    SSMConfig,
    ShapeConfig,
    SHAPES,
)
from .gemma3_1b import CONFIG as gemma3_1b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .internlm2_1_8b import CONFIG as internlm2_1_8b
from .mamba2_2_7b import CONFIG as mamba2_2_7b
from .zamba2_1_2b import CONFIG as zamba2_1_2b

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [internlm2_1_8b, gemma3_1b, granite_moe_3b_a800m, mamba2_2_7b,
              zamba2_1_2b]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ArchConfig",
    "MEMORY_CLASSES",
    "ModelSpec",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCHS",
    "get_arch",
]
