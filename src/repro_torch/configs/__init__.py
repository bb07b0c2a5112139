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
from .internlm2_1_8b import CONFIG as internlm2_1_8b

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [internlm2_1_8b]}


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
