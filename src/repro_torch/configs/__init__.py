"""Config registry: the architectures the port runs (the JAX package's
ten, copied)."""

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
from .deepseek_v2_236b import CONFIG as deepseek_v2_236b
from .gemma3_1b import CONFIG as gemma3_1b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .internlm2_1_8b import CONFIG as internlm2_1_8b
from .internvl2_26b import CONFIG as internvl2_26b
from .mamba2_2_7b import CONFIG as mamba2_2_7b
from .qwen1_5_110b import CONFIG as qwen1_5_110b
from .stablelm_1_6b import CONFIG as stablelm_1_6b
from .whisper_base import CONFIG as whisper_base
from .zamba2_1_2b import CONFIG as zamba2_1_2b

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        granite_moe_3b_a800m,
        deepseek_v2_236b,
        internlm2_1_8b,
        stablelm_1_6b,
        gemma3_1b,
        qwen1_5_110b,
        internvl2_26b,
        whisper_base,
        mamba2_2_7b,
        zamba2_1_2b,
    ]
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
