"""qwen1.5-110b [hf:Qwen/Qwen1.5-0.5B family; hf]. Dense GQA + QKV bias.

A copy of the JAX package's config of the same name.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49_152,
    vocab=152_064,
    qkv_bias=True,
)
