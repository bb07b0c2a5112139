"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b; unverified]. Dense MHA.

A copy of the JAX package's config of the same name.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100_352,
)
