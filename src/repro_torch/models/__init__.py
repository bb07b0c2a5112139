"""Model assembly on torch tensors (pure full-attention stacks)."""

from .transformer import (
    decode_step,
    decode_step_paged,
    init_cache,
    init_model,
    paged_decode_supported,
    prefill,
    resolve_device,
)

__all__ = [
    "decode_step",
    "decode_step_paged",
    "init_cache",
    "init_model",
    "paged_decode_supported",
    "prefill",
    "resolve_device",
]
