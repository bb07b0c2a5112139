"""Model assembly on torch tensors: attention stacks with dense or MoE FFNs,
and Mamba-2 stacks with or without zamba2's shared attention."""

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
