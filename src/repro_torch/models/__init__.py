"""Model assembly on torch tensors (attention stacks, dense or MoE FFNs)."""

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
