"""Dispatch by device: the plain version for CPU tensors, the CUDA kernel
for CUDA tensors.  There is no fallback: a CUDA tensor the kernel cannot
take raises."""

from __future__ import annotations

import torch

from . import paged_decode, ref


def _on_cpu(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type == "cuda":
        return False
    raise ValueError(f"no paged-decode path for device {q.device}")


def paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens):
    """[BH, hd] attention of each row over its pool pages (see ``ref``)."""
    if _on_cpu(q):
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, page_table, seq_lens
        )
    return paged_decode.paged_decode_attention(
        q, k_pool, v_pool, page_table, seq_lens
    )


def paged_decode_attention_int8(
    q, k_pool, v_pool, k_scales, v_scales, page_table, seq_lens
):
    """As :func:`paged_decode_attention` over int8 code pools with
    per-page f32 scales."""
    if _on_cpu(q):
        return ref.paged_decode_attention_int8_ref(
            q, k_pool, v_pool, k_scales, v_scales, page_table, seq_lens
        )
    return paged_decode.paged_decode_attention_int8(
        q, k_pool, v_pool, k_scales, v_scales, page_table, seq_lens
    )
