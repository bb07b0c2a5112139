"""Plain PyTorch versions of the kernels (the correctness reference).

They mirror the JAX package's jnp oracles: gather each row's pages, f32
einsum, masked softmax with the finite ``NEG_INF`` (a fully masked row
averages V instead of giving NaN), output in q's dtype.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(
    q: torch.Tensor,  # [BH, hd]
    k_pool: torch.Tensor,  # [n_pages, page, hd]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [BH, max_pages] int32
    seq_lens: torch.Tensor,  # [BH] int32
) -> torch.Tensor:
    """Gather-based reference: materialize each row's KV, then attend."""
    bh, hd = q.shape
    page = k_pool.shape[1]
    max_pages = page_table.shape[1]
    idx = page_table.long()
    k = k_pool[idx].reshape(bh, max_pages * page, hd)
    v = v_pool[idx].reshape(bh, max_pages * page, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bd,bkd->bk", q.float(), k.float()) * scale
    tok = torch.arange(max_pages * page, device=q.device)[None, :]
    s = torch.where(tok < seq_lens[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bk,bkd->bd", p, v.float()).to(q.dtype)


def paged_decode_attention_int8_ref(
    q: torch.Tensor,  # [BH, hd]
    k_pool: torch.Tensor,  # [n_pages, page, hd] int8 codes
    v_pool: torch.Tensor,
    k_scales: torch.Tensor,  # [n_pages] f32
    v_scales: torch.Tensor,
    page_table: torch.Tensor,  # [BH, max_pages]
    seq_lens: torch.Tensor,  # [BH]
) -> torch.Tensor:
    """Dequantize the whole pool up front, then run the f32 reference."""
    k = k_pool.float() * k_scales[:, None, None]
    v = v_pool.float() * v_scales[:, None, None]
    return paged_decode_attention_ref(q, k, v, page_table, seq_lens)
