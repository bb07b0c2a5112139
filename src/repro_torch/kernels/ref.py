"""Plain PyTorch versions of the kernels (the correctness reference).

They mirror the JAX package's jnp code: f32 einsums, a masked softmax
with the finite ``NEG_INF`` (a fully masked row averages V over every key
instead of giving NaN), output in q's dtype (in x's dtype for the
grouped matmul).  The paged versions gather
each row's pages first; the attention versions take grouped-query K/V
``[B, KV, S, hd]`` and repeat it to the q heads, as
``repro.models.layers`` does.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, kv, S, hd] → [B, kv*groups, S, hd] (GQA head replication)."""
    if groups == 1:
        return k
    b, kv, s, hd = k.shape
    return k[:, :, None].expand(b, kv, groups, s, hd).reshape(
        b, kv * groups, s, hd
    )


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Sq, hd]
    k: torch.Tensor,  # [B, KV, Sk, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,  # 0 = no sliding window
    q_offset: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """K3's plain version: ``repro.models.layers.chunked_attention``, one
    block of ``chunk`` query rows at a time against the full masked K
    (peak memory O(chunk × Sk)).  Row i sits at position q_offset + i;
    key j is kept when j <= that position (causal) and it is less than
    ``window`` behind (window > 0).  A row that keeps no key returns the
    mean of V over all Sk keys, as the Pallas kernel does
    (``repro.kernels.ref.flash_attention_ref`` returns 0 there)."""
    b, h, sq, hd = q.shape
    groups = h // k.shape[1]
    k = repeat_kv(k, groups).float()
    v_f = repeat_kv(v, groups).float()
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    k_pos = torch.arange(sk, device=q.device)
    outs = []
    for start in range(0, sq, chunk):
        q_blk = q[:, :, start:start + chunk].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", q_blk, k) * scale
        q_pos = q_offset + start + torch.arange(
            q_blk.shape[2], device=q.device
        )
        mask = torch.ones(
            (q_blk.shape[2], sk), dtype=torch.bool, device=q.device
        )
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        logits = torch.where(mask[None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs, v_f).to(q.dtype))
    return torch.cat(outs, dim=2)


def decode_attention_ref(
    q: torch.Tensor,  # [B, H, hd]
    k: torch.Tensor,  # [B, KV, S, hd]
    v: torch.Tensor,
    cur_pos: torch.Tensor,  # [B] (or [1]): row b attends [0, cur_pos[b]]
    *,
    window: int = 0,  # 0 = no sliding window
) -> torch.Tensor:
    """K4's plain version: ``repro.models.layers.decode_attention`` with a
    position per row (the JAX package takes one scalar and vmaps over
    slots); with ``window`` only keys after cur_pos − window count."""
    h, hd = q.shape[1], q.shape[2]
    groups = h // k.shape[1]
    k = repeat_kv(k, groups)
    v = repeat_kv(v, groups)
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk", q[:, :, None].float(), k.float()
    ) * scale
    k_pos = torch.arange(sk, device=q.device)
    cur = cur_pos.to(q.device).reshape(-1, 1)  # [B|1, 1]
    mask = k_pos[None, :] <= cur
    if window > 0:
        mask &= k_pos[None, :] > (cur - window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out[:, :, 0].to(q.dtype)


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


def grouped_matmul_ref(
    x: torch.Tensor,  # [E, C, D]
    w: torch.Tensor,  # [E, D, F]
) -> torch.Tensor:
    """K5's plain version: ``y[e] = x[e] @ w[e]`` in f32, output in x's
    dtype (``repro.kernels.ref.grouped_matmul_ref``)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
