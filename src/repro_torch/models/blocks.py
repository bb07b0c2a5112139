"""GQA attention block: init, full-sequence (prefill) and decode apply.

The other block types of the JAX package (MLA, MoE, Mamba-2) are not
ported yet; ROADMAP.md Queue 1 item 10 lists them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..configs.base import ArchConfig
from .layers import apply_rope, chunked_attention, decode_attention, dense_init


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype, device):
    hd = cfg.head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.n_heads * hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(cfg.n_kv_heads * hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(cfg.n_kv_heads * hd, dtype=dtype, device=device)
    return p


def _qkv(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """x [B, S, d] → q [B, H, S, hd], k/v [B, KV, S, hd]."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    return q, k, v


def attention_forward(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    q_offset: int = 0,
    return_cache: bool = False,
):
    """Full-sequence attention (prefill); with ``return_cache`` also the
    roped K and V [B, KV, S, hd]."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    positions = q_offset + torch.arange(s, device=x.device)
    q = apply_rope(q, positions[None, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, None, :], cfg.rope_theta)
    out = chunked_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset
    )
    out = out.transpose(1, 2).reshape(b, s, -1)
    y = torch.matmul(out, p["wo"])
    if return_cache:
        return y, (k, v)
    return y


def attention_decode(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    cache: Tuple[torch.Tensor, torch.Tensor],
    pos: Union[int, torch.Tensor],
    *,
    rows: Optional[torch.Tensor] = None,
):
    """Single-token decode of full attention.

    cache k/v [B, KV, S_max, hd] is updated IN PLACE at ``pos`` (an int or
    a [B] tensor) — the JAX package returns a new cache, the port writes
    into the engine's cache to save a copy of it per step.  ``rows``
    (int64 indices) limits the write to those batch rows: the others keep
    their cache bit for bit, as the masked vmapped step keeps them.
    """
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x)  # seq dim == 1
    pos_t = torch.as_tensor(pos, device=x.device).reshape(-1)
    positions = pos_t[:, None, None] if pos_t.numel() > 1 else pos_t.reshape(
        1, 1, 1
    )
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    k_cache, v_cache = cache
    pos_b = pos_t.expand(b) if pos_t.numel() == 1 else pos_t
    idx = torch.arange(b, device=x.device) if rows is None else rows
    k_cache[idx, :, pos_b[idx]] = k_new[idx, :, 0]
    v_cache[idx, :, pos_b[idx]] = v_new[idx, :, 0]
    out = decode_attention(q, k_cache, v_cache, pos_b)
    out = out.transpose(1, 2).reshape(b, 1, -1)
    y = torch.matmul(out, p["wo"])
    return y, (k_cache, v_cache)
