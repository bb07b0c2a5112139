"""Model primitives on torch tensors: norms, RoPE, attention, gated MLP.

The same arithmetic as the JAX package's layers: weights in bf16 by
default, every reduction (norm, softmax, logits) in f32, the masking value
is the finite ``NEG_INF``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------- init
def dense_init(
    gen: torch.Generator, in_dim: int, out_dim: int, dtype, device
) -> torch.Tensor:
    """[in, out] normal weights scaled by 1/sqrt(in), drawn from ``gen``."""
    w = torch.randn(
        (in_dim, out_dim), generator=gen, dtype=torch.float32, device=device
    )
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(
    gen: torch.Generator, vocab: int, dim: int, dtype, device
) -> torch.Tensor:
    w = torch.randn(
        (vocab, dim), generator=gen, dtype=torch.float32, device=device
    )
    return (w * 0.02).to(dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, device):
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype, device),
        "up": dense_init(gen, d_model, d_ff, dtype, device),
        "down": dense_init(gen, d_ff, d_model, dtype, device),
    }


# -------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMS norm in f32, scaled by ``1 + weight`` (zero-initialised)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


# --------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, hd]; positions broadcastable to [..., S].  Rotates the
    two split halves of the head dimension (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, kv, S, hd] → [B, kv*groups, S, hd] (GQA head replication)."""
    if groups == 1:
        return k
    b, kv, s, hd = k.shape
    return k[:, :, None].expand(b, kv, groups, s, hd).reshape(
        b, kv * groups, s, hd
    )


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """Attention over query blocks of ``chunk`` rows, each against the full
    (masked) K — peak memory O(chunk × S).

    q: [B, H, Sq, hd]; k, v: [B, KV, Sk, hd] (KV heads repeated to H here).
    ``q_offset`` is the absolute position of q[..., 0, :]; ``window``
    enables sliding-window masking.
    """
    b, h, sq, hd = q.shape
    groups = h // k.shape[1]
    k = _repeat_kv(k, groups).float()
    v_f = _repeat_kv(v, groups).float()
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
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        logits = torch.where(mask[None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs, v_f).to(v.dtype))
    return torch.cat(outs, dim=2)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_pos: Union[int, torch.Tensor],
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention over a KV cache.

    q: [B, H, 1, hd]; k_cache/v_cache: [B, KV, S, hd]; cur_pos: an int or
    a [B] tensor — the new token attends to positions [0, cur_pos] of its
    row.  (The JAX package takes one scalar and vmaps over slots; a
    per-row position is the same thing batched.)
    """
    b, h, _, hd = q.shape
    groups = h // k_cache.shape[1]
    k = _repeat_kv(k_cache, groups)
    v = _repeat_kv(v_cache, groups)
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    k_pos = torch.arange(sk, device=q.device)
    cur = torch.as_tensor(cur_pos, device=q.device).reshape(-1, 1)  # [B|1, 1]
    mask = k_pos[None, :] <= cur
    if window is not None:
        mask &= k_pos[None, :] > (cur - window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------- MLP
def apply_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP; SiLU runs in f32 and casts back."""
    gate = torch.matmul(x, params["gate"])
    up = torch.matmul(x, params["up"])
    h = F.silu(gate.float()).to(x.dtype) * up
    return torch.matmul(h, params["down"])
