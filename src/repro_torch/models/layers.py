"""Model primitives on torch tensors: norms, RoPE, attention, gated MLP.

The same arithmetic as the JAX package's layers: weights in bf16 by
default, every reduction (norm, softmax, logits) in f32, the masking value
is the finite ``NEG_INF``.  Prefill and full-attention decode attention
run through ``kernels.ops`` (K3/K4 on the card, their plain versions on
the CPU); the ring-buffer decode of sliding-window layers is plain torch.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..dist.sharding import is_dtensor, shard
from ..kernels import ops as kernel_ops
from ..kernels import spmd
from ..kernels.ref import NEG_INF, repeat_kv


# ---------------------------------------------------------- grad boundaries
class _Bf16Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_grad(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; rounds the COTANGENT to bf16 on the way back, as
    the JAX package's ``layers.bf16_grad`` (a ``custom_vjp``) does at the
    residual stream's block boundaries: activation gradients between
    blocks carry bf16 precision, weight gradients and optimizer math stay
    in their own dtypes.  The JAX rule returns the cotangent AS bf16,
    which an f32 primal cannot take (its ``value_and_grad`` fails: ROADMAP
    Queue 3); here the rounded cotangent keeps the primal's dtype, which
    in a bf16 model is the same thing.  Where autograd records nothing
    (no grad mode, or ``x`` needs no gradient: every serving call) it
    returns ``x`` itself."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Bf16Grad.apply(x)
    return x


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
    """Full-sequence attention: the flash-attention kernel (K3) on the
    card, its plain version — query blocks of ``chunk`` rows against the
    full masked K, peak memory O(chunk × S) — on the CPU.

    q: [B, H, Sq, hd]; k, v: [B, KV, Sk, hd] (grouped-query heads).
    ``q_offset`` is the absolute position of q[..., 0, :]; ``window``
    enables sliding-window masking.
    """
    return kernel_ops.flash_attention(
        q, k, v, causal=causal, window=window or 0, q_offset=q_offset,
        chunk=chunk,
    )


def _positions(cur_pos: Union[int, torch.Tensor], b: int, device):
    """``cur_pos`` as the contiguous int32 [B] the decode kernels read."""
    pos = torch.as_tensor(cur_pos, device=device).to(torch.int32)
    return pos.reshape(-1).expand(b).contiguous()


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_pos: Union[int, torch.Tensor],
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention over a KV cache: the decode-attention
    kernel (K4) on the card, its plain version on the CPU.

    q: [B, H, 1, hd]; k_cache/v_cache: [B, KV, S, hd]; cur_pos: an int or
    a [B] tensor — the new token attends to positions [0, cur_pos] of its
    row (after cur_pos − window with ``window``).  (The JAX package takes
    one scalar and vmaps over slots; a per-row position is the same thing
    batched.)
    """
    out = kernel_ops.decode_attention(
        q[:, :, 0], k_cache, v_cache,
        _positions(cur_pos, q.shape[0], q.device), window=window or 0,
    )
    return out[:, :, None]


def decode_attention_ring(
    q: torch.Tensor,
    k_ring: torch.Tensor,
    v_ring: torch.Tensor,
    cur_pos: Union[int, torch.Tensor],
    window: int,
) -> torch.Tensor:
    """Sliding-window decode over a RING-BUFFER cache of ``window`` slots
    (plain torch on every device: the JAX package has no kernel for it).

    Slot i holds the key of the largest absolute position p <= cur_pos
    with p % window == i; keys carry RoPE at their absolute position, so
    a slot is valid iff that position is >= 0.  q: [B, H, 1, hd];
    k_ring/v_ring: [B, KV, window, hd]; cur_pos: an int or a [B] tensor.
    DTensors run it on their local shards (``kernels.spmd``).
    """
    if is_dtensor(q):
        return spmd.ring_attention(q, k_ring, v_ring, cur_pos, window,
                                   _ring_attention)
    return _ring_attention(q, k_ring, v_ring, cur_pos, window)


def _ring_attention(q, k_ring, v_ring, cur_pos, window: int):
    b, h, _, hd = q.shape
    groups = h // k_ring.shape[1]
    k = repeat_kv(k_ring, groups)
    v = repeat_kv(v_ring, groups)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk", q.float(), k.float()
    ) * scale
    slots = torch.arange(window, device=q.device)
    cur = _positions(cur_pos, b, q.device).long()[:, None]  # [B, 1]
    abs_pos = cur - ((cur - slots[None, :]) % window)  # [B, window]
    mask = (abs_pos >= 0) & (abs_pos <= cur)
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
    h = shard(h, ("batch", "seq", "mlp"))
    return torch.matmul(h, params["down"])
