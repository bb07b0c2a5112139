"""InternLM2 (arXiv:2403.17297; huggingface.co/internlm/internlm2-1_8b)
as a plain float32 decoder: RMSNorm, grouped-query attention with
rotary positions, a gated-SiLU MLP, an untied output head.

Written from the published architecture, in the parameter convention
the benchmark's weights use (``gpu_bench/weights.py``): products
``x @ w`` with ``w`` [in, out], and a norm scaling by ``1 + w``.  RoPE
rotates the two halves of each head (``rotate_half``, as the published
modelling code does), with ``rope_theta`` from the configuration.

``lowp=True`` is the control: every product (the projections, the
attention products, the MLP and the head) takes its two operands
rounded to float8 e4m3, each scaled by its absolute maximum, and sums in
float32 — the precision below the bfloat16 the configuration serves in;
in training the gradient reaching each product is rounded to float8
e5m2 the same way (the usual fp8 recipe), and the forward's rounding
passes straight through.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

FP8_MAX = 448.0  # largest finite float8 e4m3
FP8_E5M2_MAX = 57344.0  # largest finite float8 e5m2


def no_tf32() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale by its absolute
    maximum, back in float32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


class _GradFp8(torch.autograd.Function):
    """Identity forward; rounds the incoming gradient to float8 e5m2 under
    a scale by its absolute maximum, as the backward of an fp8 product
    takes it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        scale = g.abs().amax().clamp_min(1e-30) / FP8_E5M2_MAX
        return (g / scale).to(torch.float8_e5m2).to(g.dtype) * scale


def mm(a: torch.Tensor, b: torch.Tensor, lowp: bool) -> torch.Tensor:
    if lowp:
        return _GradFp8.apply(torch.matmul(fp8(a), fp8(b)))
    return torch.matmul(a, b)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta):
    """x [B, H, S, hd], positions 0..S-1."""
    hd, s = x.shape[-1], x.shape[-2]
    inv = 1.0 / theta ** (torch.arange(0, hd // 2, device=x.device,
                                       dtype=torch.float32) / (hd // 2))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: dict, w: dict, i: int, h: torch.Tensor, lowp: bool):
    """Causal grouped-query self-attention of layer ``i`` over h [B, S, d]."""
    B, S, _ = h.shape
    H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    q = mm(h, w["wq"][i], lowp).view(B, S, H, hd).transpose(1, 2)
    k = mm(h, w["wk"][i], lowp).view(B, S, KV, hd).transpose(1, 2)
    v = mm(h, w["wv"][i], lowp).view(B, S, KV, hd).transpose(1, 2)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    scores = mm(q, k.transpose(-1, -2), lowp) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    out = mm(probs, v, lowp).transpose(1, 2).reshape(B, S, H * hd)
    return mm(out, w["wo"][i], lowp)


def mlp(m: dict, w: dict, i: int, h: torch.Tensor, lowp: bool):
    return mm(F.silu(mm(h, w["gate"][i], lowp)) * mm(h, w["up"][i], lowp),
              w["down"][i], lowp)


def block(m, w, i, x, ffn, lowp):
    eps = m["rms_norm_eps"]
    x = x + attention(m, w, i, rms_norm(x, w["ln1"][i], eps), lowp)
    return x + ffn(m, w, i, rms_norm(x, w["ln2"][i], eps), lowp)


def unembed_weight(m: dict, w: dict) -> torch.Tensor:
    return w["embed"].t() if m.get("tie_word_embeddings") else w["lm_head"]


def hidden(m, w, tokens, *, ffn=mlp, lowp=False, remat=False):
    """Final-norm hidden states [B, S, d] of ``tokens`` [B, S]."""
    x = w["embed"][tokens]
    for i in range(m["num_hidden_layers"]):
        if remat and torch.is_grad_enabled():
            x = _ckpt.checkpoint(block, m, w, i, x, ffn, lowp,
                                 use_reentrant=False)
        else:
            x = block(m, w, i, x, ffn, lowp)
    return rms_norm(x, w["final_ln"], m["rms_norm_eps"])


def logits(m, w, tokens, *, ffn=mlp, lowp=False):
    """Logits [B, S, V] of every position."""
    return mm(hidden(m, w, tokens, ffn=ffn, lowp=lowp),
              unembed_weight(m, w), lowp)


def loss(m, w, tokens, labels, *, ffn=mlp, lowp=False, remat=True):
    """Mean next-token cross-entropy over labels >= 0."""
    z = mm(hidden(m, w, tokens, ffn=ffn, lowp=lowp, remat=remat),
           unembed_weight(m, w), lowp)
    keep = labels >= 0
    return F.cross_entropy(z[keep], labels[keep].long())


FFN = mlp
