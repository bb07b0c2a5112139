"""AdamW in float32: decoupled weight decay, clipping by the global norm
of the gradients, and a linear warm-up followed by a cosine decay to
``min_lr_ratio`` of the peak rate (Loshchilov and Hutter,
arXiv:1711.05101)."""

from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(c: dict, step: int) -> float:
    warm = min(step / max(c["warmup_steps"], 1), 1.0)
    progress = min(max((step - c["warmup_steps"])
                       / max(c["total_steps"] - c["warmup_steps"], 1), 0.0),
                   1.0)
    decay = c["min_lr_ratio"] + (1 - c["min_lr_ratio"]) * 0.5 * (
        1 + math.cos(math.pi * progress))
    return c["lr"] * warm * decay


#: elements of a leaf updated at a time, to bound the temporaries
CHUNK = 1 << 26


@torch.no_grad()
def step(c: dict, params: Dict[str, torch.Tensor],
         grads: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor],
         v: Dict[str, torch.Tensor], t: int):
    """Step ``t`` (from 1), in place; returns each leaf's norm of the
    clipped gradient the moments take, and the clipping scale."""
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
    gnorm = math.sqrt(sum(n * n for n in norms.values()))
    scale = min(c["clip_norm"] / (gnorm + 1e-9), 1.0)
    lr = lr_at(c, t)
    b1, b2 = c["b1"], c["b2"]
    for k, p in params.items():
        flat = (grads[k].reshape(-1), p.view(-1), m[k].view(-1),
                v[k].view(-1))
        for i in range(0, p.numel(), CHUNK):
            g, pp, mm, vv = (x[i:i + CHUNK] for x in flat)
            g = g * scale
            mm.mul_(b1).add_(g, alpha=1 - b1)
            vv.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (mm / (1 - b1 ** t)) / (torch.sqrt(vv / (1 - b2 ** t))
                                          + c["eps"])
            pp.sub_(lr * (upd + c["weight_decay"] * pp))
    return {k: n * scale for k, n in norms.items()}, scale
