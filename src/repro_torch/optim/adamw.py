"""AdamW from scratch (no ``torch.optim``), as the JAX package's
``repro.optim.adamw``: decoupled weight decay, global-norm clip,
linear-warmup + cosine-decay schedule.  Optimizer state is f32 whatever
the parameters' dtype (mixed precision: bf16 params, f32 moments).

Where JAX returns new trees from a donated step, :func:`update` writes
the moments and the parameters IN PLACE under ``torch.no_grad()`` (the
donation's counterpart: no second copy of either) and returns the same
tensors.  XLA fuses the update's elementwise chain, with no temporary;
eager torch allocates one f32 temporary an operation, so a leaf is
updated UPDATE_CHUNK elements at a time (slices of its flattened view;
the same arithmetic element by element, so the same bits), which keeps
the temporaries small beside a leaf of billions of parameters.  A
DTensor leaf (a step on a mesh) is updated whole.  Scalars (the step,
the learning rate, the bias corrections, the clip scale) are 0-d f32
tensors on the parameters' device, computed as the JAX package computes
them, so a step never waits on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from .. import obs
from ..dist.sharding import is_dtensor
from ..tree import tree_flatten, tree_leaves, tree_map

PyTree = Any

#: the most elements of a leaf that one slice of the update takes: 256 MB
#: of f32 a temporary (deepseek-v2's expert leaves hold 1.26 B parameters,
#: and the update's temporaries of one whole such leaf came to 20 GB)
UPDATE_CHUNK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # i32 scalar
    m: PyTree  # f32, like params
    v: PyTree  # f32, like params


def init(params: PyTree) -> AdamWState:
    """Step 0 and zero f32 moments, on the parameters' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def update(
    cfg: AdamWConfig, grads: PyTree, state: AdamWState, params: PyTree
) -> tuple[PyTree, AdamWState, torch.Tensor]:
    """Returns (params, state, grad_norm), ``params`` and the moments
    updated in place (the same tensors as given)."""
    with obs.span("train.optimizer"):
        gnorm = global_norm(grads)
        scale = None
        if cfg.clip_norm is not None:
            scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = schedule(cfg, step)
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                           device=stepf.device), stepf)
        b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                           device=stepf.device), stepf)
        g_leaves, treedef = tree_flatten(grads)
        p_leaves = _leaves_like(treedef, params)
        m_leaves = _leaves_like(treedef, state.m)
        v_leaves = _leaves_like(treedef, state.v)
        for leaves in zip(g_leaves, p_leaves, m_leaves, v_leaves):
            for g, p, m, v in _pieces(*leaves):
                g = g.float()
                if scale is not None:
                    g = g * scale
                m.copy_(cfg.b1 * m + (1.0 - cfg.b1) * g)
                v.copy_(cfg.b2 * v + (1.0 - cfg.b2) * g * g)
                del g
                upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                pf = p.float()
                upd = upd + cfg.weight_decay * pf
                p.copy_((pf - lr * upd).to(p.dtype))
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def _pieces(g, p, m, v) -> list:
    """(g, p, m, v) as slices of UPDATE_CHUNK elements of their flattened
    views (p, m and v written in place through them), or whole for a
    DTensor or a leaf whose storage is not contiguous."""
    if is_dtensor(p) or not all(t.is_contiguous() for t in (p, m, v)):
        return [(g, p, m, v)]
    flat = (g.reshape(-1), p.view(-1), m.view(-1), v.view(-1))
    return [tuple(t[i:i + UPDATE_CHUNK] for t in flat)
            for i in range(0, p.numel(), UPDATE_CHUNK)]


def _leaves_like(treedef, tree: PyTree) -> list:
    """``tree``'s leaves, checked to have ``treedef``'s structure."""
    leaves, other = tree_flatten(tree)
    if other != treedef:
        raise ValueError("AdamW: grads, params and moments differ in "
                         "structure")
    return leaves
