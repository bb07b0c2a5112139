"""Int8 compression: symmetric per-tensor quantization (scale =
amax/127, round half to even), and gradient compression with error
feedback.

The host KV tier stores demoted pages through :func:`quantize` /
:func:`dequantize`: computed in float32 on numpy arrays so the codes match
the JAX package's byte for byte (the scale is floored on amax,
``max(amax, 1e-30) / 127``, and the codes are clipped to ±127).

The trainer's compressed-gradient step goes through :func:`init`,
:func:`compress_grads` and :func:`compressed_bytes`, the JAX package's
(``repro.dist.compression``) on device tensors: the same quantizer in
torch (``torch.round`` rounds half to even, as ``jnp.round`` does), and
an error-feedback accumulator [arXiv:1901.09847-style] — the residual of
each compression step is added to the next gradient before quantizing,
so the *sum* of compressed gradients tracks the sum of true gradients
while every gradient exchange moves 4× fewer bytes than f32.  The
residuals are updated in place (the JAX step donates them).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any

_QMAX = np.float32(127.0)


def quantize(x: np.ndarray) -> Tuple[np.ndarray, np.float32]:
    """x → (int8 codes, f32 scale); |dequantize(q, s) − x| ≤ s/2."""
    xf = np.asarray(x, np.float32)
    scale = np.maximum(np.max(np.abs(xf)), np.float32(1e-30)) / _QMAX
    q = np.clip(np.rint(xf / scale), -_QMAX, _QMAX).astype(np.int8)
    return q, np.float32(scale)


def dequantize(q: np.ndarray, scale) -> np.ndarray:
    return np.asarray(q).astype(np.float32) * np.float32(scale)


def _quantize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize` on a tensor, on its device: (int8 codes, f32
    scale as a 0-d tensor)."""
    xf = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-30) / float(_QMAX)
    q = torch.clamp(torch.round(xf / scale), -float(_QMAX), float(_QMAX))
    return q.to(torch.int8), scale


def init(params: PyTree) -> PyTree:
    """Zero error-feedback residuals, one f32 buffer per parameter."""
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params,
    )


@torch.no_grad()
def compress_grads(grads: PyTree, ef: PyTree
                   ) -> Tuple[PyTree, PyTree, torch.Tensor]:
    """(grads, residuals) → (dequantized grads, residuals, max |error|).

    Per leaf: t = g + e;  q = Q(t);  ĝ = Q⁻¹(q);  e' = t − ĝ.  Telescoping
    over steps, Σ ĝ = Σ g − e_final, so the carried residual is the whole
    compression bias.  The residuals are written into ``ef`` in place
    (and ``ef`` is returned); ĝ comes back in each gradient's dtype.
    """
    g_leaves, treedef = tree_flatten(grads)
    e_leaves, e_def = tree_flatten(ef)
    if e_def != treedef:
        raise ValueError("compress_grads: grads and residuals differ in "
                         "structure")
    deq_leaves, errs = [], []
    for g, e in zip(g_leaves, e_leaves):
        t = g.float() + e
        q, scale = _quantize_tensor(t)
        deq = q.float() * scale
        deq_leaves.append(deq.to(g.dtype))
        e.copy_(t - deq)
        errs.append(torch.max(torch.abs(e)))
    return (
        tree_unflatten(treedef, deq_leaves),
        ef,
        torch.max(torch.stack(errs)) if errs else torch.zeros(()),
    )


def compressed_bytes(params: PyTree) -> int:
    """Wire size of one compressed gradient exchange (int8 + f32 scale)."""
    return sum(int(leaf.numel()) + 4 for leaf in tree_leaves(params))
