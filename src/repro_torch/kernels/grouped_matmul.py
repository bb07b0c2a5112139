"""Wrappers of the CUDA grouped-matmul kernel K5 (``csrc/grouped_matmul.cu``)
and of its backward (``csrc/grouped_matmul_bwd.cu``).

Each checks device, dtype, shape and strides and raises on anything its
kernel does not take, allocates its outputs with ``torch.empty``,
launches on the current stream without synchronising, raises if the
launch reports an error, and adds one to its ``launches``.  They take
CUDA tensors only: the plain versions are
:func:`repro_torch.kernels.ref.grouped_matmul_ref` and
:func:`repro_torch.kernels.ref.grouped_matmul_bwd_ref`, and
:mod:`repro_torch.kernels.ops` chooses between the two.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._build import DTYPE_CODE, raise_on_launch_error


def _check(x, w, dy=None):
    """Raise on what the kernels do not take; returns (E, C, D, F).
    ``dy``: the backward's gradient of y [E, C, F], contiguous."""
    what = "grouped matmul kernel" if dy is None else "grouped matmul backward"
    inputs = (x, w) if dy is None else (x, w, dy)
    if not all(t.is_cuda for t in inputs):
        raise ValueError(f"{what}: inputs must be on CUDA")
    if any(t.device != x.device for t in inputs):
        raise ValueError(f"{what}: inputs on different devices")
    if x.dtype not in DTYPE_CODE or any(t.dtype != x.dtype for t in inputs):
        raise TypeError(f"{what}: dtypes {[t.dtype for t in inputs]}; one of "
                        "float32, bfloat16 for all")
    if any(t.dim() != 3 for t in inputs):
        raise ValueError(f"{what}: x [E, C, D], w [E, D, F], dy [E, C, F]")
    e, c, d = x.shape
    f = w.shape[2]
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"{what}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if dy is not None and tuple(dy.shape) != (e, c, f):
        raise ValueError(f"{what}: dy {tuple(dy.shape)} is not [E, C, F] = "
                         f"{(e, c, f)}")
    if min(e, c, d, f) < 1:
        raise ValueError(f"{what}: empty dimension")
    if d > 1 and x.stride(2) != 1:
        raise ValueError(f"{what}: x rows must be contiguous")
    if not w.is_contiguous():
        raise ValueError(f"{what}: w must be contiguous")
    if dy is not None and not dy.is_contiguous():
        raise ValueError(f"{what}: dy must be contiguous")
    return e, c, d, f


def grouped_matmul(
    x: torch.Tensor,  # [E, C, D] bf16 | f32, rows contiguous
    w: torch.Tensor,  # [E, D, F] x's dtype, contiguous
) -> torch.Tensor:
    """K5: ``y[e] = x[e] @ w[e]`` on the card, summed in f32 and rounded
    once to x's dtype; any C, D and F.  ``x`` may be a strided view whose
    last dimension is contiguous; returns a contiguous [E, C, F]."""
    e, c, d, f = _check(x, w)
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    lib = _build.library("grouped_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_grouped_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
            x.stride(0), x.stride(1), DTYPE_CODE[x.dtype], stream,
        )
    raise_on_launch_error(err, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def grouped_matmul_bwd(
    x: torch.Tensor,  # [E, C, D] bf16 | f32, rows contiguous
    w: torch.Tensor,  # [E, D, F] x's dtype, contiguous
    dy: torch.Tensor,  # [E, C, F] x's dtype, contiguous
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's backward in one launch: ``dx[e] = dy[e] @ w[e]^T`` and
    ``dw[e] = x[e]^T @ dy[e]``, each summed in f32 and rounded once to
    x's dtype, with no transposed copy; any C, D and F.  ``x`` may be a
    strided view whose last dimension is contiguous; returns contiguous
    dx [E, C, D] and dw [E, D, F]."""
    e, c, d, f = _check(x, w, dy)
    dx = torch.empty((e, c, d), dtype=x.dtype, device=x.device)
    dw = torch.empty((e, d, f), dtype=x.dtype, device=x.device)
    lib = _build.library("grouped_matmul_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_grouped_matmul_bwd(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), e, c, d, f, x.stride(0), x.stride(1),
            DTYPE_CODE[x.dtype], stream,
        )
    raise_on_launch_error(err, "grouped_matmul_bwd")
    grouped_matmul_bwd.launches += 1
    return dx, dw


grouped_matmul_bwd.launches = 0
