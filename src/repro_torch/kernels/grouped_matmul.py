"""Wrapper of the CUDA grouped-matmul kernel K5 (``csrc/grouped_matmul.cu``).

It checks device, dtype, shape and strides and raises on anything the
kernel does not take, allocates the output with ``torch.empty``, launches
on the current stream without synchronising, raises if the launch reports
an error, and adds one to ``launches``.  It takes CUDA tensors only: the
plain version is :func:`repro_torch.kernels.ref.grouped_matmul_ref`, and
:mod:`repro_torch.kernels.ops` chooses between the two.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import DTYPE_CODE, raise_on_launch_error


def grouped_matmul(
    x: torch.Tensor,  # [E, C, D] bf16 | f32, rows contiguous
    w: torch.Tensor,  # [E, D, F] x's dtype, contiguous
) -> torch.Tensor:
    """K5: ``y[e] = x[e] @ w[e]`` on the card, summed in f32 and rounded
    once to x's dtype; any C, D and F.  ``x`` may be a strided view whose
    last dimension is contiguous; returns a contiguous [E, C, F]."""
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("grouped matmul kernel: x and w must be on CUDA")
    if x.device != w.device:
        raise ValueError("grouped matmul kernel: x and w on different devices")
    if x.dtype not in DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"grouped matmul kernel: dtypes {x.dtype}/{w.dtype}; "
                        "one of float32, bfloat16 for both")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError("grouped matmul kernel: x [E, C, D], w [E, D, F]")
    e, c, d = x.shape
    f = w.shape[2]
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"grouped matmul kernel: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if min(e, c, d, f) < 1:
        raise ValueError("grouped matmul kernel: empty dimension")
    if d > 1 and x.stride(2) != 1:
        raise ValueError("grouped matmul kernel: x rows must be contiguous")
    if not w.is_contiguous():
        raise ValueError("grouped matmul kernel: w must be contiguous")
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
