"""Wrapper of the CUDA decode-attention kernel K4 (``csrc/decode_attention.cu``).

It checks device, dtype, shape, strides and alignment and raises on
anything the kernel does not take, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch reports an error, and adds one to ``launches``.  It
takes CUDA tensors only: the plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`, and
:mod:`repro_torch.kernels.ops` chooses between the two.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._build import DTYPE_CODE, raise_on_launch_error, row_strides


def decode_attention(
    q: torch.Tensor,  # [B, H, hd] bf16 | f32
    k: torch.Tensor,  # [B, KV, S, hd] q's dtype
    v: torch.Tensor,  # [B, KV, S, hd]
    cur_pos: torch.Tensor,  # [B] int32 on q's device
    *,
    window: int = 0,  # 0 = no sliding window
) -> torch.Tensor:
    """K4: one query per row against its slot's cache on the card; row b
    attends keys ``max(0, cur_pos[b] - window + 1) .. cur_pos[b]``.  The
    cache may be a strided layer view; returns a contiguous [B, H, hd]."""
    tensors = (q, k, v, cur_pos)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("decode attention kernel: every tensor must be on "
                         "CUDA")
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode attention kernel: tensors on different "
                         "devices")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode attention kernel: dtypes {q.dtype}/"
                        f"{k.dtype}/{v.dtype}; one of float32, bfloat16")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode attention kernel: q [B, H, hd], k and v "
                         "[B, KV, S, hd] of one shape")
    b, h, hd = q.shape
    _, kv, s, k_hd = k.shape
    if k.shape[0] != b or k_hd != hd:
        raise ValueError("decode attention kernel: k/v batch or head dim "
                         "differs from q's")
    if kv < 1 or h % kv:
        raise ValueError(f"decode attention kernel: {h} q heads over {kv} "
                         "kv heads")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"decode attention kernel: hd {hd} not a multiple "
                         "of 8 in [8, 256]")
    if b < 1 or s < 1:
        raise ValueError("decode attention kernel: empty batch or cache")
    if cur_pos.dtype != torch.int32 or cur_pos.shape != (b,) \
            or not cur_pos.is_contiguous():
        raise ValueError("decode attention kernel: cur_pos must be a "
                         "contiguous int32 [B]")
    if window < 0:
        raise ValueError("decode attention kernel: window must be >= 0")
    qs, ks, vs = (row_strides(t, "decode attention kernel") for t in (q, k, v))
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    lib = _build.library("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_pos.data_ptr(),
            out.data_ptr(), b, h, kv, s, hd, *qs, *ks, *vs, window,
            1.0 / math.sqrt(hd), DTYPE_CODE[q.dtype], stream,
        )
    raise_on_launch_error(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
