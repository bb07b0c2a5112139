"""Wrapper of the CUDA flash-attention kernel K3 (``csrc/flash_attention.cu``).

It checks device, dtype, shape, strides and alignment and raises on
anything the kernel does not take, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch reports an error, and adds one to ``launches``.  It
takes CUDA tensors only: the plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`, and
:mod:`repro_torch.kernels.ops` chooses between the two.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._build import DTYPE_CODE, raise_on_launch_error, row_strides


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, hd] bf16 | f32
    k: torch.Tensor,  # [B, KV, Sk, hd] q's dtype
    v: torch.Tensor,  # [B, KV, Sk, vd], vd <= hd
    *,
    causal: bool = True,
    window: int = 0,  # 0 = no sliding window
    q_offset: int = 0,  # absolute position of q row 0
) -> torch.Tensor:
    """K3: causal / sliding-window attention with grouped-query heads on
    the card.  The operands may be strided views (the model's transposed
    projections); the output is a [B, H, Sq, hd] view of a [B, Sq, H, hd]
    buffer, so the caller's transpose back to [B, Sq, H·hd] is free.

    V may be narrower than q/k (MLA: q/k 192 wide, V 128), as the JAX
    package's ``chunked_attention`` allows.  The kernel takes one head
    width, so V is zero-padded to q's width, the scale stays
    1/sqrt(q's width), and the output is the first ``vd`` columns: the
    zero columns add nothing to the kept ones.  Reading only ``vd``
    columns of V is later work (ROADMAP Queue 2)."""
    tensors = (q, k, v)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash attention kernel: every tensor must be on CUDA")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention kernel: tensors on different devices")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; one of float32, bfloat16")
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or v.shape[:3] != k.shape[:3] or v.shape[3] > k.shape[3]):
        raise ValueError("flash attention kernel: q [B, H, Sq, hd], k "
                         "[B, KV, Sk, hd], and v of one shape with k but "
                         "for a width vd <= hd")
    b, h, sq, hd = q.shape
    vd = v.shape[3]
    _, kv, sk, k_hd = k.shape
    if k.shape[0] != b or k_hd != hd:
        raise ValueError("flash attention kernel: k/v batch or head dim "
                         "differs from q's")
    if kv < 1 or h % kv:
        raise ValueError(f"flash attention kernel: {h} q heads over {kv} "
                         "kv heads")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"flash attention kernel: hd {hd} not a multiple "
                         "of 8 in [8, 256]")
    if b < 1 or sq < 1 or sk < 1:
        raise ValueError("flash attention kernel: empty batch or sequence")
    if window < 0 or q_offset < 0:
        raise ValueError("flash attention kernel: window and q_offset must "
                         "be >= 0")
    if vd < hd:
        if vd % 8:
            raise ValueError(f"flash attention kernel: V width {vd} not a "
                             "multiple of 8")
        v = torch.nn.functional.pad(v, (0, hd - vd))
        tensors = (q, k, v)
    strides = [row_strides(t, "flash attention kernel") for t in tensors]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    out = out.transpose(1, 2)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, sq, sk, hd, *strides[0], *strides[1], *strides[2],
            *out.stride()[:3], int(causal), window, q_offset,
            1.0 / math.sqrt(hd), DTYPE_CODE[q.dtype], stream,
        )
    raise_on_launch_error(err, "flash_attention")
    flash_attention.launches += 1
    return out if vd == hd else out[..., :vd]


flash_attention.launches = 0
