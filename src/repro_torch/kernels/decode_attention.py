"""Wrapper of the CUDA decode-attention kernel K4 (``csrc/decode_attention.cu``).

It checks device, dtype, shape, strides and alignment and raises on
anything the kernel does not take, plans the split of the key axis
(:func:`split_plan`, once a shape), allocates the output with
``torch.empty`` and takes the splits' f32 workspace from
:func:`.splits.workspace`, launches on the current stream without
synchronising, raises if the launch reports an error, and adds one to
``launches`` (one call, however many splits).  It takes CUDA tensors
only: the plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`, and
:mod:`repro_torch.kernels.ops` chooses between the two.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from ._build import DTYPE_CODE, raise_on_launch_error, row_strides
from .splits import even_split, plan_cache, workspace

#: CTAs the split aims for on each SM of the card
CTAS_PER_SM = 2
#: the shortest split worth a CTA of its own, in keys
MIN_SPLIT = 64


def head_group(h: int, kv: int) -> int:
    """GT, the q-heads of one kv head that a CTA serves together (they
    share every K and V load): the largest of 4, 2, 1 that divides
    H / KV."""
    g = h // kv
    return 4 if g % 4 == 0 else 2 if g % 2 == 0 else 1


def split_plan(b: int, h: int, kv: int, s: int,
               sms: int) -> Tuple[int, int]:
    """(n_splits, split_len) of the key axis [0, S) on a card of ``sms``
    SMs: enough splits that B · (H / GT) · n_splits reaches
    ``CTAS_PER_SM`` · sms, none shorter than ``MIN_SPLIT`` keys, and
    split_len · n_splits ≥ S with no empty last split.  From the shapes
    alone: the positions stay on the device."""
    return even_split(s, b * (h // head_group(h, kv)), sms, CTAS_PER_SM,
                      MIN_SPLIT)


@plan_cache
def _launch_plan(b: int, h: int, kv: int, s: int,
                 sms: int) -> Tuple[int, int, int]:
    """(GT, n_splits, split_len) of a shape on a card of ``sms`` SMs."""
    return (head_group(h, kv), *split_plan(b, h, kv, s, sms))


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
    group_heads, n_splits, split_len = _launch_plan(b, h, kv, s,
                                                    q.device.index)
    lib = _build.library("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        # each split's acc [B, H, n_splits, hd], then its (m, l)
        ws = (workspace(q.device, stream, b * h * n_splits * (hd + 2))
              if n_splits > 1 else None)
        err = lib.launch_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_pos.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            b, h, kv, s, hd, *qs, *ks, *vs, window, group_heads, n_splits,
            split_len, 1.0 / math.sqrt(hd), DTYPE_CODE[q.dtype], stream,
        )
    raise_on_launch_error(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
