"""Wrappers of the CUDA paged-decode kernels (``csrc/paged_decode.cu``).

Each wrapper checks device, dtype, shape, contiguity and alignment and
raises on anything the kernel does not take, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch reports an error, and adds one to its ``launches``
counter.  They take CUDA tensors only: the plain versions live in
:mod:`.ref` and :mod:`.ops` chooses between the two.
"""

from __future__ import annotations

import math

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_common(q, k_pool, v_pool, page_table, seq_lens, pool_dtypes):
    tensors = (q, k_pool, v_pool, page_table, seq_lens)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged decode kernel: every tensor must be on CUDA")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged decode kernel: tensors on different devices")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged decode kernel: q dtype {q.dtype}")
    if k_pool.dtype not in pool_dtypes or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"paged decode kernel: pool dtypes {k_pool.dtype}/{v_pool.dtype}"
        )
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged decode kernel: table and lens must be int32")
    if q.dim() != 2 or k_pool.dim() != 3 or page_table.dim() != 2:
        raise ValueError("paged decode kernel: q [BH, hd], pools [n, P, hd]")
    bh, hd = q.shape
    n_rows, page, pool_hd = k_pool.shape
    if v_pool.shape != k_pool.shape or pool_hd != hd:
        raise ValueError("paged decode kernel: pool shapes disagree with q")
    if page_table.shape[0] != bh or seq_lens.shape != (bh,):
        raise ValueError("paged decode kernel: table/lens rows != q rows")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"paged decode kernel: hd {hd} not a multiple of 8 "
                         "in [8, 256]")
    if page < 1 or n_rows < 1 or page_table.shape[1] < 1 or bh < 1:
        raise ValueError("paged decode kernel: empty pool, page or table")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode kernel: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged decode kernel: q and pools must be "
                         "16-byte aligned")
    return bh, hd, n_rows, page, page_table.shape[1]


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")


def paged_decode_attention(
    q: torch.Tensor,  # [BH, hd] bf16 | f32
    k_pool: torch.Tensor,  # [n_rows, P, hd] q's dtype
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [BH, W] int32
    seq_lens: torch.Tensor,  # [BH] int32
) -> torch.Tensor:
    """K1: paged decode attention on the card (see ``csrc/paged_decode.cu``)."""
    bh, hd, n_rows, page, w = _check_common(
        q, k_pool, v_pool, page_table, seq_lens, (q.dtype,)
    )
    out = torch.empty_like(q)
    lib = _build.library("paged_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            bh, w, page, hd, n_rows, 1.0 / math.sqrt(hd),
            _DTYPE_CODE[q.dtype], stream,
        )
    _raise_on(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_int8(
    q: torch.Tensor,  # [BH, hd] bf16 | f32
    k_pool: torch.Tensor,  # [n_rows, P, hd] int8 codes
    v_pool: torch.Tensor,
    k_scales: torch.Tensor,  # [n_rows] f32
    v_scales: torch.Tensor,
    page_table: torch.Tensor,  # [BH, W] int32
    seq_lens: torch.Tensor,  # [BH] int32
) -> torch.Tensor:
    """K2: paged decode attention over int8 code pools on the card."""
    bh, hd, n_rows, page, w = _check_common(
        q, k_pool, v_pool, page_table, seq_lens, (torch.int8,)
    )
    for s in (k_scales, v_scales):
        if not s.is_cuda or s.device != q.device:
            raise ValueError("paged decode kernel: scales must be on q's device")
        if s.dtype != torch.float32 or s.shape != (n_rows,):
            raise ValueError("paged decode kernel: scales must be f32 [n_rows]")
        if not s.is_contiguous():
            raise ValueError("paged decode kernel: scales must be contiguous")
    out = torch.empty_like(q)
    lib = _build.library("paged_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_paged_decode_int8(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            bh, w, page, hd, n_rows, 1.0 / math.sqrt(hd),
            _DTYPE_CODE[q.dtype], stream,
        )
    _raise_on(err, "paged_decode_attention_int8")
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_int8.launches = 0

#: every kernel wrapper of this module, for counting and resetting launches
WRAPPERS = (paged_decode_attention, paged_decode_attention_int8)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
