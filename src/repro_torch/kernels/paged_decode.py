"""Wrappers of the CUDA paged-decode kernels (``csrc/paged_decode.cu``).

Each wrapper checks device, dtype, shape, contiguity and alignment and
raises on anything the kernel does not take, plans the split of the page
sweep (:func:`split_plan`, once a shape), allocates the output with
``torch.empty`` and takes a split's f32 workspace and arrival counters
from :mod:`.splits`, launches on the current stream without
synchronising, raises if the launch reports an error, and adds one to its
``launches`` counter (one call, however many splits).  They take CUDA
tensors only: the plain versions live in :mod:`.ref` and :mod:`.ops`
chooses between the two.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from ._build import DTYPE_CODE, raise_on_launch_error
from .splits import counters, even_split, plan_cache, workspace

#: CTAs (of 4 warps) the split aims for on each SM of the card
CTAS_PER_SM = 4
#: the fewest pages worth a split of its own
MIN_PAGES = 4
#: the most pages a split sweeps (the kernel's page-id buffer)
MAX_PAGES = 64


def group_rows(q_per_kv: int) -> int:
    """GT, the rows of one kv head that a CTA serves together (they share
    every K and V load): the largest of 4, 3, 2, 1 that divides
    ``q_per_kv``."""
    return next(gt for gt in (4, 3, 2, 1) if q_per_kv % gt == 0)


def split_plan(bh: int, w: int, gt: int, sms: int) -> Tuple[int, int]:
    """(n_splits, split_pages) of the W-page sweep on a card of ``sms``
    SMs: enough splits that the BH / GT groups times n_splits reach
    ``CTAS_PER_SM`` · sms, none shorter than ``MIN_PAGES`` pages, none
    longer than ``MAX_PAGES``, and split_pages · n_splits ≥ W with no
    empty last split.  From the shapes alone: the lengths stay on the
    device."""
    return even_split(w, bh // gt, sms, CTAS_PER_SM, MIN_PAGES, MAX_PAGES)


def cta_groups(bh: int, q_per_kv: int) -> int:
    """GT for ``bh`` rows in groups of ``q_per_kv``; raises unless the rows
    are a whole number of groups.  The kernel reads the table and length
    row of each GT-row group's first row only: the rows of one group must
    be equal, which the caller promises (checking it would read the
    card's tables back)."""
    if q_per_kv < 1 or bh % q_per_kv:
        raise ValueError(f"paged decode kernel: {bh} rows are not groups "
                         f"of q_per_kv = {q_per_kv}")
    return group_rows(q_per_kv)


@plan_cache
def _launch_plan(bh: int, w: int, q_per_kv: int,
                 sms: int) -> Tuple[int, int, int]:
    """(GT, n_splits, split_pages) of a shape on a card of ``sms`` SMs."""
    gt = cta_groups(bh, q_per_kv)
    return (gt, *split_plan(bh, w, gt, sms))


def _check_common(q, k_pool, v_pool, page_table, seq_lens, pool_dtypes):
    tensors = (q, k_pool, v_pool, page_table, seq_lens)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged decode kernel: every tensor must be on CUDA")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged decode kernel: tensors on different devices")
    if q.dtype not in DTYPE_CODE:
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


def _launch(fn, q, pools, scales, page_table, seq_lens, q_per_kv, dims):
    """Plan, allocate and launch one call of ``fn`` (the library's
    ``launch_paged_decode`` or ``launch_paged_decode_int8``)."""
    bh, hd, n_rows, page, w = dims
    gt, n_splits, split_pages = _launch_plan(bh, w, q_per_kv,
                                             q.device.index)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = cnt = None
        if n_splits > 1:  # each split's acc [BH, n_splits, hd], then (m, l)
            ws = workspace(q.device, stream,
                           bh * n_splits * (hd + 2)).data_ptr()
            cnt = counters(q.device, stream, bh // gt).data_ptr()
        err = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
                 *(t.data_ptr() for t in scales), page_table.data_ptr(),
                 seq_lens.data_ptr(), out.data_ptr(), ws, cnt, bh, w, page,
                 hd, n_rows, gt, n_splits, split_pages, 1.0 / math.sqrt(hd),
                 DTYPE_CODE[q.dtype], stream)
    raise_on_launch_error(err, fn.__name__)
    return out


def paged_decode_attention(
    q: torch.Tensor,  # [BH, hd] bf16 | f32
    k_pool: torch.Tensor,  # [n_rows, P, hd] q's dtype
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [BH, W] int32
    seq_lens: torch.Tensor,  # [BH] int32
    *,
    q_per_kv: int = 1,
) -> torch.Tensor:
    """K1: paged decode attention on the card (see ``csrc/paged_decode.cu``).
    Rows come in groups of ``q_per_kv`` that share one kv head: equal
    table and length rows, whose pages the kernel loads once per group
    (1: every row its own group).  Unequal rows within a group are not
    detected: the group's first row then serves them all
    (:func:`cta_groups`)."""
    dims = _check_common(q, k_pool, v_pool, page_table, seq_lens, (q.dtype,))
    lib = _build.library("paged_decode")
    out = _launch(lib.launch_paged_decode, q, (k_pool, v_pool), (),
                  page_table, seq_lens, q_per_kv, dims)
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
    *,
    q_per_kv: int = 1,
) -> torch.Tensor:
    """K2: paged decode attention over int8 code pools on the card; rows
    grouped as in :func:`paged_decode_attention`."""
    dims = _check_common(q, k_pool, v_pool, page_table, seq_lens,
                         (torch.int8,))
    n_rows = dims[2]
    for s in (k_scales, v_scales):
        if not s.is_cuda or s.device != q.device:
            raise ValueError("paged decode kernel: scales must be on q's device")
        if s.dtype != torch.float32 or s.shape != (n_rows,):
            raise ValueError("paged decode kernel: scales must be f32 [n_rows]")
        if not s.is_contiguous():
            raise ValueError("paged decode kernel: scales must be contiguous")
    lib = _build.library("paged_decode")
    out = _launch(lib.launch_paged_decode_int8, q, (k_pool, v_pool),
                  (k_scales, v_scales), page_table, seq_lens, q_per_kv, dims)
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_int8.launches = 0
