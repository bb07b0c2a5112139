"""Dispatch by device: the plain version for CPU tensors, the CUDA kernel
for CUDA tensors.  There is no fallback: a CUDA tensor the kernel cannot
take raises.  The one way to run a plain version on CUDA tensors is the
scoped :func:`plain_on_card`, for comparisons; the engine and the models
never enter it."""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import grouped_matmul as _gmm
from . import paged_decode, ref
from . import ssd_scan as _ssd

#: every kernel wrapper, for counting and resetting launches
WRAPPERS = (
    paged_decode.paged_decode_attention,
    paged_decode.paged_decode_attention_int8,
    _flash.flash_attention,
    _decode.decode_attention,
    _gmm.grouped_matmul,
    _ssd.ssd_scan,
)

#: True inside :func:`plain_on_card` (per thread and task, not global)
_PLAIN = contextvars.ContextVar("plain_on_card", default=False)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


@contextlib.contextmanager
def plain_on_card() -> Iterator[None]:
    """Inside this block CUDA tensors take the plain versions too, and no
    kernel launches (its counter does not move): the reference side of a
    kernel-against-plain comparison on the card."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def _on_cpu(q: torch.Tensor) -> bool:
    """True where the plain version runs: CPU tensors, or CUDA tensors
    inside :func:`plain_on_card`."""
    if q.device.type == "cpu":
        return True
    if q.device.type == "cuda":
        return _PLAIN.get()
    raise ValueError(f"no kernel path for device {q.device}")


def paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens, *,
                           q_per_kv=1):
    """[BH, hd] attention of each row over its pool pages (see ``ref``).
    ``q_per_kv``: rows come in groups of that many that share one kv
    head, with equal table and length rows; the kernel loads their pages
    once per group and reads only the first row's table and length, so
    unequal rows in a group give the other rows wrong attention, with no
    error.  The plain version needs no grouping."""
    if _on_cpu(q):
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, page_table, seq_lens
        )
    return paged_decode.paged_decode_attention(
        q, k_pool, v_pool, page_table, seq_lens, q_per_kv=q_per_kv
    )


def paged_decode_attention_int8(
    q, k_pool, v_pool, k_scales, v_scales, page_table, seq_lens, *,
    q_per_kv=1,
):
    """As :func:`paged_decode_attention` over int8 code pools with
    per-page f32 scales."""
    if _on_cpu(q):
        return ref.paged_decode_attention_int8_ref(
            q, k_pool, v_pool, k_scales, v_scales, page_table, seq_lens
        )
    return paged_decode.paged_decode_attention_int8(
        q, k_pool, v_pool, k_scales, v_scales, page_table, seq_lens,
        q_per_kv=q_per_kv,
    )


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    chunk=512):
    """[B, H, Sq, hd] attention over grouped-query [B, KV, Sk, hd] K and
    [B, KV, Sk, vd] V, vd <= hd (K3); the output is [B, H, Sq, vd].
    ``chunk`` is the plain version's query block; the kernel tiles on
    its own."""
    if _on_cpu(q):
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            chunk=chunk,
        )
    return _flash.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset
    )


def decode_attention(q, k, v, cur_pos, *, window=0):
    """[B, H, hd] attention of one token per row over its slot's
    [B, KV, S, hd] cache up to ``cur_pos[b]`` (K4)."""
    if _on_cpu(q):
        return ref.decode_attention_ref(q, k, v, cur_pos, window=window)
    return _decode.decode_attention(q, k, v, cur_pos, window=window)


def grouped_matmul(x, w):
    """[E, C, D] x [E, D, F] -> [E, C, F] per expert, summed in f32, in
    x's dtype (K5): the expert GEMMs of an MoE layer."""
    if _on_cpu(x):
        return ref.grouped_matmul_ref(x, w)
    return _gmm.grouped_matmul(x, w)


def ssd_scan(x, dt, A, Bm, C, chunk):
    """[B, S, nh, hd] Mamba-2 chunked SSD scan in f32, without the D skip
    and the gate (K6): every Mamba-2 prefill layer."""
    if _on_cpu(x):
        return ref.ssd_scan_ref(x, dt, A, Bm, C, chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, C, chunk)
