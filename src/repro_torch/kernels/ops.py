"""Dispatch by device: the plain version for CPU tensors, the CUDA kernel
for CUDA tensors.  There is no fallback: a CUDA tensor the kernel cannot
take raises.  The one way to run a plain version on CUDA tensors is the
scoped :func:`plain_on_card`, for comparisons; the engine and the models
never enter it.

Training: the kernels write through ``ctypes`` into tensors autograd
cannot see into, so a call whose inputs need a gradient goes through a
``torch.autograd.Function`` whose backward is a kernel too: K3's forward
saving its log-sum-exp and K3's hand-written backward
(``flash_attention_bwd.cu``); K5 forward and K5's hand-written
backward (``grouped_matmul_bwd.cu``: both gradients in one launch,
reading the saved inputs in place); K6 forward and K6's hand-written
backward (``ssd_scan_bwd.cu``), which recomputes the chunks' states from
the saved inputs.  A kernel without a backward (K1, K2, K4: decode only)
raises ``NotImplementedError`` on a CUDA tensor that needs a gradient.
A call none of whose inputs needs a gradient, or made under
``torch.no_grad()``, launches exactly as the serving path always has.
On the CPU, and inside :func:`plain_on_card`, autograd differentiates
the plain versions."""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

from ..dist.sharding import is_dtensor
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import grouped_matmul as _gmm
from . import paged_decode, ref, spmd
from . import ssd_scan as _ssd

#: every kernel wrapper, for counting and resetting launches
WRAPPERS = (
    paged_decode.paged_decode_attention,
    paged_decode.paged_decode_attention_int8,
    _flash.flash_attention,
    _flash.flash_attention_bwd,
    _decode.decode_attention,
    _gmm.grouped_matmul,
    _gmm.grouped_matmul_bwd,
    _ssd.ssd_scan,
    _ssd.ssd_scan_bwd,
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


def plain_active() -> bool:
    """True inside :func:`plain_on_card` on this thread.  Autograd runs a
    checkpointed unit's recompute in a CUDA backward on its own device
    thread, which does not see this one's context: the recompute reads
    this at forward time and re-enters :func:`plain_on_card` itself."""
    return _PLAIN.get()


def _on_cpu(q: torch.Tensor) -> bool:
    """True where the plain version runs: CPU tensors, or CUDA tensors
    inside :func:`plain_on_card`."""
    if q.device.type == "cpu":
        return True
    if q.device.type == "cuda":
        return _PLAIN.get()
    raise ValueError(f"no kernel path for device {q.device}")


def _needs_grad(*tensors) -> bool:
    """True where autograd records this call: grad mode on and an input
    that requires a gradient."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors
    )


def _no_backward(name: str, why: str, *tensors) -> None:
    """Raise on a CUDA call that needs a gradient its kernel has not."""
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward ({why}); call it "
            "under torch.no_grad(), or on the CPU"
        )


class _FlashAttention(torch.autograd.Function):
    """K3 with K3's backward: the forward saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _flash.flash_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            return_lse=True,
        )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = _flash.flash_attention_bwd(
            q, k, v, out, dout.to(q.dtype), lse, causal=causal,
            window=window, q_offset=q_offset,
        )
        return dq, dk, dv, None, None, None


class _GroupedMatmul(torch.autograd.Function):
    """K5 with K5's backward: one launch of ``grouped_matmul_bwd`` gives
    dX[e] = dY[e] W[e]^T and dW[e] = X[e]^T dY[e] (the capacity axis the
    reduction), reading the saved x (a view with contiguous rows) and w
    in place: no transposed copy."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gmm.grouped_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return _gmm.grouped_matmul_bwd(x, w, dy.to(x.dtype).contiguous())


class _SsdScan(torch.autograd.Function):
    """K6 with K6's backward: the forward saves its inputs (x, dt, A, B,
    C), from which the backward recomputes the chunks' states."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, chunk):
        ctx.save_for_backward(x, dt, A, Bm, C)
        ctx.chunk = chunk
        return _ssd.ssd_scan(x, dt, A, Bm, C, chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, C = ctx.saved_tensors
        grads = _ssd.ssd_scan_bwd(x, dt, A, Bm, C,
                                  dy.float().contiguous(), ctx.chunk)
        return (*grads, None)


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
    _no_backward("paged_decode_attention", "decode only", q, k_pool, v_pool)
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
    _no_backward("paged_decode_attention_int8", "decode only", q)
    return paged_decode.paged_decode_attention_int8(
        q, k_pool, v_pool, k_scales, v_scales, page_table, seq_lens,
        q_per_kv=q_per_kv,
    )


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    chunk=512):
    """[B, H, Sq, hd] attention over grouped-query [B, KV, Sk, hd] K and
    [B, KV, Sk, vd] V, vd <= hd (K3); the output is [B, H, Sq, vd].
    ``chunk`` is the plain version's query block; the kernel tiles on
    its own.  Where an input needs a gradient, the kernel runs through
    :class:`_FlashAttention` (a narrow V zero-padded to q's width and the
    output sliced back in autograd, so the padding's gradient is
    dropped).  DTensors run it on their local shards (``spmd``)."""
    if is_dtensor(q):
        return spmd.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, chunk=chunk)
    if _on_cpu(q):
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            chunk=chunk,
        )
    if _needs_grad(q, k, v):
        vd, hd = v.shape[-1], q.shape[-1]
        if vd < hd:
            v = torch.nn.functional.pad(v, (0, hd - vd))
        out = _FlashAttention.apply(q, k, v, causal, window, q_offset)
        return out if vd == hd else out[..., :vd]
    return _flash.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset
    )


def decode_attention(q, k, v, cur_pos, *, window=0):
    """[B, H, hd] attention of one token per row over its slot's
    [B, KV, S, hd] cache up to ``cur_pos[b]`` (K4)."""
    if is_dtensor(q):
        return spmd.decode_attention(q, k, v, cur_pos, window=window)
    if _on_cpu(q):
        return ref.decode_attention_ref(q, k, v, cur_pos, window=window)
    _no_backward("decode_attention", "decode only", q, k, v)
    return _decode.decode_attention(q, k, v, cur_pos, window=window)


def grouped_matmul(x, w):
    """[E, C, D] x [E, D, F] -> [E, C, F] per expert, summed in f32, in
    x's dtype (K5): the expert GEMMs of an MoE layer."""
    if is_dtensor(x):
        return spmd.grouped_matmul(x, w)
    if _on_cpu(x):
        return ref.grouped_matmul_ref(x, w)
    if _needs_grad(x, w):
        return _GroupedMatmul.apply(x, w)
    return _gmm.grouped_matmul(x, w)


def ssd_scan(x, dt, A, Bm, C, chunk):
    """[B, S, nh, hd] Mamba-2 chunked SSD scan in f32, without the D skip
    and the gate (K6): every Mamba-2 prefill and training layer.  Where
    an input needs a gradient, the kernel runs through
    :class:`_SsdScan`."""
    if is_dtensor(x):
        return spmd.ssd_scan(x, dt, A, Bm, C, chunk)
    if _on_cpu(x):
        return ref.ssd_scan_ref(x, dt, A, Bm, C, chunk)
    if _needs_grad(x, dt, A, Bm, C):
        return _SsdScan.apply(x, dt, A, Bm, C, chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, C, chunk)
