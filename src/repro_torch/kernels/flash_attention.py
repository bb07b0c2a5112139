"""Wrappers of the CUDA flash-attention kernel K3
(``csrc/flash_attention.cu``) and of its backward
(``csrc/flash_attention_bwd.cu``).

Each checks device, dtype, shape, strides and alignment and raises on
anything its kernel does not take, allocates its outputs with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch reports an error, and adds one to its
``launches``.  They take CUDA tensors only: the plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref` (autodiff of it is
the backward's plain version), and :mod:`repro_torch.kernels.ops`
chooses between them.
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
    return_lse: bool = False,
):
    """K3: causal / sliding-window attention with grouped-query heads on
    the card.  With ``return_lse`` it returns ``(out, lse)``: also each
    row's natural log-sum-exp of its scaled scores, f32 [B, H, Sq], which
    :func:`flash_attention_bwd` recomputes the probabilities from (the
    serving path asks for none, and the kernel then writes none).  The operands may be strided views (the model's transposed
    projections); the output is a [B, H, Sq, hd] view of a [B, Sq, H, hd]
    buffer, so the caller's transpose back to [B, Sq, H·hd] is free.

    V may be narrower than q/k (MLA: q/k 192 wide, V 128), as the JAX
    package's ``chunked_attention`` allows.  The kernel takes one head
    width, so V is zero-padded to q's width, the scale stays
    1/sqrt(q's width), and the output is the first ``vd`` columns: the
    zero columns add nothing to the kept ones.  Reading only ``vd``
    columns of V is later work (ROADMAP, "Held until a benchmark PR is
    accepted": kernels slower than their PyTorch call, item 3)."""
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
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, kv, sq, sk, hd, *strides[0], *strides[1], *strides[2],
            *out.stride()[:3], int(causal), window, q_offset,
            1.0 / math.sqrt(hd), DTYPE_CODE[q.dtype], stream,
        )
    raise_on_launch_error(err, "flash_attention")
    flash_attention.launches += 1
    out = out if vd == hd else out[..., :vd]
    return (out, lse) if return_lse else out


flash_attention.launches = 0

#: K3's backward routes, the kernels each dtype and head width take:
#: "wgmma" (bf16 at hd 64 and 128: warpgroup products fed by TMA, the
#: H100 design), "mma" (bf16 at every other hd — MLA's 192, gemma3's 256
#: and the narrow test widths — keeps the mma.sync kernels: at hd 256 a
#: 64-key warpgroup would hold about 256 f32 accumulators a thread for dK
#: and dV), "f32" (the CUDA-core kernels of the f32 reference checks)
WGMMA_HEAD_DIMS = (64, 128)
ROUTE_CODE = {"f32": 0, "mma": 1, "wgmma": 2}


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The route of K3's backward for ``dtype`` and head width ``hd``."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma"


def flash_attention_bwd(
    q: torch.Tensor,  # [B, H, Sq, hd] bf16 | f32
    k: torch.Tensor,  # [B, KV, Sk, hd]
    v: torch.Tensor,  # [B, KV, Sk, hd]: as wide as q (pad a narrow V)
    out: torch.Tensor,  # [B, H, Sq, hd]: K3's output of these inputs
    dout: torch.Tensor,  # [B, H, Sq, hd]: the gradient of ``out``
    lse: torch.Tensor,  # [B, H, Sq] f32: K3's ``return_lse``
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
):
    """K3's backward on the card: ``(dq, dk, dv)`` of the attention K3
    computed, in the inputs' dtype, each a view of a [B, S, heads, hd]
    buffer (the layout the model's projections transpose back for free).
    Three kernels: D = rowsum(dO o O), then dK/dV per (batch, kv head,
    key block) summed over the group's q heads, then dQ per (batch, q
    head, query block), on the route :func:`bwd_route` names;
    deterministic (no atomics).  One call adds one to ``launches``,
    whichever the route.  The mask is the forward's; a row that keeps no key
    (its output was the mean of V) adds P dO = dO / Sk to every key's dV
    and nothing to dq or dk."""
    tensors = (q, k, v, out, dout)
    if not all(t.is_cuda for t in tensors + (lse,)):
        raise ValueError("flash attention backward: every tensor must be on "
                         "CUDA")
    if any(t.device != q.device for t in tensors + (lse,)):
        raise ValueError("flash attention backward: tensors on different "
                         "devices")
    if q.dtype not in DTYPE_CODE or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("flash attention backward: q, k, v, out and dout "
                        "of one dtype, float32 or bfloat16")
    if lse.dtype != torch.float32:
        raise TypeError("flash attention backward: lse must be float32")
    if any(t.dim() != 4 for t in tensors):
        raise ValueError("flash attention backward: 4-D q, k, v, out, dout")
    b, h, sq, hd = q.shape
    _, kv, sk, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != hd or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape
            or tuple(lse.shape) != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError("flash attention backward: shapes q/out/dout "
                         "[B, H, Sq, hd], k/v [B, KV, Sk, hd], lse "
                         "[B, H, Sq] contiguous")
    if kv < 1 or h % kv:
        raise ValueError(f"flash attention backward: {h} q heads over {kv} "
                         "kv heads")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"flash attention backward: hd {hd} not a multiple "
                         "of 8 in [8, 256]")
    if window < 0 or q_offset < 0:
        raise ValueError("flash attention backward: window and q_offset "
                         "must be >= 0")
    what = "flash attention backward"
    ins = []
    for t in tensors:
        try:
            row_strides(t, what)
        except ValueError:
            t = t.contiguous()  # an autograd gradient may come any way
        ins.append(t)
    q, k, v, out, dout = ins
    strides = [row_strides(t, what) for t in ins]
    dq = torch.empty((b, sq, h, hd), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, kv, hd), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    # D, and the wgmma route's LSE log2(e) beside it, over rows padded to
    # a 64-row tile
    delta = torch.empty(2 * b * h * (-(-sq // 64) * 64), dtype=torch.float32,
                        device=q.device)
    lib = _build.library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, h, kv, sq, sk, hd,
            *[s for st in strides for s in st],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            int(causal), window, q_offset, 1.0 / math.sqrt(hd),
            DTYPE_CODE[q.dtype], ROUTE_CODE[bwd_route(q.dtype, hd)], stream,
        )
    raise_on_launch_error(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
