"""Wrappers of the CUDA SSD-scan kernel K6 (``csrc/ssd_scan.cu``) and of
its backward (``csrc/ssd_scan_bwd.cu``).

Each checks device, dtype, shape and contiguity and raises on anything
its kernel does not take, allocates its outputs and scratch with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch reports an error, and adds one to its ``launches``
(one per call, though the sources run several ``__global__`` kernels for
it).  The forward's scratch holds per-chunk running decays, totals and
states, and the chunks' score tiles and C^T tiles, in one buffer; the
backward's the same decays and totals, each chunk's incoming state and
the gradient of its outgoing one, the score tiles, per head group the
summed ds and the dB and dC terms, and per (chunk, head) the
per-position terms and the share of dA.  They take CUDA tensors only:
the plain versions are :func:`repro_torch.kernels.ref.ssd_scan_ref` and
:func:`repro_torch.kernels.ref.ssd_scan_bwd_ref`, and
:mod:`repro_torch.kernels.ops` chooses between the two.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import raise_on_launch_error

#: the kernel's limits: chunk length, head dim, state dim
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128
#: rows and columns of the kernel's square score tiles
TILE = 64
#: the backward's heads per group (the heads one CTA item walks, whose ds
#: it sums before the products over ds) and its per-position terms
HEAD_GROUP, BWD_TERMS = 16, 9


def _check(x, dt, A, Bm, C, chunk, dy=None):
    """Raise on what the kernels do not take; returns (B, S, nh, hd,
    ds).  ``dy``: the backward's gradient of y, of x's shape."""
    args = {"x": x, "dt": dt, "A": A, "Bm": Bm, "C": C}
    if dy is not None:
        args["dy"] = dy
    for name, t in args.items():
        if not t.is_cuda:
            raise ValueError(f"ssd scan kernel: {name} must be on CUDA")
        if t.device != x.device:
            raise ValueError("ssd scan kernel: inputs on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd scan kernel: {name} is {t.dtype}, not "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"ssd scan kernel: {name} must be contiguous")
    if x.dim() != 4:
        raise ValueError("ssd scan kernel: x [B, S, nh, hd]")
    b, s, nh, hd = x.shape
    ds = Bm.shape[-1]
    if (tuple(dt.shape) != (b, s, nh) or tuple(A.shape) != (nh,)
            or tuple(Bm.shape) != (b, s, ds) or tuple(C.shape) != (b, s, ds)):
        raise ValueError(
            f"ssd scan kernel: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
            f"C {tuple(C.shape)} do not match"
        )
    if dy is not None and dy.shape != x.shape:
        raise ValueError("ssd scan kernel: dy must have x's shape")
    if min(b, s, nh, hd, ds) < 1:
        raise ValueError("ssd scan kernel: empty dimension")
    if not 1 <= chunk <= MAX_CHUNK or hd > MAX_HEAD_DIM or ds > MAX_STATE:
        raise ValueError(
            f"ssd scan kernel: chunk {chunk}, hd {hd}, ds {ds}; the kernel "
            f"takes chunk <= {MAX_CHUNK}, hd <= {MAX_HEAD_DIM}, "
            f"ds <= {MAX_STATE}"
        )
    return b, s, nh, hd, ds


def ssd_scan(
    x: torch.Tensor,  # [B, S, nh, hd] f32
    dt: torch.Tensor,  # [B, S, nh] f32, post-softplus
    A: torch.Tensor,  # [nh] f32, negative
    Bm: torch.Tensor,  # [B, S, ds] f32
    C: torch.Tensor,  # [B, S, ds] f32
    chunk: int,
) -> torch.Tensor:
    """K6: the Mamba-2 chunked SSD scan on the card; any S (the last
    chunk may be ragged), chunk <= 256, hd <= 64, ds <= 128.  Returns a
    contiguous y [B, S, nh, hd] f32, without the D skip and the gate."""
    b, s, nh, hd, ds = _check(x, dt, A, Bm, C, chunk)
    nc = -(-s // chunk)
    empty = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((b, s, nh, hd), **empty)
    ptrs = [None] * 5  # one chunk: the kernel reads no scratch
    if nc > 1:
        tiles = -(-chunk // TILE)
        # seg, total, each chunk's outgoing state (d-major), the lower
        # triangle of each chunk's score tiles and each query tile's C^T,
        # each at a 256-byte offset
        sizes = [b * nh * nc * chunk, b * nh * nc, b * nh * nc * ds * hd,
                 b * nc * tiles * (tiles + 1) // 2 * TILE * TILE,
                 b * nc * tiles * ds * TILE]
        sizes = [-(-n // 64) * 64 for n in sizes]
        scratch = torch.empty(sum(sizes), **empty)
        base = scratch.data_ptr()
        for i, n in enumerate(sizes):
            ptrs[i] = base
            base += 4 * n
    lib = _build.library("ssd_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), y.data_ptr(), *ptrs, b, s, nh, hd, ds, chunk,
            stream,
        )
    raise_on_launch_error(err, "ssd_scan")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0


def ssd_scan_bwd(
    x: torch.Tensor,  # [B, S, nh, hd] f32
    dt: torch.Tensor,  # [B, S, nh] f32, post-softplus
    A: torch.Tensor,  # [nh] f32, negative
    Bm: torch.Tensor,  # [B, S, ds] f32
    C: torch.Tensor,  # [B, S, ds] f32
    dy: torch.Tensor,  # [B, S, nh, hd] f32: the gradient of K6's y
    chunk: int,
):
    """K6's backward on the card: ``(dx, ddt, dA, dB, dC)`` of the scan
    :func:`ssd_scan` computes from these inputs, under ``dy``, all f32
    and contiguous, in the order of work of
    :func:`repro_torch.kernels.ref.ssd_scan_bwd_ref`.  Eight kernels
    (seven for a scan of one chunk); the chunks' states are recomputed
    from the inputs, not saved by the forward; the score tiles and the
    products over ds run once per chunk, on the heads' summed ds;
    deterministic (no atomics).  The kernel's limits are the forward's."""
    b, s, nh, hd, ds = _check(x, dt, A, Bm, C, chunk, dy=dy)
    nc = -(-s // chunk)
    empty = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, s, nh, hd), **empty)
    ddt = torch.empty((b, s, nh), **empty)
    dA = torch.empty((nh,), **empty)
    dB = torch.empty((b, s, ds), **empty)
    dC = torch.empty((b, s, ds), **empty)
    # seg, total, H_in and dS per chunk (past one chunk); the chunks'
    # score tiles, once for every head; per head group the summed ds of
    # each tile pair and the dC and dB terms; each (chunk, head)'s
    # per-position terms and share of dA; 256-byte offsets
    tiles = -(-chunk // TILE)
    pairs = tiles * (tiles + 1) // 2
    groups = -(-nh // HEAD_GROUP)
    state = b * nh * nc * hd * ds if nc > 1 else 0
    sizes = [b * nh * nc * chunk, b * nh * nc, state, state,
             b * nc * pairs * TILE * TILE,
             b * nc * groups * pairs * TILE * TILE,
             b * nc * groups * chunk * ds, b * nc * groups * chunk * ds,
             b * nc * nh * BWD_TERMS * chunk, b * nc * nh]
    sizes = [-(-n // 64) * 64 for n in sizes]
    scratch = torch.empty(sum(sizes), **empty)
    ptrs, base = [], scratch.data_ptr()
    for n in sizes:
        ptrs.append(base if n else None)
        base += 4 * n
    lib = _build.library("ssd_scan_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.launch_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), *ptrs, b, s, nh,
            hd, ds, chunk, stream,
        )
    raise_on_launch_error(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC


ssd_scan_bwd.launches = 0
