"""Wrapper of the CUDA SSD-scan kernel K6 (``csrc/ssd_scan.cu``).

It checks device, dtype, shape and contiguity and raises on anything the
kernel does not take, allocates the output and, for a scan longer than
one chunk, the kernel's scratch (per-chunk running decays, totals and
states, and the chunks' score tiles and C^T tiles, in one buffer) with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch reports an error, and adds one to ``launches`` (one
per call, though the source runs two ``__global__`` kernels for it when
S > chunk, one otherwise).  It takes CUDA tensors only: the plain
version is
:func:`repro_torch.kernels.ref.ssd_scan_ref`, and
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
    args = {"x": x, "dt": dt, "A": A, "Bm": Bm, "C": C}
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
    if min(b, s, nh, hd, ds) < 1:
        raise ValueError("ssd scan kernel: empty dimension")
    if not 1 <= chunk <= MAX_CHUNK or hd > MAX_HEAD_DIM or ds > MAX_STATE:
        raise ValueError(
            f"ssd scan kernel: chunk {chunk}, hd {hd}, ds {ds}; the kernel "
            f"takes chunk <= {MAX_CHUNK}, hd <= {MAX_HEAD_DIM}, "
            f"ds <= {MAX_STATE}"
        )
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
