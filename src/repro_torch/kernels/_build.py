"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source is compiled on its own for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
keyed by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, under ``build/repro_torch/``
at the root of the checkout.  The build runs at first use, or for every
source at once through :func:`build` (one nvcc per source, all started
together); importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C signature of every exported function, by source: name -> argtypes
#: (restype int, the launch's cudaError)
SIGNATURES: Dict[str, Dict[str, List]] = {
    "paged_decode": {
        "launch_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P,
                                *[_I] * 8, _F, _I, _P],
        "launch_paged_decode_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     *[_I] * 8, _F, _I, _P],
    },
    "flash_attention": {
        "launch_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, *[_L] * 12, _I, _I, _I, _F, _I, _P],
    },
    "flash_attention_bwd": {
        "launch_flash_attention_bwd": [*[_P] * 10, *[_I] * 6, *[_L] * 24,
                                       _I, _I, _I, _F, _I, _I, _P],
    },
    "decode_attention": {
        "launch_decode_attention": [_P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, *[_L] * 8,
                                    _I, _I, _I, _I, _F, _I, _P],
    },
    "grouped_matmul": {
        "launch_grouped_matmul": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _P],
    },
    "grouped_matmul_bwd": {
        "launch_grouped_matmul_bwd": [*[_P] * 5, *[_I] * 4, _L, _L, _I, _P],
    },
    "ssd_scan": {
        "launch_ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P],
    },
    "ssd_scan_bwd": {
        "launch_ssd_scan_bwd": [*[_P] * 21, *[_I] * 6, _P],
    },
}
#: the kernels' dtype codes (the ``dtype`` argument of every launch)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else ``$CUDA_HOME/bin/nvcc``; raises if neither."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "cannot be built"
    )


def _target(name: str) -> Path:
    """The library path, keyed by the source, the shared headers it may
    include, and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compile every named source that is not built yet: one nvcc per
    source, all started together and all waited for; then raises with
    nvcc's output if any of them failed."""
    started = []
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in started:
        log = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):"
                          f"\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes``/``restype`` set for every exported function."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def raise_on_launch_error(err: int, fn: str) -> None:
    """Raise if a launch function returned a non-zero cudaError."""
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")


def row_strides(t: torch.Tensor, what: str) -> List[int]:
    """Element strides of every dimension of ``t`` but the last (0 for a
    dimension of size 1), after checking what the kernels' 16-byte loads
    need: a contiguous last dimension and every row 16-byte aligned.
    Raises ``ValueError`` otherwise."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{what}: the last dimension must be contiguous")
    strides = [0 if n == 1 else s for n, s in zip(t.shape[:-1], t.stride()[:-1])]
    if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in strides):
        raise ValueError(f"{what}: rows must be 16-byte aligned")
    return strides
