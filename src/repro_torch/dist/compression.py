"""Symmetric int8 quantization (scale = amax/127, round half to even).

The host KV tier stores demoted pages as these codes.  Computed in
float32 on numpy arrays so the codes match the JAX package's byte for
byte: the scale is floored on amax (``max(amax, 1e-30) / 127``) and the
codes are clipped to ±127.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_QMAX = np.float32(127.0)


def quantize(x: np.ndarray) -> Tuple[np.ndarray, np.float32]:
    """x → (int8 codes, f32 scale); |dequantize(q, s) − x| ≤ s/2."""
    xf = np.asarray(x, np.float32)
    scale = np.maximum(np.max(np.abs(xf)), np.float32(1e-30)) / _QMAX
    q = np.clip(np.rint(xf / scale), -_QMAX, _QMAX).astype(np.int8)
    return q, np.float32(scale)


def dequantize(q: np.ndarray, scale) -> np.ndarray:
    return np.asarray(q).astype(np.float32) * np.float32(scale)
