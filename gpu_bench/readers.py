"""Arithmetic the metric readers (``metrics/<name>.py``) share: rates and
tails over a run's whole record, and kernels' shares of their roofline
from the calls recorded in the traced slice."""

from __future__ import annotations

import math
import statistics
from typing import List, Optional, Sequence

from . import work


def percentile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over an ascending-sorted sequence."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, round(q * (len(sorted_vals) - 1)))
    return sorted_vals[idx]


def window_tokens(rec) -> int:
    w0, w1 = rec["window"]
    return sum(1 for r in rec["requests"] for t in r["times"] if w0 <= t < w1)


def ttfts(rec) -> List[float]:
    """Time to first token (s) of every request due in the window, from
    when it was due; one that failed or has no first token is infinite."""
    w0, w1 = rec["window"]
    out = []
    for r in rec["requests"]:
        if not w0 <= r["due"] < w1:
            continue
        if r["times"] and r["state"] != "failed":
            out.append(r["times"][0] - r["due"])
        else:
            out.append(math.inf)
    return sorted(out)


def gaps(rec) -> List[float]:
    """Every gap (s) between two tokens of a request whose later token
    came inside the window."""
    w0, w1 = rec["window"]
    out = []
    for r in rec["requests"]:
        t = r["times"]
        out += [b - a for a, b in zip(t, t[1:]) if w0 <= b < w1]
    return sorted(out)


def p95_ms(vals: List[float]) -> Optional[float]:
    v = percentile(vals, 0.95)
    if v is None or math.isinf(v):
        return None
    return 1e3 * v


def tick_ms(rec) -> Optional[float]:
    if not rec["steps"]:
        return None
    return 1e3 * statistics.median(b - a for a, b, _, _ in rec["steps"])


# ------------------------------------------------------------ rooflines
#: each port kernel's __global__ functions (kernels/csrc/*.cu)
KERNELS = {
    "paged_decode_attention": ("paged_decode_kernel",),
    "flash_attention": ("flash_kernel", "flash_mma_kernel"),
    "flash_attention_bwd": ("delta_kernel", "dkdv_mma_kernel",
                            "dq_mma_kernel", "dkdv_wgmma_kernel",
                            "dq_wgmma_kernel", "dkdv_f32_kernel",
                            "dq_f32_kernel"),
    "grouped_matmul": ("gmm_simple_kernel", "gmm_tma_kernel"),
    "grouped_matmul_bwd": ("gmm_bwd_simple_kernel", "gmm_bwd_tma_kernel"),
}


def kernel_s(rec, kernel: str) -> float:
    from .trace import kernel_seconds

    return kernel_seconds(rec["trace"], KERNELS[kernel])


def share(bound_s: float, device_s: float) -> Optional[float]:
    if bound_s <= 0 or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def calls(rec, op: str, grad=None):
    return [(s, x) for n, s, x in rec["calls"] if n == op
            and (grad is None or x.get("grad") == grad)]


def paged_bound_s(rec) -> float:
    m = rec["model"]
    g = m["num_attention_heads"] // m["num_key_value_heads"]
    total = 0.0
    for shapes, x in calls(rec, "paged_decode_attention"):
        nb, fl = work.paged_decode_work(x["lens"].tolist(), g,
                                        m["head_dim"])
        total += work.bound(nb, fl)[0]
    return total


def flash_fwd_bound_s(rec, grad=None) -> float:
    total = 0.0
    for (q, k, v), x in calls(rec, "flash_attention", grad):
        nb, fl = work.flash_fwd_work(q[0], q[1], k[1], q[2], k[2], q[3],
                                     v[3], x.get("q_offset", 0))
        total += work.bound(nb, fl)[0]
    return total


def _bwd_per_forward(rec, op: str, bwd: str) -> float:
    """Backward launches of ``bwd`` in the slice per forward call of
    ``op`` that recorded a gradient (remat runs each forward twice)."""
    fwd = len(calls(rec, op, grad=True))
    n = rec["launches_slice"].get(bwd, 0)
    return n / fwd if fwd else 0.0


def flash_bwd_bound_s(rec) -> float:
    per = _bwd_per_forward(rec, "flash_attention", "flash_attention_bwd")
    total = 0.0
    for (q, k, v), x in calls(rec, "flash_attention", grad=True):
        nb, fl, _, _ = work.flash_bwd_work(q[0], q[1], k[1], q[2], q[3],
                                           v[3], True, 0)
        total += per * work.bound(nb, fl)[0]
    return total


def gmm_bwd_bound_s(rec) -> float:
    per = _bwd_per_forward(rec, "grouped_matmul", "grouped_matmul_bwd")
    total = 0.0
    for (x, w), _ in calls(rec, "grouped_matmul", grad=True):
        (nb, fl), _ = work.gmm_bwd_work(w[0], x[1], w[1], w[2])
        total += per * work.bound(nb, fl)[0]
    return total


# ------------------------------------------------------------- model FLOPs
def serve_slice_flops(rec) -> float:
    """Model FLOPs of the tokens the traced slice processed: prefill
    tokens over their causal context, decode rows over their lengths,
    counted from the attention calls (one per layer of every model call)
    and the configuration."""
    m = rec["model"]
    L, H = m["num_hidden_layers"], m["num_attention_heads"]
    tokens = ctx = rows = 0
    for (q, k, v), x in calls(rec, "flash_attention"):
        tokens += q[0] * q[2]
        ctx += q[0] * work.causal_pairs(q[2], k[2], x.get("q_offset", 0))
        rows += q[0]  # the last position of each prompt is unembedded
    for shapes, x in calls(rec, "paged_decode_attention"):
        lens = x["lens"].tolist()[::H]
        real = [n for n in lens if n > 0]
        tokens += len(real)
        ctx += sum(real)
        rows += len(real)
    for shapes, x in calls(rec, "decode_attention"):
        pos = x["pos"].reshape(-1).tolist()
        tokens += len(pos)
        rows += len(pos)
        ctx += sum(p + 1 for p in pos)
    return work.forward_flops(m, tokens / L, ctx / L, rows / L)
