"""Memory-usage models of function APIs / workloads (MURS §III).

A task's *live* (long-lifetime) memory grows with the amount of input it has
processed according to one of four coarse models:

    constant     — no K distinction, results streamed out (``map``, ``filter``)
    sub-linear   — distinguishes K, aggregates V, K appears randomly
                   (``reduceByKey``); accelerator analogue: prefix-shared / MLA-latent KV
    linear       — distinguishes K, no aggregation (``groupByKey``, ``sortByKey``
                   shuffle buffers); accelerator analogue: per-token KV-cache append
    super-linear — caches results that grow faster than input (histogram of all
                   divisors); accelerator analogue: beam / tree speculative decode

The *memory usage rate* is the local slope Δlive/Δprocessed — the uniform,
online-measurable criterion MURS schedules on (paper §III-B).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Sequence

__all__ = [
    "UsageModel",
    "live_bytes_at",
    "fit_power_law",
    "classify_exponent",
    "classify_trace",
    "RateEstimator",
]


class UsageModel(enum.Enum):
    """The four coarse-grained models of Fig. 2 in the paper."""

    CONSTANT = "constant"
    SUB_LINEAR = "sub_linear"
    LINEAR = "linear"
    SUPER_LINEAR = "super_linear"

    @property
    def order(self) -> int:
        """Scheduling preference order (paper: constant→sub→linear→super)."""
        return _MODEL_ORDER[self]


_MODEL_ORDER = {
    UsageModel.CONSTANT: 0,
    UsageModel.SUB_LINEAR: 1,
    UsageModel.LINEAR: 2,
    UsageModel.SUPER_LINEAR: 3,
}

#: Exponent of ``live = a * processed**b`` used when *generating* traces.
MODEL_EXPONENT = {
    UsageModel.CONSTANT: 0.0,
    UsageModel.SUB_LINEAR: 0.5,
    UsageModel.LINEAR: 1.0,
    UsageModel.SUPER_LINEAR: 1.5,
}


def live_bytes_at(model: UsageModel, processed: float, rate: float) -> float:
    """Live bytes after ``processed`` input bytes for a generating ``model``.

    ``rate`` is the nominal slope at full input for the linear model; for the
    other models it scales the curve so that all models are comparable at the
    same nominal rate (slope-matched at processed == 1.0 unit for linear).
    """
    if processed <= 0.0:
        return 0.0
    b = MODEL_EXPONENT[model]
    if b == 0.0:
        return rate  # a fixed working set, independent of input volume
    return rate * processed**b


def fit_power_law(
    processed: Sequence[float], live: Sequence[float]
) -> tuple[float, float]:
    """Least-squares fit of ``live ≈ a * processed**b`` in log-log space.

    Returns ``(a, b)``.  Points with non-positive coordinates are dropped;
    with fewer than two usable points the fit degenerates to ``(last, 0)``.
    """
    xs, ys = [], []
    for p, l in zip(processed, live):
        if p > 0.0 and l > 0.0:
            xs.append(math.log(p))
            ys.append(math.log(l))
    n = len(xs)
    if n < 2:
        return (live[-1] if live else 0.0, 0.0)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx <= 1e-12:
        return (math.exp(my), 0.0)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    a = math.exp(my - b * mx)
    return (a, b)


def classify_exponent(b: float) -> UsageModel:
    """Map a fitted growth exponent to one of the four models."""
    if b < 0.2:
        return UsageModel.CONSTANT
    if b < 0.8:
        return UsageModel.SUB_LINEAR
    if b <= 1.2:
        return UsageModel.LINEAR
    return UsageModel.SUPER_LINEAR


def classify_trace(
    processed: Sequence[float], live: Sequence[float]
) -> UsageModel:
    """Classify a sampled (processed, live) trace into a usage model.

    Constant traces are detected directly (near-zero relative growth) because
    a power-law fit is ill-conditioned when live barely moves.
    """
    if len(live) >= 2:
        lo, hi = min(live), max(live)
        if hi <= 0.0 or (hi - lo) <= 0.05 * max(hi, 1e-9):
            return UsageModel.CONSTANT
    _, b = fit_power_law(processed, live)
    return classify_exponent(b)


@dataclass
class RateEstimator:
    """Online memory-usage-rate estimator over a sliding sample window.

    The paper computes the rate as the quotient of two increments,
    ``Δsize_used_memory / Δsize_processed_records`` (§V), and keeps a buffer
    of computed values whose *trend* determines the model.
    """

    window: int = 32
    _processed: list[float] = field(default_factory=list)
    _live: list[float] = field(default_factory=list)

    def update(self, processed_bytes: float, live_bytes: float) -> None:
        self._processed.append(float(processed_bytes))
        self._live.append(float(live_bytes))
        if len(self._processed) > self.window:
            del self._processed[0]
            del self._live[0]

    @property
    def samples(self) -> int:
        return len(self._processed)

    @property
    def rate(self) -> float:
        """Current Δlive/Δprocessed slope (most recent increment pair)."""
        if len(self._processed) < 2:
            return 0.0
        dp = self._processed[-1] - self._processed[0]
        dl = self._live[-1] - self._live[0]
        if dp <= 0.0:
            return 0.0
        return max(dl / dp, 0.0)

    @property
    def model(self) -> UsageModel:
        if len(self._processed) < 3:
            return UsageModel.CONSTANT
        return classify_trace(self._processed, self._live)
