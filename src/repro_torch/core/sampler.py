"""The MURS Sampler (paper §V).

Runs "seasonally" (periodically); for every running task it records the
metrics the scheduler consumes:

    * bytes of input processed so far / total input bytes  → completion %
    * live (long-lifetime) bytes currently attributed to the task
    * the memory-usage-rate estimate Δlive/Δprocessed and its model trend

The sampler is shared verbatim between the Spark-fidelity simulator
(`spark_sim.py`) and the PyTorch serving engine (`repro_torch.serve.engine`): both feed
it (processed, live) observations; neither needs JVM tracing because the
accounting layers know exactly which bytes are live.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable

from .usage_models import RateEstimator, UsageModel

__all__ = ["TaskStats", "Sampler"]


@dataclass
class TaskStats:
    """Snapshot of one running task, as consumed by Algorithm 1."""

    task_id: str
    consumption: float  # live bytes currently attributed to the task
    rate: float  # Δlive / Δprocessed (memory usage rate)
    progress: float  # fraction of input processed, in [0, 1]
    remaining_bytes: float = 0.0  # input bytes still to process
    model: UsageModel = UsageModel.CONSTANT
    #: scheduling group the task belongs to (job id in the simulator,
    #: tenant in the serving engine) — consumed by tenant-aware policies
    group: str = ""

    @property
    def memory_necessary(self) -> float:
        """Projected additional live bytes to finish.

        Paper §III-B: "we use the current memory usage model to calculate
        the memory usage of the task" — the model-aware projection is
        rate × remaining input.  The pseudocode's c × (1 − done%) variant
        underestimates early in a task's life; we take the max of the two
        (conservative, still cheap to compute online).
        """
        return max(
            self.rate * self.remaining_bytes,
            self.consumption * (1.0 - self.progress),
        )

    @property
    def projected_total(self) -> float:
        """Projected total consumption at completion: c / done%."""
        if self.progress <= 1e-9:
            return float("inf")
        return self.consumption / self.progress


@dataclass
class Sampler:
    """Per-task metric store with online rate estimation."""

    window: int = 32
    _estimators: Dict[str, RateEstimator] = field(default_factory=dict)
    _progress: Dict[str, float] = field(default_factory=dict)
    _consumption: Dict[str, float] = field(default_factory=dict)
    _remaining: Dict[str, float] = field(default_factory=dict)
    _group: Dict[str, str] = field(default_factory=dict)

    def observe(
        self,
        task_id: str,
        *,
        processed_bytes: float,
        total_bytes: float,
        live_bytes: float,
        group: str = "",
    ) -> None:
        est = self._estimators.get(task_id)
        if est is None:
            est = self._estimators[task_id] = RateEstimator(window=self.window)
        est.update(processed_bytes, live_bytes)
        self._consumption[task_id] = live_bytes
        if total_bytes > 0:
            self._progress[task_id] = min(processed_bytes / total_bytes, 1.0)
        else:
            self._progress[task_id] = 1.0
        self._remaining[task_id] = max(total_bytes - processed_bytes, 0.0)
        if group:
            self._group[task_id] = group

    def forget(self, task_id: str) -> None:
        self._estimators.pop(task_id, None)
        self._progress.pop(task_id, None)
        self._consumption.pop(task_id, None)
        self._remaining.pop(task_id, None)
        self._group.pop(task_id, None)

    def stats(self, task_ids: Iterable[str]) -> list[TaskStats]:
        out = []
        for tid in task_ids:
            est = self._estimators.get(tid)
            out.append(
                TaskStats(
                    task_id=tid,
                    consumption=self._consumption.get(tid, 0.0),
                    rate=est.rate if est else 0.0,
                    progress=self._progress.get(tid, 0.0),
                    remaining_bytes=self._remaining.get(tid, 0.0),
                    model=est.model if est else UsageModel.CONSTANT,
                    group=self._group.get(tid, ""),
                )
            )
        return out
