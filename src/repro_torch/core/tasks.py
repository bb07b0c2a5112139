"""Task abstraction: read / process / write phases built from function APIs.

A task is implemented by at least one function API (paper §III-B).  The read
and write phases hold at most one *shuffle* API whose buffer is long-living;
process-phase APIs are constant-model (streaming) unless they cache, in which
case the model is redefined.  The live-memory growth of a task at any instant
is governed by its *current* phase's model — which is exactly what the
Sampler observes and the scheduler acts on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .usage_models import UsageModel, live_bytes_at

__all__ = ["ApiProfile", "Phase", "TaskSpec", "TaskState"]


@dataclass(frozen=True)
class ApiProfile:
    """Memory behaviour of one function API (e.g. ``groupByKey``)."""

    name: str
    model: UsageModel
    #: live-byte slope: bytes of long-living buffer per byte of input
    rate: float
    #: transient garbage produced per byte of input (young-gen pressure)
    garbage_per_byte: float = 1.0
    #: whether results are cached in memory (job-lifetime objects)
    caches: bool = False


@dataclass(frozen=True)
class Phase:
    """One phase of a task; ``span`` is the fraction of input it covers."""

    kind: str  # "read" | "process" | "write"
    api: ApiProfile
    span: float  # fraction of the task's input processed in this phase


@dataclass(frozen=True)
class TaskSpec:
    """Immutable description of a schedulable task."""

    task_id: str
    job_id: str
    stage: int
    input_bytes: float
    phases: List[Phase]
    #: bytes cached into job-lifetime memory when this task completes
    cache_on_complete: float = 0.0
    #: data-skew multiplier on buffer growth (hot keys, paper §VI-E)
    rate_multiplier: float = 1.0

    def __post_init__(self) -> None:
        total = sum(p.span for p in self.phases)
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"phase spans must sum to 1, got {total}")


@dataclass
class TaskState:
    """Mutable runtime state of a task inside the service executor."""

    spec: TaskSpec
    processed: float = 0.0  # input bytes consumed so far
    live: float = 0.0  # current long-living buffer bytes
    suspended: bool = False
    done: bool = False
    spills: int = 0
    spilled_bytes: float = 0.0
    spill_block_until: float = -1.0  # sim-time until which task is writing
    #: live bytes at the instant the current phase started (buffers from a
    #: finished read phase are handed to the next phase / released)
    _phase_base: float = 0.0
    _phase_idx: int = 0
    _phase_processed: float = 0.0

    @property
    def progress(self) -> float:
        if self.spec.input_bytes <= 0:
            return 1.0
        return min(self.processed / self.spec.input_bytes, 1.0)

    @property
    def current_phase(self) -> Optional[Phase]:
        if self._phase_idx < len(self.spec.phases):
            return self.spec.phases[self._phase_idx]
        return None

    def advance(self, nbytes: float) -> float:
        """Process ``nbytes`` more input; returns transient garbage produced.

        Live-buffer growth follows the current phase's usage model applied to
        bytes processed *within the phase* (models are independent with a
        strict order, paper §III-B).
        """
        garbage = 0.0
        remaining = nbytes
        while remaining > 1e-12 and not self.done:
            phase = self.current_phase
            if phase is None:
                self.done = True
                break
            phase_total = phase.span * self.spec.input_bytes
            take = min(remaining, max(phase_total - self._phase_processed, 0.0))
            self._phase_processed += take
            self.processed += take
            remaining -= take
            garbage += take * phase.api.garbage_per_byte
            self.live = self._phase_base + self.spec.rate_multiplier * live_bytes_at(
                phase.api.model,
                self._phase_processed,
                _slope(phase, phase_total),
            )
            if self._phase_processed >= phase_total * (1.0 - 1e-12):
                # Phase boundary: the shuffle buffer of a read phase is
                # consumed by the next phase; write-phase buffers persist
                # until task completion (then become dead-until-full-GC).
                self._phase_idx += 1
                self._phase_processed = 0.0
                self._phase_base = self.live if phase.kind != "read" else 0.0
                if phase.kind == "read":
                    self.live = self._phase_base
            if self.processed >= self.spec.input_bytes * (1.0 - 1e-12) or (
                self.current_phase is None
            ):
                self.done = True
        return garbage

    def spill(self, spillable_fraction: float = 0.6) -> float:
        """Spill the spillable part of the buffer to disk; returns bytes.

        The unspillable remainder models in-flight objects (a hot key's
        collection being materialized cannot be cut mid-record — the error
        source the paper discusses in §VI-E).
        """
        written = self.live * spillable_fraction
        self.spilled_bytes += written
        self.spills += 1
        self.live -= written
        self._phase_base = min(self._phase_base, self.live)
        # growth restarts from the retained remainder within the phase
        self._phase_processed = 0.0
        return written


def _slope(phase: Phase, phase_total: float) -> float:
    """Anchor the model curve so ``live(end) = rate × phase_input``.

    ``ApiProfile.rate`` is thereby interpreted uniformly across models as the
    buffer-to-input ratio at phase completion: a ``groupByKey`` that holds the
    whole partition has rate 1.0 whatever the curve shape; only the *path*
    (and hence the sampled memory usage rate / slope seen by MURS) differs
    between sub-linear, linear and super-linear.
    """
    from .usage_models import MODEL_EXPONENT

    api = phase.api
    if api.model is UsageModel.CONSTANT:
        return api.rate  # fixed working set in bytes (absolute)
    b = MODEL_EXPONENT[api.model]
    if phase_total <= 0.0:
        return 0.0
    return api.rate * phase_total / (phase_total**b)


def make_stage_tasks(
    job_id: str,
    stage: int,
    *,
    n_tasks: int,
    stage_input_bytes: float,
    phases: List[Phase],
    cache_total_bytes: float = 0.0,
    skew: float = 0.0,
    hot_fraction: float = 0.0,
    hot_api: Optional[ApiProfile] = None,
) -> List[TaskSpec]:
    """Split a stage's input evenly into ``n_tasks`` task specs.

    ``skew`` ∈ [0, 1] adds a deterministic heavy-tailed multiplier on buffer
    growth per task (hot keys): multiplier = (1-skew) + 4·skew·h³ with h a
    per-task hash in [0, 1) — a few tasks grow up to ~4×, most grow less.

    ``hot_fraction`` > 0 applies the paper's §III model *redefinition*: in a
    fraction of tasks the key distribution is not random (hot keys gather),
    so a sub-linear aggregating API degenerates — those tasks get their
    non-constant phases replaced by ``hot_api`` (typically a linear profile).
    """
    import hashlib

    per_task = stage_input_bytes / max(n_tasks, 1)
    cache_per_task = cache_total_bytes / max(n_tasks, 1)
    out = []
    for i in range(n_tasks):
        tid = f"{job_id}/s{stage}/t{i}"
        h = int(hashlib.md5(tid.encode()).hexdigest()[:8], 16) / 0xFFFFFFFF
        mult = (1.0 - skew) + 4.0 * skew * h**3 if skew > 0.0 else 1.0
        task_phases = phases
        if hot_api is not None and hot_fraction > 0.0 and h > 1.0 - hot_fraction:
            task_phases = [
                Phase(p.kind, hot_api, p.span)
                if p.api.model is not UsageModel.CONSTANT
                else p
                for p in phases
            ]
        out.append(
            TaskSpec(
                task_id=tid,
                job_id=job_id,
                stage=stage,
                input_bytes=per_task,
                phases=task_phases,
                cache_on_complete=cache_per_task,
                rate_multiplier=mult,
            )
        )
    return out
