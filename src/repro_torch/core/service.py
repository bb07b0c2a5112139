"""Multi-tenant service executor scheduling through the policy layer.

Discrete-time executor model of one Spark executor JVM (the paper runs four
identical workers; we simulate one executor on its 1/4 data share — jobs are
embarrassingly parallel across executors so aggregate ratios are preserved).

The executor owns:
  * ``cores`` hardware threads running tasks,
  * a :class:`MemoryPool` (the JVM heap) with young/old accounting,
  * a GC cost model (minor + full, stop-the-world),
  * a spill model (fair-share violation under a nearly-full heap),
  * a :class:`repro_torch.sched.SchedulingPolicy` — :class:`FairPolicy` (the
    Spark baseline), :class:`MursPolicy` (Algorithm 1), or any other
    implementation of the protocol.

Jobs are DAGs of stages; a stage's tasks become runnable when the previous
stage of that job completes.  Core handout each tick is the policy's
``assign`` hook (FAIR/MURS: round-robin across jobs, as Spark's fair
scheduler pool does across tenants; PriorityPolicy: weighted stride).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..sched import FairPolicy, MursConfig, MursPolicy, SchedulingPolicy
from ..sched.protocol import SchedulingDecision

from .memory_manager import MemoryPool
from .sampler import Sampler
from .tasks import TaskSpec, TaskState

__all__ = ["GcModel", "JobSpec", "JobMetrics", "ServiceMetrics", "ServiceExecutor"]

DEAD = "__dead__"  # pool owner holding dead-but-unreclaimed old-gen bytes


@dataclass(frozen=True)
class GcModel:
    """JVM garbage-collection cost model (stop-the-world)."""

    young_fraction: float = 0.2  # young generation share of the heap
    minor_pause_base: float = 0.01  # seconds
    #: survivor copy is pointer-chasing + card marking — slow per byte
    copy_bandwidth: float = 0.3e9  # bytes/s survivor copy rate (minor)
    #: every minor GC also scans old-gen card tables / remembered sets —
    #: the pause component that makes long-living data tax *all* tasks
    #: ("long-living objects incur significant memory and CPU overheads")
    old_scan_bandwidth: float = 3e9  # bytes of old-gen live scanned per s
    full_pause_base: float = 0.2  # seconds
    mark_bandwidth: float = 2e9  # bytes/s live mark+compact rate (full)
    #: full GC triggers when (live+dead) exceeds this fraction of the heap.
    #: The headroom between fulls is therefore DYNAMIC: trigger×cap − floor,
    #: where floor is the surviving live set — a scheduler that shrinks the
    #: floor (fewer concurrent buffers) gets superlinearly fewer full GCs,
    #: and one that lets the floor cross the trigger enters permanent thrash.
    full_trigger: float = 0.65
    #: back-off between fulls while thrashing (floor ≥ trigger even after
    #: collection — the concurrent-mode-failure regime)
    full_cooldown: float = 3.0
    #: minimum young-gen working space; OOM if it cannot be maintained
    young_min_fraction: float = 0.08


def pressure_slowdown(used_fraction: float) -> float:
    """Mutator throughput multiplier as a function of heap occupancy.

    The paper's central observation (§II): as free memory shrinks, *the task
    computation suffers* — every allocation becomes slower (TLAB refill
    failures, allocation stalls, fragmentation, collector back-pressure).
    This is the schedule-DEPENDENT cost that a memory-pressure-aware
    scheduler can actually remove: FAIR lets occupancy sit near the top and
    pays it on every record of every task; MURS holds occupancy below the
    knee.  Piecewise-linear knee curve:

        u ≤ 0.55        → 1.0   (no pressure)
        0.55 < u ≤ 0.80 → 1.0 → 0.55
        0.80 < u ≤ 0.95 → 0.55 → 0.25
        u > 0.95        → 0.20  (allocation-stall regime)
    """
    if used_fraction <= 0.55:
        return 1.0
    if used_fraction <= 0.80:
        return 1.0 + (used_fraction - 0.55) * (0.55 - 1.0) / 0.25
    if used_fraction <= 0.95:
        return 0.55 + (used_fraction - 0.80) * (0.25 - 0.55) / 0.15
    return 0.20


@dataclass(frozen=True)
class SpillModel:
    """Spark-1.6-style execution-memory spill behaviour."""

    #: unified execution+storage memory fraction (spark.memory.fraction)
    exec_fraction: float = 0.6
    #: fraction of a buffer that can actually be written out (the rest is
    #: in-flight objects — hot-key collections mid-materialization)
    spillable_fraction: float = 0.7


@dataclass(frozen=True)
class JobSpec:
    job_id: str
    stages: List[List[TaskSpec]]  # stages in order; tasks per stage
    submit_time: float = 0.0


@dataclass
class JobMetrics:
    job_id: str
    submit_time: float = 0.0
    finish_time: float = -1.0
    gc_time: float = 0.0
    spills: int = 0
    spilled_bytes: float = 0.0
    oom: bool = False
    tasks_total: int = 0

    @property
    def exec_time(self) -> float:
        return self.finish_time - self.submit_time if self.finish_time >= 0 else -1.0


@dataclass
class ServiceMetrics:
    jobs: Dict[str, JobMetrics] = field(default_factory=dict)
    minor_gcs: int = 0
    full_gcs: int = 0
    total_gc_time: float = 0.0
    oom: bool = False
    min_active_tasks: int = 1 << 30
    peak_task_live: Dict[str, float] = field(default_factory=dict)
    peak_pool_used_fraction: float = 0.0
    suspensions: int = 0
    sim_time: float = 0.0


class ServiceExecutor:
    """Tick-driven executor scheduling exclusively through ``policy``.

    ``policy`` takes any :class:`SchedulingPolicy`; the legacy ``murs``
    kwarg (a :class:`MursConfig`, or None for the FAIR baseline) is kept
    as a constructor convenience and resolves to :class:`MursPolicy` /
    :class:`FairPolicy`.
    """

    def __init__(
        self,
        *,
        cores: int,
        heap_bytes: float,
        proc_rate: float = 8e6,  # bytes/s of input per core (incl. shuffle,
        # serialization, disk — Spark-realistic; tasks run minutes, so the
        # seasonal sampler catches heavy tasks early in their life)
        disk_bandwidth: float = 150e6,  # spill write rate
        gc: Optional[GcModel] = None,
        spill: Optional[SpillModel] = None,
        murs: Optional[MursConfig] = None,
        policy: Optional[SchedulingPolicy] = None,
        dt: float = 0.05,
        max_time: float = 36000.0,
        oom_is_fatal: bool = True,
    ) -> None:
        if policy is not None and murs is not None:
            raise ValueError("pass either policy= or murs=, not both")
        self.cores = cores
        self.pool = MemoryPool(capacity=heap_bytes)
        self.proc_rate = proc_rate
        self.disk_bandwidth = disk_bandwidth
        self.gc = gc or GcModel()
        self.spill = spill or SpillModel()
        self.policy: SchedulingPolicy = policy or (
            MursPolicy(murs) if murs is not None else FairPolicy()
        )
        self.sampler = Sampler()
        self.dt = dt
        self.max_time = max_time
        self.oom_is_fatal = oom_is_fatal

        self.time = 0.0
        self._next_full_gc_allowed = 0.0
        self._live_at_last_full = 0.0
        self._jobs: Dict[str, JobSpec] = {}
        self._job_stage: Dict[str, int] = {}
        self._pending: Dict[str, List[TaskSpec]] = {}  # runnable, not started
        self._running: Dict[str, TaskState] = {}
        self._suspended: Dict[str, TaskState] = {}
        self._stage_remaining: Dict[str, int] = {}
        self._last_minor_live = 0.0
        self._next_sample = 0.0
        self.metrics = ServiceMetrics()

    # ------------------------------------------------------------ submission
    def submit(self, job: JobSpec) -> None:
        self._jobs[job.job_id] = job
        self._job_stage[job.job_id] = 0
        self.metrics.jobs[job.job_id] = JobMetrics(
            job_id=job.job_id,
            submit_time=job.submit_time,
            tasks_total=sum(len(s) for s in job.stages),
        )

    # ---------------------------------------------------------------- runner
    def run(self) -> ServiceMetrics:
        while self.time < self.max_time:
            if self._all_done():
                break
            self._tick()
        self.metrics.sim_time = self.time
        if self.metrics.min_active_tasks == 1 << 30:
            self.metrics.min_active_tasks = 0
        return self.metrics

    def _all_done(self) -> bool:
        if self.metrics.oom and self.oom_is_fatal:
            return True
        for jid, job in self._jobs.items():
            if self.time < job.submit_time:
                return False
            if self.metrics.jobs[jid].finish_time < 0:
                return False
        return True

    # ------------------------------------------------------------------ tick
    def _tick(self) -> None:
        dt = self.dt
        self._activate_stages()
        self._launch_tasks()

        running = [
            t
            for t in self._running.values()
            if not t.suspended and t.spill_block_until <= self.time
        ]
        self.metrics.min_active_tasks = min(
            self.metrics.min_active_tasks, len(running) or self.metrics.min_active_tasks
        )

        # --- advance tasks (throughput degrades with heap occupancy) -----
        speed = pressure_slowdown(self.pool.used_fraction)
        for task in running:
            garbage = task.advance(self.proc_rate * speed * dt)
            self.pool.add_transient(task.spec.task_id, garbage)
            self.pool.set_live(task.spec.task_id, task.live)
            peak = self.metrics.peak_task_live.get(task.spec.task_id, 0.0)
            if task.live > peak:
                self.metrics.peak_task_live[task.spec.task_id] = task.live
        self.metrics.peak_pool_used_fraction = max(
            self.metrics.peak_pool_used_fraction, self.pool.used_fraction
        )

        # --- garbage collection (before spill/OOM: allocation failure is
        # only real after collection has had its chance) -------------------
        self._maybe_gc()

        # --- spill / OOM -------------------------------------------------
        self._maybe_spill_or_oom()

        # --- task completion ---------------------------------------------
        self._complete_tasks()

        # --- seasonal policy pass ----------------------------------------
        if self.time >= self._next_sample:
            self._policy_pass()
            self._next_sample = self.time + self.policy.period

        self.time += dt

    # ------------------------------------------------------------ stage flow
    def _activate_stages(self) -> None:
        for jid, job in self._jobs.items():
            if self.time < job.submit_time:
                continue
            stage = self._job_stage[jid]
            if stage >= len(job.stages):
                continue
            key = f"{jid}/s{stage}"
            if key not in self._stage_remaining:
                tasks = job.stages[stage]
                self._stage_remaining[key] = len(tasks)
                self._pending.setdefault(jid, []).extend(tasks)

    def _launch_tasks(self) -> None:
        """Fill free cores in the order the policy's ``assign`` hook picks.

        A suspended task's thread sleeps inside InterruptibleIterator and
        costs no CPU: its *core* is released to other tasks (paper §I: "the
        resources are released from running heavy tasks") while its buffer
        stays resident.  Fresh launches therefore backfill suspended tasks'
        slots — typically with the light jobs' tasks, which is exactly how
        "the light tasks can then complete quickly".
        """
        free = self.cores - sum(
            1 for t in self._running.values() if not t.suspended
        )
        # A job with suspended tasks is a known heavy-pressure source: a
        # proactive policy does not launch more of its tasks until its
        # queue drains — the released cores go to the light jobs' tasks.
        gated = {
            self._running[tid].spec.job_id
            for tid in self.policy.suspended_queue
            if tid in self._running
        }
        pending = {
            j: len(p) for j, p in self._pending.items() if p and j not in gated
        }
        for jid in self.policy.assign(free, pending):
            spec = self._pending[jid].pop(0)
            self._running[spec.task_id] = TaskState(spec=spec)

    # ------------------------------------------------------------- spill/OOM
    def _maybe_spill_or_oom(self) -> None:
        """Spark-1.6 semantics (paper §IV): "the maximum memory space
        allowed for each task must be less than M/N" — a task whose buffer
        exceeds the per-task cap exec_pool/N spills the excess.  Reducing N
        (what MURS's suspension does) raises everyone's cap — this is the
        spill-avoidance channel of Table III."""
        sp = self.spill
        exec_pool = sp.exec_fraction * self.pool.capacity
        states = [t for t in self._running.values() if not t.done]
        n = max(sum(1 for t in states if not t.suspended), 1)
        share = exec_pool / n
        for t in states:
            if t.suspended or t.live <= share:
                continue
            written = t.spill(sp.spillable_fraction)
            self.pool.set_live(t.spec.task_id, t.live)
            t.spill_block_until = self.time + written / self.disk_bandwidth
            jm = self.metrics.jobs[t.spec.job_id]
            jm.spills += 1
            jm.spilled_bytes += written
        # OOM: after GC had its chance and everything spillable spilled,
        # the pool must still leave a minimal young-gen working space.
        young_min = self.gc.young_min_fraction * self.pool.capacity
        if self.pool.used_bytes + young_min >= self.pool.capacity:
            self._force_full_gc()
            if self.pool.used_bytes + young_min >= self.pool.capacity:
                self.metrics.oom = True
                for jm in self.metrics.jobs.values():
                    if jm.finish_time < 0:
                        jm.oom = True

    # ------------------------------------------------------------------- GC
    def _force_full_gc(self) -> None:
        pause = (
            self.gc.full_pause_base + self.pool.live_bytes / self.gc.mark_bandwidth
        )
        self.pool.release_owner(DEAD)
        self.pool.minor_gc()
        self._last_minor_live = self.pool.live_bytes
        self._live_at_last_full = self.pool.live_bytes
        self.metrics.full_gcs += 1
        self._bill_gc(pause)

    def _maybe_gc(self) -> None:
        g = self.gc
        young_cap = g.young_fraction * self.pool.capacity
        pause = 0.0
        if self.pool.transient_bytes >= young_cap:
            survivors = max(self.pool.live_bytes - self._last_minor_live, 0.0)
            pause += (
                g.minor_pause_base
                + survivors / g.copy_bandwidth
                + self.pool.live_bytes / g.old_scan_bandwidth
            )
            self.pool.minor_gc()
            self._last_minor_live = self.pool.live_bytes
            self.metrics.minor_gcs += 1
        if (
            self.pool.live_fraction >= g.full_trigger
            and self.time >= self._next_full_gc_allowed
        ):
            live_before = self.pool.live_bytes
            pause += g.full_pause_base + live_before / g.mark_bandwidth
            self.pool.release_owner(DEAD)  # reclaim dead old-gen objects
            self.pool.minor_gc()
            self._last_minor_live = self.pool.live_bytes
            self._live_at_last_full = self.pool.live_bytes
            self.metrics.full_gcs += 1
            if self.pool.live_fraction >= g.full_trigger:
                # Even a full collection left the floor above the trigger:
                # permanent-thrash regime (the live set is genuinely large).
                # Pace it — real collectors degrade, they don't spin.
                self._next_full_gc_allowed = self.time + pause + g.full_cooldown
            for tid in self.policy.on_full_gc(self.pool):
                self._resume(tid)
        if pause > 0.0:
            self._bill_gc(pause)

    def _bill_gc(self, pause: float) -> None:
        """Stop-the-world: bill the pause to every in-flight job and to
        wall-clock (all task progress already excluded the pause)."""
        self.metrics.total_gc_time += pause
        active_jobs = {t.spec.job_id for t in self._running.values()} | {
            j for j, p in self._pending.items() if p
        }
        for jid in active_jobs:
            if self.metrics.jobs[jid].finish_time < 0:
                self.metrics.jobs[jid].gc_time += pause
        self.time += pause

    # ------------------------------------------------------------ completion
    def _complete_tasks(self) -> None:
        finished = [t for t in self._running.values() if t.done]
        for t in finished:
            spec = t.spec
            del self._running[spec.task_id]
            # Old-gen buffers of a finished task are dead but unreclaimed
            # until the next full GC (the "revise after full GC" effect).
            self.pool.add_live(DEAD, self.pool.live.pop(spec.task_id, 0.0))
            self.pool.transient.pop(spec.task_id, None)
            if spec.cache_on_complete > 0.0:
                self.pool.add_live(f"cache/{spec.job_id}", spec.cache_on_complete)
            self.sampler.forget(spec.task_id)
            key = f"{spec.job_id}/s{spec.stage}"
            self._stage_remaining[key] -= 1
            if self._stage_remaining[key] == 0:
                self._job_stage[spec.job_id] += 1
                if self._job_stage[spec.job_id] >= len(
                    self._jobs[spec.job_id].stages
                ):
                    jm = self.metrics.jobs[spec.job_id]
                    jm.finish_time = self.time
                    # job-lifetime caches die with the job (dead until full GC)
                    freed = self.pool.live.pop(f"cache/{spec.job_id}", 0.0)
                    self.pool.add_live(DEAD, freed)
            tid = self.policy.on_task_complete(spec.task_id)
            if tid is not None:
                self._resume(tid)

    # ---------------------------------------------------------------- policy
    def _policy_pass(self) -> None:
        running_states = [
            t for t in self._running.values() if not t.suspended
        ]
        suspended_states = [t for t in self._running.values() if t.suspended]
        for t in running_states:
            self.sampler.observe(
                t.spec.task_id,
                processed_bytes=t.processed,
                total_bytes=t.spec.input_bytes,
                live_bytes=t.live,
                group=t.spec.job_id,
            )
        stats = self.sampler.stats([t.spec.task_id for t in running_states])
        frozen = self.sampler.stats([t.spec.task_id for t in suspended_states])
        decision: SchedulingDecision = self.policy.propose(
            self.pool, stats, now=self.time, suspended=frozen
        )
        for tid in decision.suspend:
            state = self._running.get(tid)
            if state is not None and not state.done:
                state.suspended = True
                self._suspended[tid] = state
                self.metrics.suspensions += 1
        for tid in decision.resume:
            self._resume(tid)

    def _resume(self, task_id: str) -> None:
        state = self._suspended.pop(task_id, None)
        if state is not None:
            state.suspended = False
