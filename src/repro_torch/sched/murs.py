"""MURS — the Memory-Usage-Rate based Scheduler (paper §IV, Algorithm 1).

Decision procedure, invoked periodically ("seasonally") with fresh Sampler
stats and the pool state:

    usage < yellow                     → no action (and: resume ALL suspended
                                         tasks once usage drops below yellow
                                         after a full GC)
    yellow ≤ usage < red, SQ empty     → ComputeSuspendTasks: keep the
                                         lowest-rate tasks whose projected
                                         remaining need Σ c·(1−done%) fits the
                                         free pool, suspend the rest (the
                                         heavy tasks) into a FIFO queue
    yellow ≤ usage < red, SQ non-empty → no action (pressure already handled)
    usage ≥ red                        → emergency: ComputeSuspendTasks against
                                         the shrunken free pool (queue gate
                                         ignored) plus ComputeSpill — suspend
                                         every task whose actual (c > M/N) or
                                         projected (c/done% > M/N) consumption
                                         exceeds its fair share, cutting the
                                         degree of parallelism before
                                         spill / OOM

On every task completion one suspended task is resumed (FIFO — avoids
starvation, paper §VI-D); dropping below yellow resumes all.

The published pseudocode has two OCR-garbled lines (its line 21 pushes the
*kept* min-rate task into SQ; its branch order tests red before yellow);
we follow the unambiguous prose of §IV: the *returned* heavy tasks are the
ones suspended and queued, and ComputeSuspendTasks runs in the yellow band
while ComputeSpill guards the red band.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from .protocol import BasePolicy, SchedulingDecision

if TYPE_CHECKING:
    from repro_torch.core.memory_manager import MemoryPool
    from repro_torch.core.sampler import TaskStats

__all__ = ["MursConfig", "MursPolicy"]

#: architecture memory classes whose byte demand does NOT grow with
#: context length (``configs.MEMORY_CLASSES`` subset): a mamba2 tenant's
#: state is the same size at token 1 and token 10k, so its usage RATE is
#: structurally ~zero no matter what the online EMA momentarily reads
FLAT_CLASSES = ("constant_state", "zero_kv")


@dataclass(frozen=True)
class MursConfig:
    """Thresholds and knobs of MURS (defaults from the paper: 0.4 / 0.8)."""

    yellow: float = 0.4
    red: float = 0.8
    #: sampler/scheduler period in (sim or wall) seconds
    period: float = 1.0
    #: never suspend below this many running tasks (keep the service live)
    min_running: int = 1
    #: the collector's full-GC initiating occupancy.  Heap above this line
    #: is not usable without incurring full collections, so the scheduler's
    #: working notion of "free memory" is the headroom below it:
    #: free = trigger×capacity − live.  Set to None to use the raw
    #: JM.freeMemory reading of the paper's pseudocode (heap − used).
    collector_trigger: Optional[float] = 0.65
    #: a freshly resumed task cannot be re-suspended for this many seconds —
    #: prevents the suspend/resume oscillation around the yellow threshold
    resume_immunity: float = 5.0
    #: execution-memory share of the pool that the memory manager actually
    #: grants to tasks — the fair share M/N of ComputeSpill is M_exec/N, the
    #: same limit the environment spills at (anything larger never fires).
    #: Held slightly below the environment's grant (0.6) as a safety margin
    #: so kept tasks finish without ever hitting the per-task cap.
    exec_fraction: float = 0.55
    #: the inline per-task fair-share check (paper line 17) models Spark's
    #: M/N execution-memory grant: a task projected past its grant WILL
    #: spill, so it is suspended pre-emptively.  Pools without per-task
    #: grants (an HBM KV pool) should turn this off — page-quantized
    #: consumption makes c/done% overshoot and the guard then suspends
    #: every request at once.
    fair_share_guard: bool = True

    def __post_init__(self) -> None:
        if not (0.0 < self.yellow <= self.red <= 1.0):
            raise ValueError(
                f"need 0 < yellow <= red <= 1, got {self.yellow}, {self.red}"
            )

    @classmethod
    def for_serving(cls, **overrides) -> "MursConfig":
        """Thresholds retuned for a serving HBM pool.

        The JVM-specific machinery is disabled: there is no full-GC
        occupancy line (``collector_trigger``), no per-task execution-
        memory grant (``fair_share_guard``), and the scheduler may plan
        against nearly the whole pool (``exec_fraction`` ≈ 1) because
        nothing else shares it.
        """
        base = dict(
            exec_fraction=0.95, collector_trigger=None, fair_share_guard=False
        )
        base.update(overrides)
        return cls(**base)


class MursPolicy(BasePolicy):
    """Algorithm 1 with FIFO suspension queue and resume rules.

    Placement (``assign``) stays round-robin — MURS changes which tasks
    RUN under pressure, not how free cores rotate across tenants.
    """

    name = "murs"
    proactive = True

    def __init__(self, config: Optional[MursConfig] = None) -> None:
        super().__init__()
        self.config = config or MursConfig()
        self.period = self.config.period
        # never admit new work into a red pool — it would be suspended on
        # the very next pass (and gate its whole tenant); queue it instead
        self.admission_headroom = self.config.red
        self._resumed_at: Dict[str, float] = {}
        self._now: float = 0.0
        #: per-group (tenant/job) memory-usage-rate EMA — the sampler's §III
        #: rate aggregated per tenant, feeding the cache_pressure hint.
        #: Entries for groups not observed within ``_group_rate_horizon``
        #: seasonal periods are pruned: a long-lived service with churning
        #: tenant ids must not grow this dict without bound, and a departed
        #: burst tenant's stale maximum must not compress every live
        #: tenant's pressure score toward uniform.
        self._group_rate: Dict[str, float] = {}
        self._group_seen: Dict[str, float] = {}
        #: per-group DECLARED architecture memory class (note_group_class)
        #: — the static prior the online EMA is read through: a group of
        #: FLAT_CLASSES never counts as high-rate, whatever its EMA says
        self._group_class: Dict[str, str] = {}
        self._group_rate_horizon: float = 50.0 * max(
            self.period, self.config.resume_immunity
        )

    def _immune(self, task_id: str) -> bool:
        t0 = self._resumed_at.get(task_id)
        return t0 is not None and (self._now - t0) < self.config.resume_immunity

    # ------------------------------------------------------------- main loop
    def propose(
        self,
        pool: "MemoryPool",
        running: Sequence["TaskStats"],
        now: float = 0.0,
        suspended: Sequence["TaskStats"] = (),
    ) -> SchedulingDecision:
        """One "seasonal" scheduling pass (paper Algorithm 1).

        Yellow band: classify by rate and suspend the heavy tail (once —
        gated on an empty suspension queue, paper line 7).  Red band: the
        emergency path — ComputeSuspendTasks against the (now tiny) free
        pool *plus* the ComputeSpill fair-share guard, regardless of the
        queue gate, because red means spill/OOM is imminent.
        """
        cfg = self.config
        self._now = now
        # Expired immunity stamps are dead weight in a long-lived service —
        # prune them here so the dict is bounded by the active task set.
        expired = [
            t
            for t, t0 in self._resumed_at.items()
            if (now - t0) >= cfg.resume_immunity
        ]
        for t in expired:
            del self._resumed_at[t]
        for t in running:
            if t.group:
                self.note_group_rate(t.group, t.rate, now)
        usage = pool.live_fraction

        if usage < cfg.yellow:
            # Pressure receded: resume everything still suspended.
            if self._suspended:
                resumed = list(self._suspended)
                self._suspended.clear()
                for tid in resumed:
                    self._resumed_at[tid] = now
                return SchedulingDecision(resume=resumed, reason="below-yellow")
            return SchedulingDecision(reason="light")

        if usage >= cfg.red:
            d1 = self._compute_suspend_tasks(pool, running)
            still = [t for t in running if t.task_id not in set(d1.suspend)]
            d2 = self._compute_spill(pool, still, suspended)
            return SchedulingDecision(
                suspend=d1.suspend + d2.suspend,
                reason="red-emergency" if (d1.suspend or d2.suspend) else "red-fits",
            )

        # Spill-avoidance: if the execution pool is close to exhaustion the
        # memory manager is about to deny allocations (spill), regardless of
        # total-heap occupancy — run the ComputeSpill guard now.
        exec_pool = cfg.exec_fraction * pool.capacity
        frozen = sum(t.consumption for t in suspended)
        projected = sum(t.consumption + t.rate * t.remaining_bytes for t in running)
        if frozen + projected >= 0.9 * exec_pool:
            d = self._compute_spill(pool, running, suspended)
            if d.suspend:
                return d

        if self._suspended:
            # Yellow band but pressure already being handled.
            return SchedulingDecision(reason="already-suspended")

        return self._compute_suspend_tasks(pool, running)

    # --------------------------------------------------- ComputeSuspendTasks
    def _compute_suspend_tasks(
        self, pool: "MemoryPool", running: Sequence["TaskStats"]
    ) -> SchedulingDecision:
        """Keep lowest-rate tasks that fit free memory; suspend the rest."""
        cfg = self.config
        if cfg.collector_trigger is not None:
            free = max(
                cfg.collector_trigger * pool.capacity - pool.live_bytes, 0.0
            )
            free = min(free, pool.free_bytes)
        else:
            free = pool.free_bytes
        fair_share = self._fair_share(pool, running)

        # Order by projected FUTURE growth (rate × remaining input): keeping
        # low-future-growth tasks lets them finish cheaply, while suspending
        # high-future-growth tasks freezes only their (typically still small)
        # current buffer and saves all of their remaining growth.  Ties —
        # in particular the zero-information passes before the sampler has
        # rate estimates — break on the §III-B projected remaining need, so
        # a nearly-done task is never suspended ahead of a fresh heavy one.
        by_growth = sorted(
            running,
            key=lambda t: (
                t.rate * t.remaining_bytes,
                t.rate,
                t.memory_necessary,
                t.task_id,
            ),
        )
        kept: List["TaskStats"] = []
        suspend: List["TaskStats"] = []
        for t in by_growth:
            if len(kept) < cfg.min_running or self._immune(t.task_id):
                kept.append(t)
                free -= t.memory_necessary
                continue
            # Inline spill guard (paper line 17): a task that would exceed its
            # fair share cannot be saved by suspending others — reduce the
            # degree of parallelism by suspending it instead.
            if cfg.fair_share_guard and self._violates_fair_share(t, fair_share):
                suspend.append(t)
                continue
            need = t.memory_necessary
            if free - need > 0.0:
                free -= need
                kept.append(t)
            else:
                suspend.append(t)

        # Suspend heaviest-first ordering for the FIFO queue: tasks were
        # examined in ascending rate, so `suspend` is already ascending;
        # queue them ascending so that the FIFO resume brings back the
        # lightest suspended task first.
        ids = [t.task_id for t in suspend]
        self._suspended.extend(ids)
        return SchedulingDecision(
            suspend=ids,
            reason="yellow-suspend" if ids else "yellow-fits",
        )

    # ---------------------------------------------------------- ComputeSpill
    def _compute_spill(
        self,
        pool: "MemoryPool",
        running: Sequence["TaskStats"],
        suspended: Sequence["TaskStats"] = (),
    ) -> SchedulingDecision:
        """Spill-avoidance: reduce parallelism until the projected total
        consumption of the kept tasks — plus the frozen buffers of already
        suspended tasks, which stay resident — fits the execution pool, so
        the memory manager never has to deny an allocation (paper: "ensures
        that the running tasks can complete with the remaining memory
        space")."""
        cfg = self.config
        budget = cfg.exec_fraction * pool.capacity
        budget -= sum(t.consumption for t in suspended)
        by_growth = sorted(
            running,
            key=lambda t: (
                t.rate * t.remaining_bytes,
                t.rate,
                t.memory_necessary,
                t.task_id,
            ),
        )
        suspend: List[str] = []
        kept = 0
        for t in by_growth:
            projected = t.consumption + t.rate * t.remaining_bytes
            if kept < cfg.min_running or self._immune(t.task_id):
                kept += 1
                budget -= projected
                continue
            if budget - projected > 0.0:
                budget -= projected
                kept += 1
            elif t.task_id not in self._suspended:
                suspend.append(t.task_id)
                budget -= t.consumption  # its buffer stays frozen in the pool
        self._suspended.extend(suspend)
        return SchedulingDecision(
            suspend=suspend, reason="spill-avoidance" if suspend else "spill-fits"
        )

    def _fair_share(
        self, pool: "MemoryPool", running: Sequence["TaskStats"]
    ) -> float:
        n = max(len(running), 1)
        return self.config.exec_fraction * pool.capacity / n

    @staticmethod
    def _violates_fair_share(t: "TaskStats", fair_share: float) -> bool:
        if t.consumption > fair_share:
            return True
        return t.progress > 1e-9 and t.projected_total > fair_share

    # -------------------------------------------------------- group rate EMA
    def note_group_rate(self, group: str, rate: float, now: float = 0.0) -> None:
        """One usage-rate observation for ``group`` (EMA, horizon-pruned).
        Fed by :meth:`propose` for a replica-local policy, and by a
        ``ServingCluster`` forwarding replica-level EMAs into its router
        — the router never runs ``propose`` itself."""
        prev = self._group_rate.get(group)
        self._group_rate[group] = (
            rate if prev is None else 0.8 * prev + 0.2 * rate
        )
        self._group_seen[group] = now
        for g in [
            g
            for g, seen in self._group_seen.items()
            if (now - seen) > self._group_rate_horizon
        ]:
            del self._group_seen[g]
            del self._group_rate[g]

    def group_rates(self) -> Dict[str, float]:
        return dict(self._group_rate)

    # ------------------------------------------------------ memory classes
    def note_group_class(self, group: str, memory_class: str) -> None:
        """Record the declared architecture class of ``group``'s model —
        the §III function classes generalized to architectures: the
        class is knowable BEFORE any request runs, so every rate-driven
        hook below can clamp a structurally-flat tenant to low-rate even
        while its EMA is still warming up (or momentarily polluted by
        its fixed-state registration burst)."""
        self._group_class[group] = memory_class

    def group_classes(self) -> Dict[str, str]:
        return dict(self._group_class)

    def _flat_group(self, group: str) -> bool:
        """True when the group's declared class cannot grow the pool."""
        return self._group_class.get(group) in FLAT_CLASSES

    def _shed_key(self, group: str, row) -> tuple:
        """Shed the highest-usage-rate group FIRST (paper §III at the
        front door): its admitted traffic grows the pool fastest, so
        rejecting it protects the most SLO traffic per rejected request.
        The EMA is authoritative; before it warms up (cold start, or a
        router that never saw the group) the front door's projected
        in-flight demand stands in — demand-ordered shedding is the
        zero-information approximation of rate-ordered shedding.  Ties
        fall back to group arrival order (FIFO), matching the base."""
        # a structurally flat tenant (mamba / zero-KV) cannot grow the
        # pool: shedding it buys nothing per §III, so it sheds LAST
        if self._flat_group(group):
            rate = 0.0
        else:
            rate = self._group_rate.get(group, row.get("rate", 0.0))
        return (
            -rate,
            -row.get("demand_bytes", 0.0),
            row.get("arrival_seq", 0.0),
        )

    # ------------------------------------------------------ cluster placement
    def placement_score(self, group: str, replica_stats) -> float:
        """Pressure- and rate-aware routing (paper §III applied ACROSS
        replicas): the score is the negated replica load, where "load"
        is read through the group's usage-rate class.

        A HIGH-rate tenant's requests grow the pool fastest, so for them
        load is the replica's byte DEMAND (its next thousand tokens need
        page headroom — placing it on a nearly-full replica buys
        suspensions and spills).  A LOW/constant-rate tenant barely
        touches the pool; its latency is gated by batch slots, so for it
        load is the replica's SLOT occupancy.  The per-group usage-rate
        EMA (the same one behind ``cache_pressure``) blends the two —
        unseen groups sit in the middle.  Equal-load replicas tie and
        fall back to the router's round-robin cursor.
        """
        rate_norm = 1.0 - self._inverse_rate_score(group)  # high rate → 1
        # committed-peak demand when the replica reports it: materialized
        # bytes alone lag a just-placed heavy request by its whole decode
        demand = max(
            float(replica_stats.get("demand_fraction", 0.0)),
            float(replica_stats.get("projected_fraction", 0.0)),
        )
        slots = float(replica_stats.get("slot_load", 0.0))
        return -(rate_norm * demand + (1.0 - rate_norm) * slots)

    # ------------------------------------------------------- elastic scaling
    def scale_pressure(self, replica_stats) -> float:
        """Fleet demand read through the usage-rate lens (paper §III-B
        applied to the whole fleet): the mean, across replicas, of the
        committed-peak byte fraction — ``max(demand, projected)``, the
        same surface ``placement_score`` steers heavy tenants by.  Queued
        work that no replica has admitted yet still needs future pages,
        so a replica with a backlog reports pressure ≥ its slot load
        even while its pool is momentarily empty.  FAIR scales on slot
        occupancy; MURS scales on where the bytes are going.

        A replica that DECLARES a flat memory class (constant-state /
        zero-KV model) contributes its slot occupancy alone: its byte
        fractions are bounded by construction — its bytes never grow
        with context, so scaling it is a throughput decision, not a
        memory-pressure one.
        """
        if not replica_stats:
            return 0.0
        total = 0.0
        for s in replica_stats:
            slots = min(float(s.get("slot_load", 0.0)), 2.0) / 2.0
            if str(s.get("memory_class", "")) in FLAT_CLASSES:
                total += slots
                continue
            bytes_frac = max(
                float(s.get("demand_fraction", 0.0)),
                float(s.get("projected_fraction", 0.0)),
            )
            total += max(bytes_frac, slots)
        return min(total / len(replica_stats), 1.0)

    # ----------------------------------------------------------- cache hint
    def _inverse_rate_score(self, group: str) -> float:
        """1 − rate/top over the per-group usage-rate EMA, in [0, 1]:
        LOW-rate tenants score HIGH.  Unseen groups sit in the middle
        (0.5) so the hint never starves LRU / size tie-breaks.  A group
        DECLARED flat (constant-state / zero-KV architecture) pins to
        1.0: its demand cannot grow, so it is definitively low-rate —
        its placement reads slot occupancy, its frozen state demotes
        first, and its (empty) prefix cache never shields anything."""
        if self._flat_group(group):
            return 1.0
        rate = self._group_rate.get(group)
        if rate is None or not self._group_rate:
            return 0.5
        top = max(self._group_rate.values())
        if top <= 0.0:
            return 0.5
        return 1.0 - min(rate / top, 1.0)

    def _frozen_score(self, group: str) -> float:
        """How eagerly ``group``'s FROZEN KV demotes to the host tier,
        in [0, 1] — the usage-rate classes of §III applied to tier
        placement.  A low-rate tenant's suspended pages sit frozen the
        longest (its requests resume into slow growth), so parking them
        in host memory costs the least and frees HBM for the heavy
        tenants' growth — demoting proactively, page by page, is what
        keeps the reactive spill path (and the disk tier behind it) from
        ever firing.  Every tenant scores > 0 under MURS: frozen KV is
        by definition demotable, the hint only orders who goes first.
        """
        return max(self._inverse_rate_score(group), 0.1)

    @staticmethod
    def _scratch_score(group: str) -> float:
        """SCRATCH is free to regenerate by definition: every group's
        scratch pages are equally first out the door."""
        return 1.0

    def pressure(self, view=None):
        """MURS's :class:`~repro_torch.serve.ledger.PressurePlan` — §III as
        class orders and usage-rate scores.

        The class orders keep the stock shape (reclaim SCRATCH, then
        COLD_CACHED, then FROZEN; proactively demote FROZEN before
        COLD_CACHED), so cold cache always evicts before frozen state is
        touched *by construction*.  The scores are the usage-rate lens:
        ``COLD_CACHED`` evicts LOW-rate tenants' prefixes first (cheap to
        regrow, shield little future allocation — a high-rate tenant's
        cached prefix spares the pool the most growth and is kept
        longest), ``FROZEN`` demotes low-rate tenants' suspended KV
        first, and the shed key rejects the highest-rate group's
        arrivals first."""
        from repro_torch.serve.ledger import PageClass, PressurePlan

        return PressurePlan(
            scores={
                PageClass.SCRATCH: self._scratch_score,
                PageClass.COLD_CACHED: self._inverse_rate_score,
                PageClass.FROZEN: self._frozen_score,
            },
            shed_key=self._shed_key,
        )

    # ------------------------------------------------------------ resume API
    def on_task_complete(self, task_id: Optional[str] = None) -> Optional[str]:
        """A running task finished: resume the first suspended task (FIFO).

        The finished task's immunity stamp is purged — without this the
        ``_resumed_at`` dict grows without bound in a long-lived service
        (every task that was ever resumed stays in it forever).
        """
        if task_id is not None:
            self._resumed_at.pop(task_id, None)
        if self._suspended:
            tid = self._suspended.pop(0)
            self._resumed_at[tid] = self._now
            return tid
        return None

    def on_full_gc(self, pool: "MemoryPool") -> List[str]:
        """After a full GC, resume all if usage dropped below yellow."""
        if pool.live_fraction < self.config.yellow and self._suspended:
            resumed = list(self._suspended)
            self._suspended.clear()
            for tid in resumed:
                self._resumed_at[tid] = self._now
            return resumed
        return []

    def drop(self, task_id: str) -> None:
        """Remove a task from every policy structure (job cancelled)."""
        super().drop(task_id)
        self._resumed_at.pop(task_id, None)
