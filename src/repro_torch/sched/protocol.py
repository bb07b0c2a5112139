"""The :class:`SchedulingPolicy` protocol and shared policy machinery.

A policy owns four runtime hooks (the minimal surface both runtimes call):

    propose(pool, running, now, suspended) → SchedulingDecision
        the "seasonal" pass: given fresh sampler stats and the pool state,
        decide which tasks to suspend / resume this period.
    on_task_complete(task_id) → resumed task id or None
        a running task finished; the policy may resume one suspended task
        (MURS: FIFO, starvation-free) and must forget per-task state it
        holds for the finished task.
    on_full_gc(pool) → resumed task ids
        the collector just ran; resume if pressure receded.
    drop(task_id)
        the task's job was cancelled — purge it from every policy structure.

plus two placement hooks:

    assign(free, pending) → group ids to launch from, one per free core
        how free execution slots are offered to tenants/jobs.  FAIR's
        round-robin cursor lives HERE now, not inlined in the executor.

    shed_order(groups, stats) → groups, first-shed first
        admission-time load shedding under overload (the serving front
        door's hook): MURS sheds the highest-usage-rate group first
        (paper §III — its traffic costs the pool the most future
        allocation), PriorityPolicy sheds by inverse weight, and the
        base/fair order is FIFO over group arrival.  Implemented as a
        thin wrapper over ``pressure().shed_key`` — subclasses customize
        the plan, not this method.

    placement_score(group, replica_stats) → preference for placing the
        group's next request on the replica described by ``replica_stats``
        (a ``ServingCluster`` routing decision — the same usage-rate
        classes of paper §III applied ACROSS replicas).  Higher = better;
        the router breaks exact ties round-robin, so the base default of
        0.0 for every replica IS round-robin (FAIR).  MURS scores by
        negated demand, scaled up for high-usage-rate groups (a heavy
        tenant is steered harder toward the emptiest replica — its
        placement mistake costs the most future allocation);
        PriorityPolicy scales the same aversion by tenant weight.

    scale_pressure(replica_stats) → fleet-level demand in [0, 1], the
        signal the cluster's elastic autoscaler thresholds (DESIGN.md
        §11).  The base/fair reading is mean slot occupancy; MURS reads
        the projected usage-rate surface instead — the fleet is "full"
        when its admitted requests will grow into the pool, not merely
        when its batch rows are busy.

and ONE memory-pressure surface:

    pressure(view: LedgerView) → PressurePlan
        the policy's complete answer to "memory is tight — what goes
        first?", replacing the three historical hooks (``cache_pressure``,
        ``demotion_pressure``, ``shed_order``) with one plan built from
        the class-stamped ledger view: per-:class:`PageClass` reclaim and
        proactive-demotion orders plus per-class group-scoring callables
        and a front-door shed key.  The stock plan evicts ``SCRATCH``,
        then ``COLD_CACHED``, and only then demotes ``FROZEN`` — so MURS
        evicts cold cache before touching frozen state *by construction*.
        The base scores are 0.0 for every group (pure LRU eviction,
        never-proactive demotion — the stock baseline only pays reactive
        spills); MURS scores by inverse usage rate (a LOW-rate tenant's
        prefixes regrow cheaply and its frozen pages are cheapest to park
        in host memory — the paper's ~90% spill reduction is exactly this
        demote-early-by-class behaviour).  ``cache_pressure(group)`` /
        ``demotion_pressure(group)`` survive as thin wrappers reading the
        plan's ``COLD_CACHED`` / ``FROZEN`` scores.

Runtimes interrogate declarative attributes instead of branching on the
policy's type: ``proactive`` (True → the policy prevents overcommit via
admission control + suspension; False → stock reactive semantics),
``admission_headroom`` (the pool fraction the policy will fill before
gating new admissions — 1.0 for the stock baseline, the red line for
MURS), and ``period`` (seconds between seasonal passes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING,
    List,
    Mapping,
    Optional,
    Protocol,
    Sequence,
    runtime_checkable,
)

if TYPE_CHECKING:  # annotation-only: keeps repro_torch.sched import-cycle free
    from repro_torch.core.memory_manager import MemoryPool
    from repro_torch.core.sampler import TaskStats
    from repro_torch.serve.ledger import LedgerView, PressurePlan

__all__ = ["SchedulingDecision", "SchedulingPolicy", "BasePolicy"]


@dataclass
class SchedulingDecision:
    """Output of one policy invocation."""

    suspend: List[str] = field(default_factory=list)
    resume: List[str] = field(default_factory=list)
    reason: str = "ok"

    @property
    def is_noop(self) -> bool:
        return not self.suspend and not self.resume


@runtime_checkable
class SchedulingPolicy(Protocol):
    """Structural type every scheduling policy satisfies."""

    name: str
    proactive: bool
    period: float
    admission_headroom: float

    def propose(
        self,
        pool: "MemoryPool",
        running: Sequence["TaskStats"],
        now: float = 0.0,
        suspended: Sequence["TaskStats"] = (),
    ) -> SchedulingDecision: ...

    def on_task_complete(self, task_id: Optional[str] = None) -> Optional[str]: ...

    def on_full_gc(self, pool: "MemoryPool") -> List[str]: ...

    def drop(self, task_id: str) -> None: ...

    def assign(self, free: int, pending: Mapping[str, int]) -> List[str]: ...

    def shed_order(
        self,
        groups: Sequence[str],
        stats: Mapping[str, Mapping[str, float]],
    ) -> List[str]: ...

    def placement_score(
        self, group: str, replica_stats: Mapping[str, float]
    ) -> float: ...

    def scale_pressure(
        self, replica_stats: Sequence[Mapping[str, float]]
    ) -> float: ...

    def note_group_rate(
        self, group: str, rate: float, now: float = 0.0
    ) -> None: ...

    def group_rates(self) -> Mapping[str, float]: ...

    def note_group_class(self, group: str, memory_class: str) -> None: ...

    def group_classes(self) -> Mapping[str, str]: ...

    def pressure(
        self, view: Optional["LedgerView"] = None
    ) -> "PressurePlan": ...

    def cache_pressure(self, group: str) -> float: ...

    def demotion_pressure(self, group: str) -> float: ...

    @property
    def suspended_queue(self) -> Sequence[str]: ...

    @property
    def has_suspended(self) -> bool: ...


class BasePolicy:
    """Default implementations: FIFO suspension queue + round-robin assign.

    The round-robin ``assign`` reproduces Spark's fair-pool core handout
    (and the cursor semantics the simulator previously inlined): the cursor
    persists across calls; draining a group does not advance it, so the
    next group slides into the cursor's slot.
    """

    name = "base"
    proactive = False
    period: float = 1.0
    #: admit new work while pool usage stays below this fraction of
    #: capacity (1.0 = stock: fill to the brim, handle pressure reactively)
    admission_headroom: float = 1.0

    def __init__(self) -> None:
        self._suspended: List[str] = []  # FIFO: index 0 = first suspended
        self._cursor = 0

    # ------------------------------------------------------------ properties
    @property
    def suspended_queue(self) -> Sequence[str]:
        return tuple(self._suspended)

    @property
    def has_suspended(self) -> bool:
        return bool(self._suspended)

    # ----------------------------------------------------------------- hooks
    def propose(
        self,
        pool: "MemoryPool",
        running: Sequence["TaskStats"],
        now: float = 0.0,
        suspended: Sequence["TaskStats"] = (),
    ) -> SchedulingDecision:
        return SchedulingDecision(reason=self.name)

    def on_task_complete(self, task_id: Optional[str] = None) -> Optional[str]:
        if self._suspended:
            return self._suspended.pop(0)
        return None

    def on_full_gc(self, pool: "MemoryPool") -> List[str]:
        return []

    def drop(self, task_id: str) -> None:
        self._suspended = [t for t in self._suspended if t != task_id]

    # ------------------------------------------------------ pressure surface
    @staticmethod
    def _zero_score(group: str) -> float:
        """Stock per-group score: 0.0 for everyone — cold-cache eviction
        falls back to pure LRU and frozen KV never demotes proactively."""
        return 0.0

    @staticmethod
    def _fifo_shed_key(group: str, row: Mapping[str, float]) -> tuple:
        """Stock shed key: earliest-arrived group sheds first (FIFO) —
        rate-oblivious, the baseline the usage-rate order is measured
        against."""
        return (row.get("arrival_seq", 0.0),)

    def pressure(self, view=None) -> "PressurePlan":
        """The one memory-pressure surface: a :class:`PressurePlan` built
        from the class-stamped ledger ``view`` (may be ``None`` when the
        caller has no ledger, e.g. at wiring time).

        The stock plan keeps the default class orders (evict ``SCRATCH``,
        then ``COLD_CACHED``, then demote ``FROZEN``) with zero scores
        everywhere: pure-LRU cache eviction, never-proactive demotion,
        FIFO front-door shedding.  Subclasses override THIS method —
        ``cache_pressure`` / ``demotion_pressure`` / ``shed_order`` below
        are wrappers reading the plan and must not be overridden."""
        from repro_torch.serve.ledger import PageClass, PressurePlan

        return PressurePlan(
            scores={
                PageClass.COLD_CACHED: self._zero_score,
                PageClass.FROZEN: self._zero_score,
            },
            shed_key=self._fifo_shed_key,
        )

    # ------------------------------------------------------------ cache hint
    def cache_pressure(self, group: str) -> float:
        """Evictability of ``group``'s cold cached pages — the plan's
        ``COLD_CACHED`` score (stock: 0.0 for everyone → pure LRU)."""
        from repro_torch.serve.ledger import PageClass

        return self.pressure().score(PageClass.COLD_CACHED, group)

    # --------------------------------------------------------- demotion hint
    def demotion_pressure(self, group: str) -> float:
        """How eagerly ``group``'s frozen KV should demote to the host
        tier ahead of need — the plan's ``FROZEN`` score (stock: 0.0 for
        everyone → only ever the reactive spill path)."""
        from repro_torch.serve.ledger import PageClass

        return self.pressure().score(PageClass.FROZEN, group)

    # ------------------------------------------------------------- placement
    def placement_score(
        self, group: str, replica_stats: Mapping[str, float]
    ) -> float:
        """Cross-replica placement preference: 0.0 for every replica →
        the router's round-robin tie-break decides (the stock baseline
        spreads requests across replicas with no pressure awareness)."""
        return 0.0

    def scale_pressure(
        self, replica_stats: Sequence[Mapping[str, float]]
    ) -> float:
        """Fleet-level demand signal for the cluster's elastic autoscaler,
        in [0, 1]: the fraction of the fleet's capacity the policy
        considers committed.  The scaling controller spawns a replica
        when this stays above its up-threshold and drains one when it
        stays below its down-threshold (see
        ``repro_torch.serve.cluster.ScalingConfig``).

        The base/fair reading is SLOT occupancy — mean ``slot_load``
        across replicas — because a rate-oblivious policy only sees how
        many batch rows are busy or queued for.  MURS overrides this with
        the usage-rate surface (projected byte demand): a fleet whose
        slots are idle but whose admitted requests will grow into the
        pool is already overcommitted in the only currency that matters
        under §III (future allocation), so MURS scales on usage-rate
        while FAIR scales on slot-load.
        """
        if not replica_stats:
            return 0.0
        loads = [min(float(s.get("slot_load", 0.0)), 2.0) for s in replica_stats]
        return min(sum(loads) / len(loads), 1.0)

    def note_group_rate(
        self, group: str, rate: float, now: float = 0.0
    ) -> None:
        """Feed one group-level usage-rate observation into the policy.
        A cluster router never runs ``propose`` (it has no pool), so this
        is how the per-replica rate signal reaches its placement scores;
        the base policy keeps no rate state and ignores it."""

    def group_rates(self) -> Mapping[str, float]:
        """The policy's current per-group usage-rate estimates (empty for
        rate-oblivious policies) — what a cluster forwards from replica
        policies into its router."""
        return {}

    def note_group_class(self, group: str, memory_class: str) -> None:
        """Declare the ARCHITECTURE memory class of ``group``'s model
        (one of ``configs.MEMORY_CLASSES``) — the static generalization
        of the paper's per-API-function classes.  A mamba tenant's byte
        demand is constant no matter how long its requests run; a
        long-context transformer tenant's grows linearly.  The base
        policy is class-oblivious and ignores it."""

    def group_classes(self) -> Mapping[str, str]:
        """Per-group declared memory classes (empty for class-oblivious
        policies) — mirrors :meth:`group_rates` for the cluster's
        forwarding path."""
        return {}

    def shed_order(
        self,
        groups: Sequence[str],
        stats: Mapping[str, Mapping[str, float]],
    ) -> List[str]:
        """Admission-overload shed order: FIRST element is shed first.

        Called by the serving front door when projected demand crosses its
        pressure threshold — new arrivals from the leading groups are
        rejected (503) until the overshoot is covered.  ``stats`` maps each
        group to ``{"rate", "demand_bytes", "arrival_seq"}`` (usage-rate
        estimate, in-flight projected bytes, first-seen order).

        A wrapper over the plan's ``shed_key``: the base/fair key is FIFO
        over group arrival, MURS sheds the highest-usage-rate group first,
        PriorityPolicy by inverse weight.  Override :meth:`pressure`, not
        this.
        """
        key = self.pressure().shed_key
        return sorted(groups, key=lambda g: key(g, stats.get(g, {})))

    def assign(self, free: int, pending: Mapping[str, int]) -> List[str]:
        """Round-robin over groups with pending work; one pick per core."""
        groups = [g for g, n in pending.items() if n > 0]
        remaining = {g: pending[g] for g in groups}
        picks: List[str] = []
        while free > 0 and groups:
            self._cursor %= len(groups)
            g = groups[self._cursor]
            picks.append(g)
            remaining[g] -= 1
            free -= 1
            if remaining[g] <= 0:
                groups.remove(g)
            else:
                self._cursor += 1
        return picks
