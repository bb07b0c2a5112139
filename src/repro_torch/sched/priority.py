"""Tenant-weighted priority policy — proof the policy layer is pluggable.

Two levers, both weight-driven:

  * placement: ``assign`` is stride scheduling — each group (tenant/job)
    holds a pass value advanced by 1/weight per granted core, so a weight-2
    tenant receives twice the cores of a weight-1 tenant over time, yet
    low-weight tenants never starve (their pass eventually becomes minimal).
  * pressure: above ``shed_threshold`` live occupancy the policy sheds
    FUTURE GROWTH weight-ordered — it keeps the highest-weight tenants'
    tasks whose projected growth fits the headroom still free below pool
    capacity and suspends the rest (lowest weight, then highest growth,
    first).  Resume is FIFO
    on completion (inherited) and wholesale once usage drops below
    ``resume_below``.

Weights come from the constructor; tasks are mapped to groups via the
``group`` field the Sampler stamps on :class:`TaskStats` (job id in the
simulator, tenant in the serving engine).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence

from .protocol import BasePolicy, SchedulingDecision

if TYPE_CHECKING:
    from repro_torch.core.memory_manager import MemoryPool
    from repro_torch.core.sampler import TaskStats

__all__ = ["PriorityConfig", "PriorityPolicy"]


@dataclass(frozen=True)
class PriorityConfig:
    """Weights and thresholds for :class:`PriorityPolicy`."""

    weights: Mapping[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    #: live occupancy at which weight-ordered shedding starts
    shed_threshold: float = 0.6
    #: live occupancy below which all suspended tasks resume
    resume_below: float = 0.4
    min_running: int = 1
    period: float = 1.0

    def __post_init__(self) -> None:
        if not (0.0 < self.resume_below <= self.shed_threshold <= 1.0):
            raise ValueError(
                "need 0 < resume_below <= shed_threshold <= 1, got "
                f"{self.resume_below}, {self.shed_threshold}"
            )
        for g, w in self.weights.items():
            if w <= 0.0:
                raise ValueError(f"weight for {g!r} must be positive, got {w}")


class PriorityPolicy(BasePolicy):
    """Weighted stride placement + weight-ordered pressure shedding."""

    name = "priority"
    proactive = True

    def __init__(self, config: Optional[PriorityConfig] = None) -> None:
        super().__init__()
        self.config = config or PriorityConfig()
        self.period = self.config.period
        self.admission_headroom = self.config.shed_threshold
        self._pass: Dict[str, float] = {}  # stride-scheduling pass values

    def weight_of(self, group: str) -> float:
        return self.config.weights.get(group, self.config.default_weight)

    # ------------------------------------------------------------- placement
    def assign(self, free: int, pending: Mapping[str, int]) -> List[str]:
        remaining = {g: n for g, n in pending.items() if n > 0}
        if not remaining:
            return []
        # a newly seen group starts at the current minimum pass so it is
        # neither starved nor allowed to monopolize cores
        floor = min(
            (self._pass[g] for g in remaining if g in self._pass), default=0.0
        )
        for g in remaining:
            self._pass.setdefault(g, floor)
        picks: List[str] = []
        while free > 0 and remaining:
            g = min(remaining, key=lambda x: (self._pass[x], x))
            picks.append(g)
            self._pass[g] += 1.0 / self.weight_of(g)
            remaining[g] -= 1
            if remaining[g] <= 0:
                del remaining[g]
            free -= 1
        return picks

    def _shed_key(self, group: str, row) -> tuple:
        """Shed lowest-weight groups first (by 1/weight): under admission
        overload a paid/priority tenant's arrivals are the last to 503.
        Ties fall back to group arrival order (FIFO)."""
        return (self.weight_of(group), row.get("arrival_seq", 0.0))

    # ------------------------------------------------------ cluster placement
    def placement_score(self, group: str, replica_stats) -> float:
        """Weight-proportional routing: every tenant avoids loaded
        replicas, but a high-weight tenant's aversion is divided down —
        its scores sit closer to zero, so on a contended routing pass
        (the cluster places best-score-first) it claims the emptiest
        replica ahead of low-weight traffic.  Replica load blends byte
        demand and slot occupancy evenly (no rate signal here)."""
        demand = max(
            float(replica_stats.get("demand_fraction", 0.0)),
            float(replica_stats.get("projected_fraction", 0.0)),
        )
        slots = float(replica_stats.get("slot_load", 0.0))
        return -0.5 * (demand + slots) / self.weight_of(group)

    # ------------------------------------------------------ pressure surface
    def _weight_score(self, group: str) -> float:
        """Weight-ordered reclaim: a low-weight tenant's pages go first
        (1/(1+w) keeps the score in (0, 1) and monotone in weight)."""
        return 1.0 / (1.0 + self.weight_of(group))

    def pressure(self, view=None):
        """Weight-ordered :class:`~repro_torch.serve.ledger.PressurePlan`: cold
        cached prefixes evict and frozen KV demotes low-weight-first (the
        same 1/(1+w) score ranks who pays for pressure in both classes),
        and the front door sheds by inverse weight."""
        from repro_torch.serve.ledger import PageClass, PressurePlan

        return PressurePlan(
            scores={
                PageClass.COLD_CACHED: self._weight_score,
                PageClass.FROZEN: self._weight_score,
            },
            shed_key=self._shed_key,
        )

    # -------------------------------------------------------------- pressure
    def propose(
        self,
        pool: "MemoryPool",
        running: Sequence["TaskStats"],
        now: float = 0.0,
        suspended: Sequence["TaskStats"] = (),
    ) -> SchedulingDecision:
        cfg = self.config
        usage = pool.live_fraction
        if usage < cfg.resume_below:
            if self._suspended:
                resumed = list(self._suspended)
                self._suspended.clear()
                return SchedulingDecision(resume=resumed, reason="below-resume")
            return SchedulingDecision(reason="light")
        if usage < cfg.shed_threshold or self._suspended:
            # below the shed line, or pressure already being handled
            return SchedulingDecision(reason="steady")

        # Shed future growth weight-first: keep high-weight tenants' tasks
        # while their projected growth fits the remaining headroom below
        # CAPACITY (suspension freezes a task's buffer but stops its
        # growth — the shed line only decides when shedding starts, the
        # growth budget is everything still free in the pool).
        headroom = max(pool.capacity - pool.live_bytes, 0.0)
        keep_order = sorted(
            running,
            key=lambda t: (
                -self.weight_of(t.group),
                t.rate * t.remaining_bytes,
                t.task_id,
            ),
        )
        kept = 0
        suspend: List["TaskStats"] = []
        for t in keep_order:
            growth = t.rate * t.remaining_bytes
            if kept < cfg.min_running or growth <= headroom:
                kept += 1
                headroom -= growth
            else:
                suspend.append(t)
        # FIFO resume should bring back the highest-weight victims first
        suspend.sort(
            key=lambda t: (-self.weight_of(t.group), t.rate * t.remaining_bytes)
        )
        ids = [t.task_id for t in suspend]
        self._suspended.extend(ids)
        return SchedulingDecision(
            suspend=ids, reason="weight-shed" if ids else "fits"
        )
