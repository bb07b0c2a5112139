"""Admission control at the serving front door: token buckets + shedding.

The paper's spill-avoidance, moved to the door.  Every MURS mechanism
inside the engine (suspend, demote, tier) mitigates pressure from work
*already admitted*; under sustained overload the cheapest byte to manage
is the one never allocated.  :class:`FrontDoor` wraps anything
satisfying :class:`repro_torch.serve.server.Server` and applies two gates to
each arrival, in order:

1. **per-tenant token bucket** — classic rate limiting (lazy refill:
   ``tokens = min(burst, tokens + elapsed * rate)``); a dry bucket
   rejects with :data:`~repro_torch.serve.report.RATE_LIMITED`;
2. **projected-demand shedding** — the §III-B admission idea at cluster
   scope: each request's page-rounded *peak* bytes (prompt + declared
   max_new_tokens) are known at admission.  When total projected bytes
   (in-flight + inbound) cross ``pressure_threshold × capacity``, the
   scheduling policy's ``shed_order`` hook ranks tenant groups and the
   leading groups' arrivals are rejected (503,
   :data:`~repro_torch.serve.report.SHED`) until enough of the projected
   demand belongs to shed groups to cover the overshoot.  MURS sheds the
   highest-usage-rate group first; priority sheds by 1/weight; fair
   sheds FIFO.

Every submission ends in exactly one outcome row — admitted requests
resolve through the wrapped server's report, rejected ones are recorded
here — which is the conservation property the tests check: nothing is
ever silently dropped.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.sched import BasePolicy, SchedulingPolicy
from repro_torch.serve.engine import Request
from repro_torch.serve.report import (
    RATE_LIMITED,
    SHED,
    RequestOutcome,
    ServeReport,
    SloSpec,
)

__all__ = ["FrontDoor", "FrontDoorConfig", "TokenBucket"]


@dataclass
class TokenBucket:
    """Lazily refilled token bucket: ``rate`` tokens per tick, capped at
    ``burst``.  Starts full."""

    rate: float
    burst: float
    tokens: Optional[float] = None
    last_tick: float = 0.0

    def __post_init__(self) -> None:
        if self.rate < 0 or self.burst <= 0:
            raise ValueError(
                f"need rate >= 0 and burst > 0, got {self.rate}/{self.burst}"
            )
        if self.tokens is None:
            self.tokens = self.burst

    def try_take(self, now: float, cost: float = 1.0) -> bool:
        """Lazy-refill then take ``cost`` tokens; False = rate-limited."""
        if now > self.last_tick:
            self.tokens = min(
                self.burst, self.tokens + (now - self.last_tick) * self.rate
            )
            self.last_tick = now
        if self.tokens + 1e-9 >= cost:
            self.tokens -= cost
            return True
        return False


@dataclass
class FrontDoorConfig:
    """Admission knobs: shed threshold, token buckets, SLOs (DESIGN.md
    §9; tuning table in docs/OPERATIONS.md)."""

    #: projected-demand fraction of capacity above which shedding starts;
    #: >= 1.0 still sheds (overcommit by declared peak), inf disables
    pressure_threshold: float = 0.95
    #: per-tenant token-bucket parameters as (rate_per_tick, burst)
    buckets: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    #: bucket for tenants not listed in ``buckets``; None = unlimited
    default_bucket: Optional[Tuple[float, float]] = None
    #: per-tenant SLOs scored into the report's goodput
    slos: Dict[str, SloSpec] = field(default_factory=dict)
    default_slo: Optional[SloSpec] = None
    #: shed-order provider; None → the wrapped server's policy (falls
    #: back to BasePolicy FIFO when the server exposes none)
    policy: Optional[SchedulingPolicy] = None


class FrontDoor:
    """Admission layer in front of a :class:`~repro_torch.serve.server.Server`.

    Satisfies the ``Server`` protocol itself, so traffic drivers and
    benchmarks are indifferent to whether a front door is present.
    """

    def __init__(
        self, server: Any, cfg: Optional[FrontDoorConfig] = None
    ) -> None:
        self.server = server
        self.cfg = cfg or FrontDoorConfig()
        self.policy: SchedulingPolicy = (
            self.cfg.policy
            if self.cfg.policy is not None
            else getattr(server, "policy", None) or BasePolicy()
        )
        self._buckets: Dict[str, TokenBucket] = {}
        self._group_seq: Dict[str, int] = {}  # tenant → first-seen order
        self._rejected: List[RequestOutcome] = []
        self.submitted = 0
        self.admitted = 0
        self.shed_count = 0
        self.rate_limited_count = 0
        self.shed_by_tenant: Dict[str, int] = {}

    # ----------------------------------------------------- Server protocol
    @property
    def tick(self) -> int:
        return self.server.tick

    @property
    def has_pending(self) -> bool:
        return self.server.has_pending

    def replica_stats(self) -> Dict[str, float]:
        return self.server.replica_stats()

    def step(self) -> None:
        self.server.step()

    # ------------------------------------------------------------ admission
    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        bucket = self._buckets.get(tenant)
        if bucket is None:
            params = self.cfg.buckets.get(tenant, self.cfg.default_bucket)
            if params is None:
                return None
            bucket = TokenBucket(rate=params[0], burst=params[1])
            self._buckets[tenant] = bucket
        return bucket

    def _reject(self, req: Request, outcome: str, reason: str) -> bool:
        now = self.server.tick
        self._rejected.append(
            RequestOutcome(
                request_id=req.request_id,
                tenant=req.tenant,
                outcome=outcome,
                submit_tick=now,
                finish_tick=now,
                reason=reason,
                model=req.model,
            )
        )
        if outcome == SHED:
            self.shed_count += 1
            self.shed_by_tenant[req.tenant] = (
                self.shed_by_tenant.get(req.tenant, 0) + 1
            )
        else:
            self.rate_limited_count += 1
        return False

    def _shed_groups(self, overshoot: float, tenant: str) -> Optional[set]:
        """The set of tenant groups whose NEW arrivals are rejected right
        now: a prefix of the policy's ``shed_order`` whose in-flight
        projected demand covers the overshoot.  Returns None when even
        shedding every known group cannot cover it (reject everyone)."""
        demand: Dict[str, float] = dict(
            getattr(self.server, "group_demand", dict)() or {}
        )
        demand.setdefault(tenant, 0.0)
        rates: Mapping[str, float] = self.policy.group_rates() or {}
        groups = sorted(demand, key=lambda g: self._group_seq.get(g, 1 << 30))
        stats = {
            g: {
                "rate": float(rates.get(g, 0.0)),
                "demand_bytes": demand[g],
                "arrival_seq": float(self._group_seq.get(g, 1 << 30)),
            }
            for g in groups
        }
        order = self.policy.shed_order(groups, stats)
        shed: set = set()
        freed = 0.0
        for g in order:
            if freed >= overshoot:
                break
            shed.add(g)
            freed += demand.get(g, 0.0)
        if freed < overshoot:
            return None
        return shed

    def submit(self, req: Request) -> bool:
        """Admit or reject one arrival; True = handed to the server."""
        self.submitted += 1
        self._group_seq.setdefault(req.tenant, len(self._group_seq))
        bucket = self._bucket_for(req.tenant)
        if bucket is not None and not bucket.try_take(float(self.server.tick)):
            return self._reject(req, RATE_LIMITED, "token bucket dry")
        stats = self.server.replica_stats()
        cap = float(stats.get("capacity_bytes", 0.0))
        if cap > 0.0:
            estimate = getattr(self.server, "estimate_request_bytes", None)
            inbound = estimate(req) if estimate is not None else 0.0
            projected = float(stats.get("projected_bytes", 0.0)) + inbound
            overshoot = projected - self.cfg.pressure_threshold * cap
            if overshoot > 0.0:
                shed = self._shed_groups(overshoot, req.tenant)
                if shed is None or req.tenant in shed:
                    return self._reject(
                        req, SHED, "projected demand over threshold"
                    )
        self.server.submit(req)
        self.admitted += 1
        return True

    # ------------------------------------------------------------------ run
    def run(self, max_ticks: int = 1000) -> ServeReport:
        """Drain the wrapped server, merge in the door's rejection rows,
        and score goodput against the configured SLOs."""
        report = self.server.run(max_ticks=max_ticks)
        report.outcomes = list(report.outcomes) + list(self._rejected)
        report.submitted = self.submitted
        report.refresh_summaries()
        report.apply_slo(self.cfg.slos, self.cfg.default_slo)
        report.extras["admitted"] = self.admitted
        report.extras["shed"] = self.shed_count
        report.extras["rate_limited"] = self.rate_limited_count
        report.extras["shed_by_tenant"] = dict(self.shed_by_tenant)
        report.extras["per_model"] = report.model_summary()
        return report
