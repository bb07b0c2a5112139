"""Typed serving reports: per-request outcomes, SLO latency summaries, goodput.

``ServingEngine.run()`` / ``ServingCluster.run()`` (and the
:class:`repro_torch.serve.frontdoor.FrontDoor` wrapping them) return a
:class:`ServeReport` instead of a loose ``Dict[str, Any]``.  The report
carries:

* per-request :class:`RequestOutcome` rows — every submission ends in
  exactly one of ``completed / failed / shed / rate_limited / lost /
  unfinished`` (the conservation property the front-door tests check);
* :class:`LatencySummary` percentiles for end-to-end latency, TTFT
  (time-to-first-token) and TPOT (time-per-output-token);
* **goodput** — completions that met their tenant's :class:`SloSpec`,
  per tick.  Under overload this replaces raw throughput as the headline
  metric: a system that "completes" every request 50× past its latency
  target has throughput but no goodput.

The legacy dict payload lives in :attr:`ServeReport.extras`.  (The
one-release ``__getitem__`` dict-access shim has been removed: use the
typed fields, or ``report.extras[...]`` for legacy keys.)
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

__all__ = [
    "COMPLETED",
    "FAILED",
    "LOST",
    "RATE_LIMITED",
    "SHED",
    "UNFINISHED",
    "LatencySummary",
    "RequestOutcome",
    "ServeReport",
    "SloSpec",
    "percentile",
]

# terminal outcomes — every submission ends in exactly one of these
COMPLETED = "completed"
FAILED = "failed"
SHED = "shed"  # rejected at the front door by projected-demand shedding
RATE_LIMITED = "rate_limited"  # rejected by the tenant's token bucket
LOST = "lost"  # cluster: in flight on a crashed replica, retries exhausted
UNFINISHED = "unfinished"  # still live when the tick budget ran out


def percentile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over an ascending-sorted sequence."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, round(q * (len(sorted_vals) - 1)))
    return sorted_vals[idx]


@dataclass(frozen=True)
class SloSpec:
    """Per-tenant service-level objective, in engine ticks.  A ``None``
    bound is unconstrained; an outcome missing the measurement for a set
    bound (e.g. cluster rows carry no TTFT) skips that dimension rather
    than failing it."""

    ttft_ticks: Optional[float] = None
    tpot_ticks: Optional[float] = None
    latency_ticks: Optional[float] = None

    def met(self, outcome: "RequestOutcome") -> bool:
        """True if a COMPLETED outcome satisfies every configured bound
        (TTFT / TPOT / end-to-end, in ticks)."""
        if outcome.outcome != COMPLETED:
            return False
        for bound, value in (
            (self.ttft_ticks, outcome.ttft_ticks),
            (self.tpot_ticks, outcome.tpot_ticks),
            (self.latency_ticks, outcome.latency_ticks),
        ):
            if bound is not None and value is not None and value > bound:
                return False
        return True


@dataclass
class RequestOutcome:
    """How one submission ended — the conservation unit: every request a
    front door ever saw maps to exactly one row."""

    request_id: str
    tenant: str
    outcome: str  # one of the module-level terminal constants
    submit_tick: int = 0
    finish_tick: int = -1
    first_token_tick: int = -1  # -1 = never emitted a token
    tokens: int = 0  # tokens actually generated
    reason: str = ""  # optional detail (shed reason, failure mode)
    #: arch name the request targeted ("" = the run's single implicit
    #: model) — heterogeneous-fleet runs key per-model goodput on this
    model: str = ""

    @property
    def latency_ticks(self) -> Optional[int]:
        """End-to-end submit→finish ticks; None while unfinished."""
        if self.finish_tick < 0:
            return None
        return self.finish_tick - self.submit_tick

    @property
    def ttft_ticks(self) -> Optional[int]:
        """Submit→first-token ticks; None before the first token."""
        if self.first_token_tick < 0:
            return None
        return self.first_token_tick - self.submit_tick

    @property
    def tpot_ticks(self) -> Optional[float]:
        """Mean ticks per generated token after the first (decode cadence)."""
        if self.first_token_tick < 0 or self.finish_tick < 0 or self.tokens < 1:
            return None
        return (self.finish_tick - self.first_token_tick) / max(
            1, self.tokens - 1
        )


@dataclass
class LatencySummary:
    """Count / mean / tail percentiles of one latency distribution."""

    count: int = 0
    mean: Optional[float] = None
    p50: Optional[float] = None
    p95: Optional[float] = None
    p99: Optional[float] = None

    @classmethod
    def from_values(cls, values: Sequence[float]) -> "LatencySummary":
        """Percentile summary of the non-None values (empty-safe)."""
        vals = sorted(v for v in values if v is not None)
        if not vals:
            return cls()
        return cls(
            count=len(vals),
            mean=sum(vals) / len(vals),
            p50=percentile(vals, 0.50),
            p95=percentile(vals, 0.95),
            p99=percentile(vals, 0.99),
        )


@dataclass
class ServeReport:
    """Typed result of one serving run (engine, cluster, or front door).

    ``goodput`` is completions-within-SLO per tick; with no SLO applied
    every completion counts, so ``goodput`` degenerates to the completion
    rate.  Call :meth:`apply_slo` to re-score against per-tenant
    :class:`SloSpec` bounds (the front door does this automatically).
    """

    policy: str = ""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    shed: int = 0
    rate_limited: int = 0
    ticks: int = 0
    tokens_generated: int = 0
    throughput_tokens_per_tick: float = 0.0
    slo_good: int = 0
    goodput: float = 0.0
    latency: LatencySummary = field(default_factory=LatencySummary)
    ttft: LatencySummary = field(default_factory=LatencySummary)
    tpot: LatencySummary = field(default_factory=LatencySummary)
    outcomes: List[RequestOutcome] = field(default_factory=list, repr=False)
    #: sub-reports (plain dicts, shape-stable with the legacy payloads)
    tiering: Optional[Dict[str, Any]] = None
    prefix: Optional[Dict[str, Any]] = None
    cluster: Optional[Dict[str, Any]] = None
    #: the ledger's class-stamped memory breakdown (``MemoryLedger.stats()``
    #: shape: per-class / per-tier bytes, peaks, spill, the recount bit)
    memory: Optional[Dict[str, Any]] = None
    #: the full legacy dict payload (reach it explicitly: ``.extras``)
    extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------- scoring
    def refresh_summaries(self) -> "ServeReport":
        """Recompute latency/TTFT/TPOT summaries and counts from
        :attr:`outcomes` (call after merging front-door rows in)."""
        done = [o for o in self.outcomes if o.outcome == COMPLETED]
        self.completed = len(done)
        self.failed = sum(1 for o in self.outcomes if o.outcome == FAILED)
        self.shed = sum(1 for o in self.outcomes if o.outcome == SHED)
        self.rate_limited = sum(
            1 for o in self.outcomes if o.outcome == RATE_LIMITED
        )
        self.latency = LatencySummary.from_values(
            [o.latency_ticks for o in done]
        )
        self.ttft = LatencySummary.from_values([o.ttft_ticks for o in done])
        self.tpot = LatencySummary.from_values([o.tpot_ticks for o in done])
        return self

    def apply_slo(
        self,
        slos: Optional[Mapping[str, SloSpec]] = None,
        default: Optional[SloSpec] = None,
    ) -> "ServeReport":
        """Score completions against per-tenant SLOs and recompute
        ``slo_good`` / ``goodput``.  Tenants absent from ``slos`` use
        ``default``; with neither, every completion is good."""
        slos = slos or {}
        good = 0
        for o in self.outcomes:
            if o.outcome != COMPLETED:
                continue
            spec = slos.get(o.tenant, default)
            if spec is None or spec.met(o):
                good += 1
        self.slo_good = good
        self.goodput = good / max(1, self.ticks)
        return self

    def tenant_summary(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant outcome counts (diagnosing who shedding hit)."""
        out: Dict[str, Dict[str, int]] = {}
        for o in self.outcomes:
            row = out.setdefault(o.tenant, {})
            row[o.outcome] = row.get(o.outcome, 0) + 1
        return out

    def model_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-model outcome counts, goodput, and completed-latency p99 —
        the heterogeneous-fleet view (which architecture class is being
        starved / shed / failed).  Rows with no model tag group under
        ``""``.  ``goodput`` here counts completions per tick (the SLO
        scoring, if any, already happened in :meth:`apply_slo` — per-model
        ``slo_good`` splits that same population)."""
        out: Dict[str, Dict[str, Any]] = {}
        for o in self.outcomes:
            row = out.setdefault(
                o.model,
                {"outcomes": {}, "completed_latency": []},
            )
            counts = row["outcomes"]
            counts[o.outcome] = counts.get(o.outcome, 0) + 1
            if o.outcome == COMPLETED and o.latency_ticks is not None:
                row["completed_latency"].append(o.latency_ticks)
        for model, row in out.items():
            lat = sorted(row.pop("completed_latency"))
            done = row["outcomes"].get(COMPLETED, 0)
            row["completed"] = done
            row["goodput"] = done / max(1, self.ticks)
            row["latency_p99"] = percentile(lat, 0.99)
        return out

    # --------------------------------------------------------------- (de)ser
    def to_json(self, include_outcomes: bool = False) -> Dict[str, Any]:
        """Plain-JSON dict (what the benchmarks record).  Outcome rows are
        omitted by default — thousands of them would swamp the bench
        artifact."""
        out = {
            "policy": self.policy,
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "shed": self.shed,
            "rate_limited": self.rate_limited,
            "ticks": self.ticks,
            "tokens_generated": self.tokens_generated,
            "throughput_tokens_per_tick": self.throughput_tokens_per_tick,
            "slo_good": self.slo_good,
            "goodput": self.goodput,
            "latency": asdict(self.latency),
            "ttft": asdict(self.ttft),
            "tpot": asdict(self.tpot),
            "tiering": self.tiering,
            "prefix": self.prefix,
            "cluster": self.cluster,
            "memory": self.memory,
        }
        if include_outcomes:
            out["outcomes"] = [asdict(o) for o in self.outcomes]
        return out

    @classmethod
    def from_json(cls, payload: Mapping[str, Any]) -> "ServeReport":
        """Rebuild a report from :meth:`to_json` output (artifact
        round-trip; unknown keys are ignored)."""
        rep = cls(
            policy=payload.get("policy", ""),
            submitted=payload.get("submitted", 0),
            completed=payload.get("completed", 0),
            failed=payload.get("failed", 0),
            shed=payload.get("shed", 0),
            rate_limited=payload.get("rate_limited", 0),
            ticks=payload.get("ticks", 0),
            tokens_generated=payload.get("tokens_generated", 0),
            throughput_tokens_per_tick=payload.get(
                "throughput_tokens_per_tick", 0.0
            ),
            slo_good=payload.get("slo_good", 0),
            goodput=payload.get("goodput", 0.0),
            latency=LatencySummary(**payload.get("latency", {}) or {}),
            ttft=LatencySummary(**payload.get("ttft", {}) or {}),
            tpot=LatencySummary(**payload.get("tpot", {}) or {}),
            tiering=payload.get("tiering"),
            prefix=payload.get("prefix"),
            cluster=payload.get("cluster"),
            memory=payload.get("memory"),
        )
        rep.outcomes = [
            RequestOutcome(**row) for row in payload.get("outcomes", [])
        ]
        return rep

    def json_str(self, include_outcomes: bool = False) -> str:
        return json.dumps(self.to_json(include_outcomes), sort_keys=True)
