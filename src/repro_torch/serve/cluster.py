"""ServingCluster: N engine replicas behind a usage-rate-aware router.

The paper's setting is a *service*: many tenants' traffic lands on shared
servers at once, and pressure on one server degrades everyone on it.  A
single :class:`~repro_torch.serve.engine.ServingEngine` mitigates pressure
WITHIN one HBM pool; this module is the step the ROADMAP calls "from a
server to a service" — the same pluggable policy layer applied ACROSS
replicas:

* **Routing** goes through ``SchedulingPolicy.placement_score(group,
  replica_stats)``: the router scores every (queued request, replica)
  pair against live replica stats (byte demand net of reclaimable cache,
  slot occupancy — both including the bytes already routed this pass) and
  places best-score-first.  The base score of 0.0 everywhere makes FAIR
  pure round-robin; :class:`MursPolicy` blends demand vs slot load by the
  tenant's usage-rate EMA (§III applied across machines); PriorityPolicy
  divides its aversion by tenant weight so heavy-weight traffic claims
  the emptiest replica on contended passes.

* **Straggler detection** reuses :class:`repro_torch.dist.fault.
  StragglerDetector` verbatim over each replica's modeled tick service
  time (``ServingEngine.last_tick_cost`` × any injected slowdown — a
  deterministic stand-in for wall clock).  A flagged replica triggers
  **live request migration**: the victim's KV leaves the replica via
  :meth:`ServingEngine.export_request` (slot-cache subtree for running
  work, frozen payloads for suspended work, compressed tier blocks for
  demoted pages), crosses a modeled inter-replica link (the same
  :class:`~repro_torch.serve.tiers.PcieLink` FIFO-drain semantics, at network
  rate, compressed bytes), and lands on the best target at delivery time
  via :meth:`ServingEngine.import_request`.

* **Crash recovery** is a fault-injection hook (:meth:`crash_replica`):
  the replica's live requests lose their KV (that is what a crash means)
  but not their identity — each is requeued through a per-request
  :class:`repro_torch.dist.fault.RestartManager` (bounded retries, capped
  exponential backoff in ticks) and replays on whichever replica the
  router picks; only a request that exhausts its retry budget is lost.

* **Elastic autoscaling** (DESIGN.md §11) thresholds the routing
  policy's ``scale_pressure`` — the same projected-demand surfaces
  placement scoring reads, folded to one fleet-level number in [0, 1]
  (MURS scales on where the BYTES are going, FAIR on slot occupancy).
  Sustained pressure above ``scale_up_pressure`` spawns a replica
  (unparking a drained slot before growing the fleet); sustained slack
  below ``scale_down_pressure`` **drains** one: new work stops routing
  to it, and each live request leaves via an *incremental* migration —
  a :meth:`ServingEngine.precopy_request` snapshot ships in the
  background while the replica keeps serving, then the cutover
  :meth:`ServingEngine.export_request` re-ships only the pages the
  write-epoch ledger marks dirty since the pre-copy.  The cutover
  (service-interrupting) bytes are gated below the monolithic full-copy
  counterfactual the ticket records alongside.

* **KV checkpointing** closes the loop with the disk tier: every
  ``checkpoint_every_ticks`` the cluster packs each replica's
  :meth:`ServingEngine.snapshot_kv` (shared-prefix pages first, §6
  lifetime order) into a self-describing ``repro_torch.checkpoint`` file —
  manifest leaf first, one array leaf per page.  :meth:`crash_replica`
  then restores victims found in the newest checkpoint via
  :meth:`ServingEngine.restore_request` and replays only the suffix the
  checkpoint did not cover, instead of the from-zero reset un-covered
  victims still get.  Checkpoint bytes are their own stream
  (``TieredKVStore.note_checkpoint``), distinct from spill AND from
  migration wire bytes.

Migration traffic is NOT spill (DESIGN.md §8): ``migration.wire_bytes``
crosses the inter-replica link to keep a request alive somewhere better,
while spill parks bytes below HBM on the same machine.  The two are
recorded separately and gated separately.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.checkpoint import _msgpack, latest_step_path, restore_leaves
from repro_torch.checkpoint import save as checkpoint_save
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.fault import RestartManager, StragglerDetector
from repro_torch.sched import FairPolicy, SchedulingPolicy
from repro_torch.serve.engine import (
    EngineConfig,
    PrecopySnapshot,
    Request,
    ServingEngine,
)
from repro_torch.serve.ledger import PageClass
from repro_torch.serve.report import (
    COMPLETED,
    FAILED,
    LOST,
    UNFINISHED,
    RequestOutcome,
    ServeReport,
)
from repro_torch.serve.tiers import PcieLink

__all__ = ["ClusterConfig", "ReplicaCrash", "ServingCluster"]


class ReplicaCrash(RuntimeError):
    """The failure a crashed replica's requests are retried against."""


def _merge_tick_costs(stats: List[dict]) -> dict:
    """Cluster view of the replicas' roofline tick-cost distributions
    (same shape as ``ServingEngine.tick_cost_stats``: modeled seconds,
    tick-weighted mean, min/max envelope)."""
    ticks = sum(s["ticks"] for s in stats)
    return {
        "source": "roofline",
        "ticks": ticks,
        "mean_s": (
            sum(s["mean_s"] * s["ticks"] for s in stats) / ticks
            if ticks else 0.0
        ),
        "min_s": min(
            (s["min_s"] for s in stats if s["ticks"]), default=0.0
        ),
        "max_s": max((s["max_s"] for s in stats), default=0.0),
        "paged_decode_ticks": sum(s["paged_decode_ticks"] for s in stats),
    }


@dataclass
class ClusterConfig:
    """Replica count, routing policy, link model, and fault knobs."""

    #: engine-config FACTORY — called once per replica (and per restart),
    #: because a policy instance is stateful and must never be shared
    engine: Callable[[], EngineConfig] = EngineConfig
    n_replicas: int = 2
    #: cluster-level routing policy (placement_score / assign); None →
    #: FairPolicy, i.e. pure round-robin spraying
    router: Optional[SchedulingPolicy] = None
    #: inter-replica link rate in bytes/tick (migrations FIFO-drain at
    #: this rate; compressed bytes cross, same arithmetic as the PCIe
    #: model).  inf → migration lands next tick.
    net_bytes_per_tick: float = float("inf")
    # ---- straggler pass (repro_torch.dist.fault.StragglerDetector)
    straggler_min_samples: int = 8
    straggler_ratio: float = 1.5
    straggler_window: int = 32
    #: max live migrations initiated per straggler per pass
    migrate_batch: int = 2
    #: ticks a replica is left alone after migrations were pulled off it
    #: (its window mean needs time to reflect the lighter load)
    migration_cooldown_ticks: int = 8
    # ---- crash recovery (RestartManager-style bounded retry)
    max_retries: int = 3
    retry_backoff_ticks: float = 2.0
    max_backoff_ticks: float = 16.0
    # ---- elastic autoscaling (DESIGN.md §11)
    #: threshold the router policy's ``scale_pressure`` every tick;
    #: False → the fleet stays at ``n_replicas`` forever
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    #: pressure in [0,1] that must hold for ``scale_sustain_ticks``
    #: before a replica is added / drained (hysteresis band between)
    scale_up_pressure: float = 0.75
    scale_down_pressure: float = 0.30
    scale_sustain_ticks: int = 25
    #: ticks between scaling actions (lets the routed load re-settle)
    scale_cooldown_ticks: int = 50
    #: drain via incremental pre-copy + dirty-page delta cutover;
    #: False → monolithic one-shot exports at cutover
    precopy_drain: bool = True
    # ---- periodic KV checkpointing (crash restore; 0 → disabled)
    checkpoint_every_ticks: int = 0
    checkpoint_dir: Optional[str] = None
    #: page cap per snapshot — truncates AFTER the §6 shared-first
    #: ordering, so a tight budget still holds the longest-lived pages
    checkpoint_page_budget: Optional[int] = None
    #: newest files kept per replica directory
    checkpoint_keep: int = 2

    def __post_init__(self) -> None:
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.net_bytes_per_tick <= 0:
            raise ValueError("net_bytes_per_tick must be > 0")
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not self.scale_down_pressure <= self.scale_up_pressure:
            raise ValueError(
                "scale_down_pressure must be <= scale_up_pressure"
            )
        if self.checkpoint_every_ticks > 0 and not self.checkpoint_dir:
            raise ValueError(
                "checkpoint_every_ticks needs a checkpoint_dir"
            )


class ServingCluster:
    """N :class:`ServingEngine` replicas, one router, one straggler pass.

    The cluster owns its own clock: every :meth:`step` routes queued
    requests, drains the inter-replica link, ticks every live replica in
    lockstep, feeds the straggler detector, and harvests completions.
    Request latency is measured in CLUSTER ticks from first submission —
    a crash-requeued request keeps its original submit stamp, so retries
    show up as tail latency, never as amnesia.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        ccfg: ClusterConfig,
        models: Optional[List[Tuple[ArchConfig, Any]]] = None,
    ) -> None:
        self.cfg = cfg
        self.params = params
        self.ccfg = ccfg
        self.router: SchedulingPolicy = ccfg.router or FairPolicy()
        #: per-replica hosted model — ``models[i]`` is the (ArchConfig,
        #: params) replica ``i`` serves.  Default: every replica hosts
        #: the cluster's single model (the homogeneous fleet).  A
        #: heterogeneous model zoo passes one entry per replica; the
        #: router then only places a request on replicas hosting its
        #: declared ``Request.model``.
        if models is None:
            models = [(cfg, params)] * ccfg.n_replicas
        if len(models) != ccfg.n_replicas:
            raise ValueError(
                f"models must have one (cfg, params) entry per replica: "
                f"got {len(models)} for {ccfg.n_replicas} replicas"
            )
        self._models: List[Tuple[ArchConfig, Any]] = list(models)
        self.replicas: List[ServingEngine] = [
            ServingEngine(mcfg, mparams, ccfg.engine())
            for mcfg, mparams in self._models
        ]
        self.link = PcieLink()  # the inter-replica network, same semantics
        self.detector = StragglerDetector(
            min_samples=ccfg.straggler_min_samples,
            ratio=ccfg.straggler_ratio,
            window=ccfg.straggler_window,
        )
        self.tick = 0
        self.queue: List[Request] = []  # cluster-level admission queue
        self._rr_cursor = 0  # round-robin tie-break over replicas
        #: rid → replica index (or -1 while its bytes are on the wire)
        self._home: Dict[str, int] = {}
        self._inflight: Dict[str, Any] = {}  # rid → MigrationTicket
        self._submit_tick: Dict[str, int] = {}
        self._finish_tick: Dict[str, int] = {}
        #: per-request crash-retry budget (RestartManager reused verbatim;
        #: its backoff seconds are read as cluster ticks)
        self._retry: Dict[str, RestartManager] = {}
        #: (due_tick, request) — crash-requeued work waiting out backoff
        self._requeue: List[Tuple[int, Request]] = []
        self._slowdown: List[float] = [1.0] * ccfg.n_replicas
        self._last_migration: List[int] = [-(10**9)] * ccfg.n_replicas
        self._done_seen: List[int] = [0] * ccfg.n_replicas
        self._failed_seen: List[int] = [0] * ccfg.n_replicas
        self._tokens_from_dead = 0.0
        self.completed: List[str] = []
        self.failed: List[str] = []
        self.lost: List[str] = []  # retry budget exhausted after crashes
        #: typed router rejections: no active (or revivable) replica
        #: hosts the request's model — recorded in ``failed`` too, with
        #: the reason on the outcome row (never a silent drop)
        self.unroutable: List[str] = []
        #: requests that died at the router (never reached an engine) —
        #: kept so their outcome rows still carry tenant/model/reason
        self._unrouted: Dict[str, Request] = {}
        self.crashes = 0
        self.requeued = 0
        self.migrations_started = 0
        self.migrations_completed = 0
        self.migration_raw_bytes = 0.0
        self.migration_wire_bytes = 0.0
        self.straggler_flags = 0  # straggler-pass detections
        # ---- elastic autoscaling state
        #: drained replica slots: excluded from routing, stepping, and
        #: stats; the parallel per-replica lists stay index-stable and a
        #: scale-up UNPARKS the lowest slot before growing the fleet
        self._parked: Set[int] = set()
        #: replica index → tick its drain began (no new work routes
        #: there; live work leaves via pre-copy + delta cutover)
        self._draining: Dict[int, int] = {}
        #: "pre:<rid>" → (PrecopySnapshot, source) while the background
        #: copy is on the link; cutover fires at delivery
        self._precopy: Dict[str, Tuple[PrecopySnapshot, int]] = {}
        self._pressure_high = 0  # consecutive ticks above the up line
        self._pressure_low = 0  # consecutive ticks below the down line
        self._last_scale_tick = -(10**9)
        self.last_scale_pressure = 0.0
        self.scale_ups = 0
        self.scale_downs = 0
        self.peak_replicas = ccfg.n_replicas
        self.precopies_started = 0
        self.delta_cutovers = 0
        self.migration_delta_wire_bytes = 0.0
        self.migration_full_wire_bytes = 0.0  # monolithic counterfactual
        self.migration_precopy_wire_bytes = 0.0
        # ---- checkpoint / restore state
        self.ckpt_saved = 0
        self.ckpt_restored_requests = 0
        self.ckpt_restored_tokens = 0  # token positions restore kept
        self.ckpt_replayed_tokens = 0  # uncovered suffix actually redone
        self.ckpt_from_zero_tokens = 0  # what a cold reset would redo
        self.ckpt_outcomes: Dict[str, int] = {}

    # -------------------------------------------------------------- tenants
    def submit(self, req: Request) -> bool:
        """Accept one request for routing; always True (the cluster never
        rejects — wrap it in a FrontDoor for admission control)."""
        self._submit_tick.setdefault(req.request_id, self.tick)
        self.queue.append(req)
        return True

    @property
    def policy(self) -> SchedulingPolicy:
        """The cluster-scope policy a wrapping FrontDoor sheds with."""
        return self.router

    def hosted_models(self) -> List[str]:
        """Arch name each replica slot hosts (parked slots included —
        an unpark revives the same model)."""
        return [mcfg.name for mcfg, _ in self._models]

    def _capable(self, replica: int, req: Request) -> bool:
        """True when ``replica`` hosts the request's declared model (an
        untagged request runs anywhere — the homogeneous-fleet case)."""
        return (
            not req.model or self._models[replica][0].name == req.model
        )

    def _capable_for_model(self, replica: int, model: str) -> bool:
        return not model or self._models[replica][0].name == model

    def estimate_request_bytes(self, req: Request) -> float:
        """Page-rounded peak bytes, sized by a replica that HOSTS the
        request's model — a mamba request's demand must never be priced
        with a transformer's per-token geometry."""
        for i in range(len(self.replicas)):
            if self._capable(i, req):
                return self.replicas[i].estimate_request_bytes(req)
        return self.replicas[0].estimate_request_bytes(req)

    def group_demand(self) -> Dict[str, float]:
        """Projected peak bytes per tenant across the whole cluster:
        every replica's live demand plus everything routed but not yet
        placed (cluster queue, crash-requeued work, migrations in
        flight)."""
        out: Dict[str, float] = {}
        for i in self._active_indices():
            for tenant, nbytes in self.replicas[i].group_demand().items():
                out[tenant] = out.get(tenant, 0.0) + nbytes
        waiting = [r for r in self.queue]
        waiting.extend(r for _, r in self._requeue)
        waiting.extend(t.request for t, _ in self._inflight.values())
        for req in waiting:
            out[req.tenant] = (
                out.get(req.tenant, 0.0) + self.estimate_request_bytes(req)
            )
        return out

    def _active_indices(self) -> List[int]:
        """Replica indices that are on (not parked).  Draining replicas
        stay active — they are still serving what they are migrating."""
        return [
            i for i in range(len(self.replicas)) if i not in self._parked
        ]

    def replica_stats(self) -> Dict[str, float]:
        """Cluster-aggregate load surface, same keys as the engine's —
        capacity and projected bytes sum across ACTIVE replicas (plus
        unplaced work), fractions byte-weighted over summed capacity.
        Parked replicas contribute nothing: their capacity is off."""
        active = [self.replicas[i] for i in self._active_indices()]
        per = [eng.replica_stats() for eng in active]
        cap = sum(s["capacity_bytes"] for s in per)
        projected_bytes = sum(s["projected_bytes"] for s in per)
        unplaced = (
            len(self.queue) + len(self._requeue) + len(self._inflight)
        )
        for req in self.queue:
            projected_bytes += self.estimate_request_bytes(req)
        for _, req in self._requeue:
            projected_bytes += self.estimate_request_bytes(req)
        for ticket, _ in self._inflight.values():
            projected_bytes += self.estimate_request_bytes(ticket.request)
        demand_bytes = sum(
            s["demand_fraction"] * s["capacity_bytes"] for s in per
        )
        used_bytes = sum(
            s["used_fraction"] * s["capacity_bytes"] for s in per
        )
        n_slots = sum(eng.ecfg.n_slots for eng in active)
        out = {
            "demand_fraction": demand_bytes / cap if cap > 0 else 0.0,
            "projected_fraction": projected_bytes / cap if cap > 0 else 0.0,
            "used_fraction": used_bytes / cap if cap > 0 else 0.0,
            "slot_load": (
                sum(s["slot_load"] * eng.ecfg.n_slots
                    for s, eng in zip(per, active))
                + unplaced
            ) / max(n_slots, 1),
            "free_slots": float(sum(s["free_slots"] for s in per)),
            "queued": float(
                sum(s["queued"] for s in per) + len(self.queue)
                + len(self._requeue)
            ),
            "live": float(sum(s["live"] for s in per) + unplaced),
            "suspended": float(sum(s["suspended"] for s in per)),
            "tick_cost": max(s["tick_cost"] for s in per),
            "capacity_bytes": float(cap),
            "projected_bytes": float(projected_bytes),
        }
        # the class-aware fleet view: per-lifetime-class HBM bytes summed
        # across active replicas (each replica's row is its ledger's
        # breakdown) — what placement and scale_pressure read per-class
        for cls in PageClass:
            key = f"{cls.value}_bytes"
            out[key] = float(sum(s.get(key, 0.0) for s in per))
        out["frozen_fraction"] = (
            out[f"{PageClass.FROZEN.value}_bytes"] / cap if cap > 0 else 0.0
        )
        out["reclaimable_fraction"] = (
            sum(
                s.get("reclaimable_fraction", 0.0) * s["capacity_bytes"]
                for s in per
            )
            / cap
            if cap > 0
            else 0.0
        )
        return out

    def memory_stats(self) -> Dict[str, Any]:
        """Fleet memory view: every replica's ledger stats summed
        key-wise (per-class, per-tier, peaks, projected, spill), with
        ``ledger_matches_recount`` the AND across replicas — ONE replica
        drifting fails the fleet's hard bit."""
        per = [eng.memory_stats() for eng in self.replicas]
        out: Dict[str, Any] = {
            "by_class": {},
            "peak_by_class": {},
            "by_tier": {},
            "hbm_bytes": 0.0,
            "projected_bytes": 0.0,
            "disk_spill_bytes": 0.0,
            "ledger_matches_recount": True,
        }
        for s in per:
            for key in ("by_class", "peak_by_class", "by_tier"):
                agg = out[key]
                for k, v in s.get(key, {}).items():
                    agg[k] = agg.get(k, 0.0) + v
            for key in ("hbm_bytes", "projected_bytes", "disk_spill_bytes"):
                out[key] += float(s.get(key, 0.0))
            out["ledger_matches_recount"] = out[
                "ledger_matches_recount"
            ] and bool(s.get("ledger_matches_recount", True))
        return out

    # ------------------------------------------------------- fault injection
    def set_slowdown(self, replica: int, factor: float) -> None:
        """Throttle a replica by ``factor`` (models a noisy neighbour /
        thermal throttle / failing host — the straggler the detector
        exists to catch).  The slowdown is REAL, not just observed: a
        replica at factor f steps only every ~f cluster ticks, so its
        requests genuinely crawl and migrating them off genuinely helps;
        the detector sees the matching f× service time."""
        if factor <= 0:
            raise ValueError("slowdown factor must be > 0")
        self._slowdown[replica] = factor

    def crash_replica(self, replica: int) -> int:
        """Kill and restart one replica.  Its HBM KV is gone; its
        requests are not.  A victim found in the replica's newest disk
        checkpoint restores onto the fresh engine immediately
        (:meth:`ServingEngine.restore_request`) with its checkpointed
        position and tokens — only the suffix the checkpoint did not
        cover replays.  Every other live/queued victim is reset to a
        cold start and requeued after a bounded, capped backoff —
        unless its retry budget is exhausted, in which case it is
        recorded as lost (and failed).  Returns the number of requests
        requeued (restored victims are not requeued — they never left
        the replica)."""
        eng = self.replicas[replica]
        self._harvest_replica(replica)  # terminal states survive a crash
        # only DELIVERED work survives in the token count: a live
        # victim's pre-crash tokens die with the KV and are regenerated
        # elsewhere — counting them too would let a crash inflate the
        # gated cluster throughput above what was actually served
        self._tokens_from_dead += sum(
            len(r.generated)
            for r in eng.requests.values()
            if r.state in ("done", "failed")
        )
        # a drain mid-flight dies with the process: pending pre-copies
        # reference the dead engine's pages and epochs — a cutover
        # against them after restart would merge stale baselines
        self._draining.pop(replica, None)
        self._precopy = {
            k: v for k, v in self._precopy.items() if v[1] != replica
        }
        ckpt = self._read_checkpoint(replica)
        mcfg, mparams = self._models[replica]
        fresh = ServingEngine(mcfg, mparams, self.ccfg.engine())
        victims = [rid for rid, _ in eng.migratable_requests()]
        requeued = 0
        for rid in victims:
            req = eng.requests[rid]
            entry = ckpt.get(rid)
            if entry is not None:
                self._restore_victim(fresh, req, entry, replica)
                continue
            self._home.pop(rid, None)
            rm = self._retry.setdefault(
                rid,
                RestartManager(
                    "",
                    max_retries=self.ccfg.max_retries,
                    backoff_s=self.ccfg.retry_backoff_ticks,
                    max_backoff_s=self.ccfg.max_backoff_ticks,
                ),
            )
            if not rm.should_retry():
                self.lost.append(rid)
                self.failed.append(rid)
                self._finish_tick[rid] = self.tick
                continue
            delay = rm.on_failure(ReplicaCrash(f"replica {replica} died"))
            self._reset_request(req)
            self._requeue.append((self.tick + int(round(delay)), req))
            requeued += 1
        self.requeued += requeued
        # restart: a fresh engine (fresh policy state, empty pool); the
        # detector forgets the dead process's samples
        self.replicas[replica] = fresh
        self.detector.forget(self._host(replica))
        self._slowdown[replica] = 1.0
        self._done_seen[replica] = 0
        self._failed_seen[replica] = 0
        self.crashes += 1
        return requeued

    @staticmethod
    def _reset_request(req: Request) -> None:
        """Back to a cold start: the crash took the KV and every token
        generated so far; identity and the prompt survive."""
        req.slot = -1
        req.pos = 0
        req.generated = []
        req.state = "queued"
        req.finish_tick = -1
        req.first_token_tick = -1
        req.cached_tokens = 0
        req.snap_key = None
        req.hit_counted = False

    # -------------------------------------------------------- checkpointing
    def _ckpt_dir(self, replica: int) -> str:
        return os.path.join(
            str(self.ccfg.checkpoint_dir), self._host(replica)
        )

    def _checkpoint_pass(self) -> None:
        """Every ``checkpoint_every_ticks``: snapshot each active
        replica's KV (shared-prefix pages first, §6 lifetime order) into
        a self-describing checkpoint file under the replica's directory,
        pruning all but the newest ``checkpoint_keep``."""
        cc = self.ccfg
        if cc.checkpoint_every_ticks <= 0 or not cc.checkpoint_dir:
            return
        if self.tick == 0 or self.tick % cc.checkpoint_every_ticks:
            return
        for i in self._active_indices():
            snap = self.replicas[i].snapshot_kv(cc.checkpoint_page_budget)
            if snap is not None:
                self._write_checkpoint(i, snap)

    def _write_checkpoint(self, replica: int, snap: Dict[str, Any]) -> None:
        """Pack one :meth:`ServingEngine.snapshot_kv` result into the
        flat self-describing format :func:`repro_torch.checkpoint.
        restore_leaves` reads back: leaf 0 is a MessagePack manifest
        (epoch + per-request rid/pos/generated/page-index list), then
        one array leaf per checkpointed page in manifest order."""
        manifest: Dict[str, Any] = {"epoch": int(snap["epoch"]), "reqs": []}
        leaves: List[np.ndarray] = [np.zeros(0, dtype=np.uint8)]
        for entry in snap["reqs"]:
            idxs = sorted(entry["pages"])
            manifest["reqs"].append(
                {
                    "rid": entry["rid"],
                    "pos": int(entry["pos"]),
                    "generated": [int(t) for t in entry["generated"]],
                    "pages": idxs,
                }
            )
            leaves.extend(np.asarray(entry["pages"][j]) for j in idxs)
        blob = _msgpack.packb(manifest)
        leaves[0] = np.frombuffer(blob, dtype=np.uint8)
        d = self._ckpt_dir(replica)
        checkpoint_save(
            os.path.join(d, f"ckpt_{self.tick}.ckpt"),
            leaves,
            step=self.tick,
        )
        self.ckpt_saved += 1
        keep = max(self.ccfg.checkpoint_keep, 1)
        names = sorted(
            (
                n
                for n in os.listdir(d)
                if n.startswith("ckpt_") and n.endswith(".ckpt")
            ),
            key=lambda n: int(n[5:-5]),
        )
        for n in names[:-keep]:
            os.unlink(os.path.join(d, n))

    def _read_checkpoint(
        self, replica: int
    ) -> Dict[str, Dict[str, Any]]:
        """Load the replica's newest checkpoint back into
        ``rid → {"pos", "generated", "pages": {index: payload}}`` (empty
        when checkpointing is off, no file exists, or the file is
        unreadable — crash recovery then falls back to cold resets)."""
        cc = self.ccfg
        if cc.checkpoint_every_ticks <= 0 or not cc.checkpoint_dir:
            return {}
        path = latest_step_path(self._ckpt_dir(replica))
        if path is None:
            return {}
        try:
            leaves, _step = restore_leaves(path)
            manifest = _msgpack.unpackb(leaves[0].tobytes())
        except Exception:
            return {}  # a torn/alien file must not turn crash into loss
        out: Dict[str, Dict[str, Any]] = {}
        cursor = 1
        for entry in manifest["reqs"]:
            pages: Dict[int, np.ndarray] = {}
            for idx in entry["pages"]:
                pages[int(idx)] = leaves[cursor]
                cursor += 1
            out[entry["rid"]] = {
                "pos": int(entry["pos"]),
                "generated": list(entry["generated"]),
                "pages": pages,
            }
        return out

    def _restore_victim(
        self,
        fresh: ServingEngine,
        req: Request,
        entry: Dict[str, Any],
        replica: int,
    ) -> None:
        """Land one crash victim from checkpointed state onto the
        replacement engine: position and tokens roll back to the
        checkpoint's values (everything after it died with the HBM),
        then :meth:`ServingEngine.restore_request` replays only what the
        checkpointed pages do not cover.  The from-zero counterfactual
        (what the cold-reset path would recompute) is recorded so the
        bench can gate restored replay strictly below it."""
        pos_at_crash = req.pos
        req.slot = -1
        req.finish_tick = -1
        req.cached_tokens = 0
        req.snap_key = None
        req.pos = int(entry["pos"])
        req.generated = list(entry["generated"])
        outcome = fresh.restore_request(req, entry["pages"])
        self._home[req.request_id] = replica
        self.ckpt_restored_requests += 1
        self.ckpt_restored_tokens += req.pos
        self.ckpt_replayed_tokens += max(pos_at_crash - req.pos, 0)
        self.ckpt_from_zero_tokens += pos_at_crash
        self.ckpt_outcomes[outcome] = (
            self.ckpt_outcomes.get(outcome, 0) + 1
        )

    # -------------------------------------------------------------- routing
    def _host(self, replica: int) -> str:
        return f"r{replica}"

    def _fail_unroutable(self, req: Request, why: str) -> None:
        """Typed router rejection: the request ends FAILED with an
        ``unroutable:`` reason on its outcome row — never a division
        error on an empty fleet, never a silent drop."""
        rid = req.request_id
        req.state = "failed"
        req.fail_reason = f"unroutable: {why}"
        req.finish_tick = self.tick
        self._submit_tick.setdefault(rid, self.tick)
        self._finish_tick[rid] = self.tick
        self.unroutable.append(rid)
        self.failed.append(rid)
        self._unrouted[rid] = req
        self._home.pop(rid, None)
        self._retry.pop(rid, None)

    def _unpark_capable(self, req: Request) -> Optional[int]:
        """Revive a parked replica that hosts ``req.model`` (autoscale
        fleets only — a hand-parked fleet stays parked and the request
        fails typed instead).  Returns the revived index or None."""
        if not self.ccfg.autoscale:
            return None
        for i in sorted(self._parked):
            if self._capable(i, req):
                self._parked.discard(i)
                self.scale_ups += 1
                self._last_scale_tick = self.tick
                return i
        return None

    def _route(self) -> None:
        """Place every queued request: score each (request, replica) pair
        via the router policy's ``placement_score``, place best-first,
        and fold each placement's estimated bytes/slot back into the
        stats so one routing pass cannot stack a burst onto the replica
        that merely LOOKED emptiest when the pass began.

        Capability comes first: a request tagged with a model only ever
        scores replicas HOSTING that model.  A request no scored replica
        can host falls back layer by layer — flagged stragglers, then a
        parked capable slot (autoscale revives it) — and only then fails
        with a typed ``unroutable`` outcome."""
        if not self.queue:
            return
        # parked replicas are off; draining replicas take no NEW work
        # (the whole point of a drain) — but if everything is draining,
        # serve anyway rather than starve the queue
        candidates = [
            i for i in self._active_indices() if i not in self._draining
        ]
        if not candidates:
            candidates = self._active_indices()
        if not candidates:
            # all-parked fleet: revive a slot (autoscale) or fail typed —
            # the scoring loop below must never see an empty stats map
            pending, self.queue = self.queue, []
            still: List[Request] = []
            for req in pending:
                revived = self._unpark_capable(req)
                if revived is not None:
                    candidates.append(revived)
                    still.append(req)
                elif candidates and any(
                    self._capable(i, req) for i in candidates
                ):
                    still.append(req)
                else:
                    self._fail_unroutable(req, "all replicas parked")
            if not candidates:
                return
            self.queue = still
            if not self.queue:
                return
        stats = {
            i: dict(self.replicas[i].replica_stats()) for i in candidates
        }
        caps = {
            i: max(self.replicas[i].pool.capacity, 1.0) for i in candidates
        }
        flagged = self._flagged_indices()
        if flagged and any(i not in flagged for i in stats):
            # never route NEW work onto a detected straggler while a
            # healthy replica exists — placement_score has no straggler
            # axis, so the router enforces this exclusion itself
            stats = {i: s for i, s in stats.items() if i not in flagged}

        def admit_stats(i: int) -> None:
            stats[i] = dict(self.replicas[i].replica_stats())
            caps[i] = max(self.replicas[i].pool.capacity, 1.0)

        pending, self.queue = self.queue, []
        routable: List[Request] = []
        for req in pending:
            if any(self._capable(i, req) for i in stats):
                routable.append(req)
                continue
            # sole capable replica was excluded as a straggler: routing
            # to a slow host beats failing the request
            fallback = next(
                (i for i in candidates if self._capable(i, req)), None
            )
            if fallback is not None:
                admit_stats(fallback)
                routable.append(req)
                continue
            revived = self._unpark_capable(req)
            if revived is not None:
                admit_stats(revived)
                routable.append(req)
                continue
            self._fail_unroutable(
                req, f"no active replica hosts model {req.model!r}"
            )
        pending = routable
        while pending:
            best: Optional[Tuple[float, int, int, int]] = None
            for qpos, req in enumerate(pending):
                for i in stats:
                    if not self._capable(i, req):
                        continue
                    s = self.router.placement_score(req.tenant, stats[i])
                    # ties (score AND queue order) break round-robin via
                    # the cursor distance, so the base policy's all-zero
                    # scores reproduce classic round-robin spraying
                    rr = (i - self._rr_cursor) % len(self.replicas)
                    cand = (s, -qpos, -rr, i)
                    if best is None or cand > best:
                        best = cand
            if best is None:  # defensive: partition above guarantees not
                for req in pending:
                    self._fail_unroutable(
                        req, f"no scored replica hosts model {req.model!r}"
                    )
                return
            _, nqpos, _, target = best
            req = pending.pop(-nqpos)
            eng = self.replicas[target]
            inbound = eng.estimate_request_bytes(req)
            stats[target]["demand_fraction"] += inbound / caps[target]
            stats[target]["projected_fraction"] = (
                stats[target].get("projected_fraction", 0.0)
                + inbound / caps[target]
            )
            stats[target]["slot_load"] += 1.0 / max(eng.ecfg.n_slots, 1)
            stats[target]["queued"] += 1.0
            eng.submit(req)
            self._home[req.request_id] = target
            self._rr_cursor = (target + 1) % len(self.replicas)

    def _flagged_indices(self) -> Set[int]:
        return {int(h[1:]) for h in self.detector.stragglers()}

    def _pick_target(
        self, group: str, exclude: Set[int], model: str = ""
    ) -> Optional[int]:
        """Best replica for a migrating request, at DELIVERY time — so a
        target that crashed, started straggling, parked, or began its
        own drain while the bytes were in flight is simply never chosen
        (falling back layer by layer when exclusions cover everyone).

        ``model`` is a HARD filter at every layer: migration refuses
        cross-arch targets outright — a transformer's KV pages mean
        nothing to a mamba replica.  Returns None when no capable
        replica exists at all."""

        def hosts(i: int) -> bool:
            return self._capable_for_model(i, model)

        avoid = set(exclude) | self._parked | set(self._draining)
        cands = [
            i
            for i in range(len(self.replicas))
            if i not in avoid and hosts(i)
        ]
        if not cands:  # only excluded replicas left: drop the soft axes
            cands = [
                i
                for i in self._active_indices()
                if i not in self._draining and hosts(i)
            ]
        if not cands:
            cands = [i for i in self._active_indices() if hosts(i)]
        if not cands:
            cands = [
                i for i in range(len(self.replicas)) if hosts(i)
            ]
        if not cands:
            return None  # no capable replica anywhere: caller decides
        best: Optional[Tuple[float, int, int]] = None
        for i in cands:
            s = self.router.placement_score(
                group, self.replicas[i].replica_stats()
            )
            rr = (i - self._rr_cursor) % len(self.replicas)
            cand = (s, -rr, i)
            if best is None or cand > best:
                best = cand
        return best[2]

    def _has_capable_target(self, model: str, exclude: Set[int]) -> bool:
        """Any non-parked replica outside ``exclude`` hosting ``model``?
        Consulted BEFORE exporting a request off its source — an export
        with nowhere to land would strand the only copy of its state."""
        return any(
            i not in exclude
            and i not in self._parked
            and self._capable_for_model(i, model)
            for i in range(len(self.replicas))
        )

    # ------------------------------------------------------------ migration
    def migrate(self, request_id: str, source: int) -> bool:
        """Begin live migration of one request off ``source``: extract its
        state, put the compressed bytes on the inter-replica link, and
        deliver to the best target when the transfer completes.  Returns
        False when the request is not there / not migratable — or when
        NO other replica hosts its model (migration refuses cross-arch
        targets, so exporting would strand the state)."""
        req = self.replicas[source].requests.get(request_id)
        if req is not None and not self._has_capable_target(
            req.model, exclude={source}
        ):
            return False
        ticket = self.replicas[source].export_request(request_id)
        if ticket is None:
            return False
        self._inflight[request_id] = (ticket, source)
        self._home[request_id] = -1
        self.migrations_started += 1
        self.migration_raw_bytes += ticket.raw_bytes
        self.migration_wire_bytes += ticket.wire_bytes
        self.link.send(
            request_id, ticket.wire_bytes, self.ccfg.net_bytes_per_tick
        )
        return True

    def _cutover(self, rid: str, snap: PrecopySnapshot, source: int) -> None:
        """Phase two of an incremental drain: the pre-copy bytes have
        landed, so export the request NOW with the snapshot as the
        baseline — the ticket ships only the dirty delta; the pre-copy
        plus delta replace what one monolithic copy would have moved."""
        req = self.replicas[source].requests.get(rid)
        if req is not None and not self._has_capable_target(
            req.model, exclude={source}
        ):
            return  # nowhere capable to land: the request stays put
        ticket = self.replicas[source].export_request(rid, baseline=snap)
        if ticket is None:
            return  # finished (or moved) while the pre-copy was in flight
        self._inflight[rid] = (ticket, source)
        self._home[rid] = -1
        self.migrations_started += 1
        self.migration_raw_bytes += ticket.raw_bytes
        self.migration_wire_bytes += ticket.wire_bytes
        if ticket.full_wire_bytes > 0:
            # the delta path ran: record cutover vs counterfactual
            self.delta_cutovers += 1
            self.migration_delta_wire_bytes += ticket.wire_bytes
            self.migration_full_wire_bytes += ticket.full_wire_bytes
            self.migration_precopy_wire_bytes += ticket.precopy_wire_bytes
        self.link.send(
            rid, ticket.wire_bytes, self.ccfg.net_bytes_per_tick
        )

    def _deliver_migrations(self) -> None:
        for tr in self.link.tick():
            key = str(tr.key)
            if key.startswith("pre:"):
                pre = self._precopy.pop(key, None)
                if pre is not None:
                    self._cutover(key[4:], pre[0], pre[1])
                continue
            entry = self._inflight.pop(tr.key, None)
            if entry is None:
                continue
            ticket, source = entry
            # exclude the source AND every currently-flagged straggler:
            # with 3+ replicas a victim must land on a healthy one, not
            # hop between two slow machines paying wire bytes each time
            target = self._pick_target(
                ticket.request.tenant,
                exclude={source} | self._flagged_indices(),
                model=ticket.request.model,
            )
            if target is None:
                # every capable replica vanished while the bytes were on
                # the wire (crash + repark): fail typed, never import
                # cross-arch and never drop silently
                self._fail_unroutable(
                    ticket.request,
                    f"no capable migration target for model "
                    f"{ticket.request.model!r}",
                )
                continue
            self.replicas[target].import_request(ticket)
            self._home[tr.key] = target
            self.migrations_completed += 1

    def _straggler_pass(self) -> None:
        flagged = self.detector.stragglers()
        if not flagged:
            return
        healthy = {
            i
            for i in range(len(self.replicas))
            if self._host(i) not in flagged
        }
        if not healthy:
            return  # everyone is slow: migration would just churn
        for host in flagged:
            i = int(host[1:])
            if i in self._draining or i in self._parked:
                continue  # the drain is already emptying it
            if (
                self.tick - self._last_migration[i]
                < self.ccfg.migration_cooldown_ticks
            ):
                continue
            victims = self.replicas[i].migratable_requests()
            moved = 0
            for rid, _state in victims:
                if moved >= self.ccfg.migrate_batch:
                    break
                if self.migrate(rid, i):
                    moved += 1
            if moved:
                self.straggler_flags += 1
                self._last_migration[i] = self.tick

    # ----------------------------------------------------- elastic scaling
    def _scale_pass(self) -> None:
        """Threshold the routing policy's ``scale_pressure`` with
        hysteresis: the signal must hold past the up/down line for
        ``scale_sustain_ticks`` consecutive ticks, and actions are
        ``scale_cooldown_ticks`` apart — a diurnal swell scales the
        fleet, a single bursty tick does not."""
        cc = self.ccfg
        serving = [
            i for i in self._active_indices() if i not in self._draining
        ]
        self.peak_replicas = max(self.peak_replicas, len(serving))
        if not cc.autoscale:
            return
        if not serving:
            # an all-parked fleet with autoscale on must be able to
            # revive itself: pending work IS maximal pressure (the mean
            # over zero replicas would divide by nothing / read as calm)
            if self.queue or self._requeue or self._inflight:
                self._scale_up()
            return
        stats = [self.replicas[i].replica_stats() for i in serving]
        pressure = self.router.scale_pressure(stats)
        self.last_scale_pressure = pressure
        if pressure >= cc.scale_up_pressure:
            self._pressure_high += 1
            self._pressure_low = 0
        elif pressure <= cc.scale_down_pressure:
            self._pressure_low += 1
            self._pressure_high = 0
        else:  # the hysteresis band: both streaks break
            self._pressure_high = 0
            self._pressure_low = 0
        if self.tick - self._last_scale_tick < cc.scale_cooldown_ticks:
            return
        if (
            self._pressure_high >= cc.scale_sustain_ticks
            and len(serving) < cc.max_replicas
        ):
            self._scale_up()
            self._pressure_high = 0
        elif (
            self._pressure_low >= cc.scale_sustain_ticks
            and len(serving) > cc.min_replicas
            and not self._draining  # one drain at a time
        ):
            # drain the emptiest replica: fewest live requests to move
            victim = min(
                serving,
                key=lambda i: (
                    self.replicas[i].replica_stats()["live"],
                    -i,  # ties drain the highest index
                ),
            )
            self._begin_drain(victim)
            self._pressure_low = 0

    def _scale_up(self) -> None:
        """Add one serving replica: unpark the lowest drained slot if
        one exists (its engine is already fresh), else grow the fleet —
        every per-replica parallel list grows with it."""
        if self._parked:
            self._parked.discard(min(self._parked))
        else:
            # a grown slot hosts the cluster's default model
            self._models.append((self.cfg, self.params))
            self.replicas.append(
                ServingEngine(self.cfg, self.params, self.ccfg.engine())
            )
            self._slowdown.append(1.0)
            self._last_migration.append(-(10**9))
            self._done_seen.append(0)
            self._failed_seen.append(0)
        self.scale_ups += 1
        self._last_scale_tick = self.tick

    def drain_replica(self, replica: int) -> int:
        """Operator-initiated drain (planned maintenance, a deploy, or
        manual scale-in): ``replica`` stops receiving new work and its
        live requests leave via the same incremental pre-copy + delta
        cutover an autoscaler drain uses; the slot parks once empty and
        a later scale-up can unpark it.  Returns how many live requests
        began a background pre-copy (zero-KV and un-snapshottable work
        moves monolithically on the next tick instead)."""
        if replica in self._parked or replica in self._draining:
            return 0
        before = self.precopies_started
        self._begin_drain(replica)
        return self.precopies_started - before

    def _begin_drain(self, replica: int) -> None:
        """Start emptying one replica for scale-down.  Routing stops
        sending it new work immediately; each live request's resident
        pages pre-copy onto the link WHILE the replica keeps serving it
        (the request keeps decoding — and dirtying pages — until its
        pre-copy lands and :meth:`_cutover` ships just the delta)."""
        self._draining[replica] = self.tick
        self._last_scale_tick = self.tick
        if not self.ccfg.precopy_drain:
            return  # _drain_pass will export monolithically instead
        eng = self.replicas[replica]
        for rid, _state in eng.migratable_requests():
            snap = eng.precopy_request(rid)
            if snap is None:
                continue  # queued / constant-state: monolithic later
            key = "pre:" + rid
            self._precopy[key] = (snap, replica)
            self.precopies_started += 1
            self.migration_raw_bytes += snap.raw_bytes
            self.migration_wire_bytes += snap.wire_bytes
            self.link.send(
                key, snap.wire_bytes, self.ccfg.net_bytes_per_tick
            )

    def _drain_pass(self) -> None:
        """Advance every in-progress drain: export whatever is not
        already pre-copying (queued work ships zero bytes; anything the
        pre-copy pass could not snapshot goes monolithically), then park
        the replica once it is empty and its pre-copies have cut over."""
        for i in list(self._draining):
            eng = self.replicas[i]
            pending = {
                k[4:] for k, (_s, src) in self._precopy.items() if src == i
            }
            for rid, _state in eng.migratable_requests():
                if rid in pending or rid in self._inflight:
                    continue
                self.migrate(rid, i)
            if not eng.has_pending and not pending:
                self._park(i)

    def _park(self, replica: int) -> None:
        """Finish a drain: harvest the last completions, switch the slot
        off, and leave a fresh engine in it so a later unpark starts
        cold (the drained process's policy state dies with it)."""
        self._harvest_replica(replica)
        self._draining.pop(replica, None)
        self._parked.add(replica)
        mcfg, mparams = self._models[replica]
        self.replicas[replica] = ServingEngine(
            mcfg, mparams, self.ccfg.engine()
        )
        self.detector.forget(self._host(replica))
        self._slowdown[replica] = 1.0
        self._done_seen[replica] = 0
        self._failed_seen[replica] = 0
        self.scale_downs += 1
        self._last_scale_tick = self.tick

    # ------------------------------------------------------------- harvest
    def _harvest_replica(self, i: int) -> None:
        eng = self.replicas[i]
        for rid in eng.completed[self._done_seen[i]:]:
            self.completed.append(rid)
            self._finish_tick[rid] = self.tick
            self._retry.pop(rid, None)
        self._done_seen[i] = len(eng.completed)
        for rid in eng.failed[self._failed_seen[i]:]:
            self.failed.append(rid)
            self._finish_tick[rid] = self.tick
            self._retry.pop(rid, None)
        self._failed_seen[i] = len(eng.failed)

    # ----------------------------------------------------------------- tick
    def step(self) -> None:
        """Advance one cluster tick: requeue due retries, route, deliver
        migrations, step active replicas (throttled ones skip ticks),
        then the straggler / drain / autoscale / checkpoint passes."""
        # crash-requeued work whose backoff expired rejoins the queue
        due = [r for t, r in self._requeue if t <= self.tick]
        self._requeue = [(t, r) for t, r in self._requeue if t > self.tick]
        self.queue.extend(due)
        self._route()
        self._deliver_migrations()
        for i in self._active_indices():  # parked replicas are off
            eng = self.replicas[i]
            # a throttled replica loses real ticks, not just face: at
            # slowdown f it advances once every ~f cluster ticks
            period = max(int(round(self._slowdown[i])), 1)
            if self.tick % period == 0:
                eng.step()
            self.detector.observe(
                self._host(i), eng.last_tick_cost * self._slowdown[i]
            )
            self._harvest_replica(i)
            # forward each replica policy's usage-rate EMAs into the
            # router: placement_score sees the SAME §III signal the
            # replica-local schedulers measured (a router never runs
            # propose, so this is its only rate feed)
            for g, r in eng.policy.group_rates().items():
                self.router.note_group_rate(g, r, float(self.tick))
            # forward declared architecture classes the same way: the
            # router's shed/placement hooks clamp structurally-flat
            # (constant-state) tenants even before any EMA warms up
            for g, c in eng.policy.group_classes().items():
                self.router.note_group_class(g, c)
        self._straggler_pass()
        self._drain_pass()
        self._scale_pass()
        self._checkpoint_pass()
        self.tick += 1

    @property
    def has_pending(self) -> bool:
        return bool(
            self.queue
            or self._inflight
            or self._precopy
            or self._requeue
            or any(eng.has_pending for eng in self.replicas)
        )

    def run(self, max_ticks: int = 2000) -> ServeReport:
        """Tick until drained or out of budget; returns the typed
        :class:`~repro_torch.serve.report.ServeReport` (the legacy dict payload
        rides in ``report.extras``).
        Cluster outcome rows carry cluster-tick latency only — TTFT/TPOT
        are engine-tick quantities and stay unset (-1/0), which the SLO
        scorer treats as unmeasured, not failed."""
        while self.tick < max_ticks and self.has_pending:
            self.step()
        lat = sorted(
            self._finish_tick[rid] - self._submit_tick[rid]
            for rid in self.completed
            if rid in self._submit_tick
        )
        tokens = self._tokens_from_dead + sum(
            len(r.generated)
            for eng in self.replicas
            for r in eng.requests.values()
        )
        legacy = {
            "policy": self.router.name,
            "n_replicas": len(self.replicas),
            "hosted_models": self.hosted_models(),
            "submitted": len(self._submit_tick),
            "completed": len(self.completed),
            "failed": len(self.failed),
            "lost": len(self.lost),
            "unroutable": len(self.unroutable),
            "misroutes": sum(eng.misroutes for eng in self.replicas),
            "in_flight_unfinished": len(self._inflight),
            "crashes": self.crashes,
            "requeued": self.requeued,
            "straggler_flags": self.straggler_flags,
            "migrations": {
                "started": self.migrations_started,
                "completed": self.migrations_completed,
                "raw_bytes": self.migration_raw_bytes,
                "wire_bytes": self.migration_wire_bytes,
            },
            "autoscale": {
                "enabled": self.ccfg.autoscale,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "peak_replicas": self.peak_replicas,
                "active_replicas": len(self._active_indices()),
                "parked": sorted(self._parked),
                "last_pressure": self.last_scale_pressure,
            },
            "delta_migration": {
                "precopies": self.precopies_started,
                "delta_cutovers": self.delta_cutovers,
                "precopy_wire_bytes": self.migration_precopy_wire_bytes,
                "delta_wire_bytes": self.migration_delta_wire_bytes,
                # what the same cutovers would have shipped monolithically
                "full_wire_bytes": self.migration_full_wire_bytes,
            },
            "checkpoint": {
                "saved": self.ckpt_saved,
                "restored_requests": self.ckpt_restored_requests,
                "restored_tokens": self.ckpt_restored_tokens,
                "replayed_tokens": self.ckpt_replayed_tokens,
                # what cold resets of the same victims would recompute
                "from_zero_tokens": self.ckpt_from_zero_tokens,
                "outcomes": dict(self.ckpt_outcomes),
            },
            "latency_ticks": lat,
            "ticks": self.tick,
            "tokens_generated": tokens,
            "tick_cost": _merge_tick_costs(
                [eng.tick_cost_stats() for eng in self.replicas]
            ),
            "memory": self.memory_stats(),
            "replicas": [
                {
                    "completed": len(eng.completed),
                    "failed": len(eng.failed),
                    "suspensions": eng.suspensions,
                    "offload_events": eng.reactive_offloads,
                    "migrations_in": eng.migrations_in,
                    "migrations_out": eng.migrations_out,
                    "peak_used_fraction": eng.peak_used_fraction,
                }
                for eng in self.replicas
            ],
        }
        # tokens each still-known request generated (crashed replicas'
        # histories are gone; their rows keep tokens=0)
        tok_by_rid: Dict[str, int] = {}
        for eng in self.replicas:
            for rid, r in eng.requests.items():
                tok_by_rid[rid] = len(r.generated)
        tenant_of: Dict[str, str] = {}
        model_of: Dict[str, str] = {}
        reason_of: Dict[str, str] = {}
        for eng in self.replicas:
            for rid, r in eng.requests.items():
                tenant_of[rid] = r.tenant
                model_of[rid] = r.model
                if r.fail_reason:
                    reason_of[rid] = r.fail_reason
        for source in (
            self.queue,
            [r for _, r in self._requeue],
            self._unrouted.values(),
        ):
            for req in source:
                tenant_of[req.request_id] = req.tenant
                model_of[req.request_id] = req.model
                if req.fail_reason:
                    reason_of[req.request_id] = req.fail_reason
        for ticket, _ in self._inflight.values():
            tenant_of[ticket.request.request_id] = ticket.request.tenant
            model_of[ticket.request.request_id] = ticket.request.model
        lost_set = set(self.lost)
        terminal: Dict[str, str] = {}
        for rid in self.completed:
            terminal[rid] = COMPLETED
        for rid in self.failed:
            # lost rids are recorded in both lists; LOST wins
            terminal[rid] = LOST if rid in lost_set else FAILED
        outcomes = []
        for rid, t0 in self._submit_tick.items():
            kind = terminal.get(rid, UNFINISHED)
            outcomes.append(
                RequestOutcome(
                    request_id=rid,
                    tenant=tenant_of.get(rid, ""),
                    outcome=kind,
                    submit_tick=t0,
                    finish_tick=self._finish_tick.get(rid, -1),
                    tokens=tok_by_rid.get(rid, 0),
                    reason=(
                        "crash retries exhausted"
                        if kind == LOST
                        else reason_of.get(rid, "")
                    ),
                    model=model_of.get(rid, ""),
                )
            )
        rep = ServeReport(
            policy=self.router.name,
            submitted=len(self._submit_tick),
            ticks=self.tick,
            tokens_generated=int(tokens),
            throughput_tokens_per_tick=tokens / max(1, self.tick),
            outcomes=outcomes,
            cluster={
                k: legacy[k]
                for k in (
                    "n_replicas",
                    "crashes",
                    "requeued",
                    "straggler_flags",
                    "migrations",
                    "autoscale",
                    "delta_migration",
                    "checkpoint",
                    "hosted_models",
                    "unroutable",
                    "replicas",
                )
            },
            memory=legacy["memory"],
            extras=legacy,
        )
        rep.refresh_summaries()
        # LOST rows count as failed in the headline (they ARE failures —
        # refresh_summaries only tallies FAILED, so fold them back in)
        rep.failed = len(self.failed)
        rep.apply_slo()
        return rep
