"""Class-stamped memory ledger: one place where bytes are born, move, die.

DESIGN.md §6 names the lifetime classes of serving memory in prose; this
module promotes them into code.  Every page, state registration, and
tier-resident block is stamped ``(tenant, page_class, tier)`` and the
:class:`MemoryLedger` is the *single writer* of byte tallies.  The five
historical ad-hoc counters — ``ServingEngine._projected_bytes`` /
``_frozen_bytes()``, allocator ``owner_share`` products,
``PrefixCache.reclaimable_bytes``, ``TieredKVStore.host_used_bytes``,
cluster demand surfaces — all become *queries* against this ledger, so
they can no longer silently disagree (the ``settle on empty`` drift
reset this file replaces was the tell).

Layering: this module imports nothing from ``repro_torch.serve`` (the
allocator, cache, tiers, and engine all import *it*), so it sits at the
bottom of the serving stack.  ``CACHE_OWNER`` lives here for the same
reason — both the allocator and the ledger need the sentinel.

Self-check: :meth:`MemoryLedger.recount` walks the attached allocator
and tier store from scratch and must equal the incremental state;
``benchmarks/gate.py`` holds that as the ``ledger_matches_recount``
hard bit and the hypothesis suite fuzzes it over random
alloc/share/COW/freeze/demote/promote/evict/free streams.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import (
    Any,
    Callable,
    Dict,
    Hashable,
    Iterable,
    List,
    Mapping,
    Optional,
    Tuple,
)

__all__ = [
    "CACHE_OWNER",
    "HBM",
    "TO_HOST",
    "HOST",
    "DISK",
    "TO_HBM",
    "PageClass",
    "LedgerView",
    "PressurePlan",
    "MemoryLedger",
]

#: reserved owner id under which the prefix cache holds pages it alone
#: references (re-exported by ``repro_torch.serve.kv_cache`` for compatibility)
CACHE_OWNER = "__prefix_cache__"

#: tier location names — mirror ``TieredKVStore`` states, plus "hbm" for
#: pages that never left the accelerator
HBM = "hbm"
TO_HOST = "to_host"
HOST = "host"
DISK = "disk"
TO_HBM = "to_hbm"


class PageClass(Enum):
    """DESIGN.md §6 lifetime classes, as first-class allocation stamps.

    The first four are the §6 rows; ``FIXED_STATE`` covers per-request
    constant state (attention sinks, encoder memory, recurrent state)
    that lives exactly as long as the request, and ``SCRATCH`` is the
    short-living class speculative decoding's draft pages will use —
    eviction prefers it over everything else by construction.
    """

    SHARED_PREFIX = "shared_prefix"
    PRIVATE_SUFFIX = "private_suffix"
    FROZEN = "frozen"
    COLD_CACHED = "cold_cached"
    FIXED_STATE = "fixed_state"
    SCRATCH = "scratch"


@dataclass
class _Owner:
    """Registration record for one byte-owning entity (request, the
    prefix cache, or a scratch region)."""

    tenant: str = ""
    kind: str = "request"  # "request" | "cache" | "scratch"
    page_bytes: float = 0.0
    state_bytes: float = 0.0
    frozen: bool = False


@dataclass
class _TierEntry:
    """One block resident somewhere in the HBM→host→disk hierarchy."""

    owner: str
    tenant: str
    cls: PageClass
    raw_bytes: float
    stored_bytes: float
    location: str


@dataclass(frozen=True)
class LedgerView:
    """Immutable snapshot of the ledger for policy decisions.

    ``SchedulingPolicy.pressure(view)`` receives one of these: per-class
    HBM byte totals, per-tier totals, per-tenant projections, and the
    replica's capacity, all read-only.
    """

    class_bytes: Mapping[PageClass, float]
    tier_bytes: Mapping[str, float]
    tenant_projected: Mapping[str, float]
    capacity_bytes: float

    def fraction(self, cls: PageClass) -> float:
        """HBM bytes of ``cls`` as a fraction of capacity (0 if no cap)."""
        if self.capacity_bytes <= 0:
            return 0.0
        return self.class_bytes.get(cls, 0.0) / self.capacity_bytes


@dataclass(frozen=True)
class PressurePlan:
    """A policy's complete answer to "memory is tight — what goes first?".

    Collapses the three historical hooks (``cache_pressure``,
    ``demotion_pressure``, ``shed_order``) onto one surface:

    - ``reclaim_order``: class order for synchronous reclaim when an
      admission or overcommit needs bytes *now*.  The stock order evicts
      ``SCRATCH`` (free by definition), then ``COLD_CACHED`` (still
      reconstructible), and only then demotes ``FROZEN`` (costs a PCIe
      round-trip to resume) — MURS evicts cold cache before touching
      frozen state *by construction*, not by call-site accident.
    - ``proactive_order``: class order for the background demotion pass
      (frozen first mirrors the paper: long-living suspended state is
      the pressure source worth moving early).
    - ``scores``: per-class group-scoring callables — the old
      ``cache_pressure(group)`` / ``demotion_pressure(group)`` pair,
      keyed by the class being reclaimed.
    - ``shed_key``: sort key for front-door shedding, given
      ``(group, stats_row)``; lower sorts first (shed first).
    """

    reclaim_order: Tuple[PageClass, ...] = (
        PageClass.SCRATCH,
        PageClass.COLD_CACHED,
        PageClass.FROZEN,
    )
    proactive_order: Tuple[PageClass, ...] = (
        PageClass.FROZEN,
        PageClass.COLD_CACHED,
    )
    scores: Mapping[PageClass, Callable[[str], float]] = field(
        default_factory=dict
    )
    shed_key: Callable[[str, Mapping[str, Any]], tuple] = (
        lambda group, row: (row.get("arrival_seq", 0.0),)
    )

    def score(self, cls: PageClass, group: str) -> float:
        """Eviction-priority score for ``group`` under class ``cls``
        (higher = evict this group's pages of that class sooner)."""
        fn = self.scores.get(cls)
        return fn(group) if fn is not None else 1.0


class MemoryLedger:
    """Single writer of byte tallies, stamped ``(tenant, class, tier)``.

    Incremental totals are kept alongside entry *counts*; when a
    bucket's count reaches zero the float is dropped entirely, so empty
    buckets are exactly ``0.0`` — no settle-on-empty resets.  The
    ground-truth :meth:`recount` walk over the attached allocator and
    tier store must always match, and :meth:`matches_recount` is a CI
    hard bit.
    """

    def __init__(self) -> None:
        """Create an empty ledger (attach collaborators afterwards)."""
        self._owners: Dict[str, _Owner] = {}
        # (tenant, PageClass, tier) -> running float total + entry count
        self._totals: Dict[Tuple[str, PageClass, str], float] = {}
        self._counts: Dict[Tuple[str, PageClass, str], int] = {}
        # owner -> HBM bytes (page fractions + fixed state), same scheme
        self._owner_hbm: Dict[str, float] = {}
        self._owner_hbm_counts: Dict[str, int] = {}
        # page id -> [(owner, PageClass, bytes), ...] one per holder slot
        self._page_entries: Dict[int, List[Tuple[str, PageClass, float]]] = {}
        # tier-resident blocks and a reverse index by owner
        self._tier: Dict[Hashable, _TierEntry] = {}
        self._tier_by_owner: Dict[str, set] = {}
        # cumulative byte flows between locations, e.g. ("host","disk")
        self._flows: Dict[Tuple[str, str], float] = {}
        # admission projections: owner -> (tenant, estimated bytes)
        self._proj: Dict[str, Tuple[str, float]] = {}
        self._proj_by_tenant: Dict[str, float] = {}
        self._proj_counts: Dict[str, int] = {}
        # per-class HBM peaks, sampled by the engine
        self._peaks: Dict[PageClass, float] = {}
        self._alloc: Any = None
        self._tiers: Any = None

    # ------------------------------------------------------------------
    # wiring

    def attach_allocator(self, alloc: Any) -> None:
        """Remember the :class:`PageBlockAllocator` for recounts and
        frozen restamps."""
        self._alloc = alloc

    def attach_tiers(self, tiers: Any) -> None:
        """Remember the :class:`TieredKVStore` for recounts."""
        self._tiers = tiers

    # ------------------------------------------------------------------
    # owners

    def register_owner(
        self,
        owner: str,
        tenant: str = "",
        kind: str = "request",
        page_bytes: float = 0.0,
        state_bytes: float = 0.0,
    ) -> None:
        """Declare an owner (request / cache / scratch) before its first
        page lands; ``state_bytes`` is stamped ``FIXED_STATE`` at HBM."""
        old = self._owners.get(owner)
        if old is not None and old.state_bytes:
            self._sub_total(old.tenant, PageClass.FIXED_STATE, HBM,
                            old.state_bytes)
            self._sub_owner(owner, old.state_bytes)
        self._owners[owner] = _Owner(
            tenant=tenant, kind=kind,
            page_bytes=float(page_bytes),
            state_bytes=float(state_bytes),
        )
        if state_bytes:
            self._add_total(tenant, PageClass.FIXED_STATE, HBM,
                            float(state_bytes))
            self._add_owner(owner, float(state_bytes))

    def release_owner(self, owner: str) -> None:
        """Retire an owner after its pages are freed and tier copies
        dropped; its fixed state leaves the ledger here."""
        rec = self._owners.pop(owner, None)
        if rec is None:
            return
        if rec.state_bytes:
            self._sub_total(rec.tenant, PageClass.FIXED_STATE, HBM,
                            rec.state_bytes)
            self._sub_owner(owner, rec.state_bytes)
        for key in list(self._tier_by_owner.get(owner, ())):
            self.tier_drop(key)

    def has_owner(self, owner: str) -> bool:
        """True while ``owner`` is registered."""
        return owner in self._owners

    def owner_tenant(self, owner: str) -> str:
        """Tenant stamped on ``owner`` ("" when unknown)."""
        rec = self._owners.get(owner)
        return rec.tenant if rec is not None else ""

    def _owner(self, owner: str) -> _Owner:
        rec = self._owners.get(owner)
        if rec is None:
            kind = "cache" if owner == CACHE_OWNER else "request"
            rec = _Owner(kind=kind)
            self._owners[owner] = rec
        return rec

    def set_frozen(self, owner: str, frozen: bool) -> None:
        """Mark ``owner`` suspended (or resumed): its sole-held HBM
        pages and tier-resident blocks restamp between
        ``PRIVATE_SUFFIX`` and ``FROZEN``."""
        rec = self._owner(owner)
        if rec.frozen == frozen:
            return
        rec.frozen = frozen
        if self._alloc is not None:
            table = self._alloc._tables.get(owner)
            if table:
                for pid in set(p for p in table if p >= 0):
                    holders = self._alloc._holders.get(pid, ())
                    self.page_update(pid, holders)
        for key in list(self._tier_by_owner.get(owner, ())):
            entry = self._tier[key]
            if entry.cls in (PageClass.PRIVATE_SUFFIX, PageClass.FROZEN):
                new_cls = PageClass.FROZEN if frozen else PageClass.PRIVATE_SUFFIX
                if new_cls is not entry.cls:
                    self._sub_total(entry.tenant, entry.cls,
                                    entry.location, entry.stored_bytes)
                    entry.cls = new_cls
                    self._add_total(entry.tenant, entry.cls,
                                    entry.location, entry.stored_bytes)

    def is_frozen(self, owner: str) -> bool:
        """True while ``owner`` is stamped suspended."""
        rec = self._owners.get(owner)
        return bool(rec is not None and rec.frozen)

    # ------------------------------------------------------------------
    # bucket arithmetic (exact settle: drop the float when count hits 0)

    def _add_total(self, tenant: str, cls: PageClass, tier: str,
                   b: float) -> None:
        key = (tenant, cls, tier)
        self._totals[key] = self._totals.get(key, 0.0) + b
        self._counts[key] = self._counts.get(key, 0) + 1

    def _sub_total(self, tenant: str, cls: PageClass, tier: str,
                   b: float) -> None:
        key = (tenant, cls, tier)
        n = self._counts.get(key, 0) - 1
        if n <= 0:
            self._counts.pop(key, None)
            self._totals.pop(key, None)
        else:
            self._counts[key] = n
            self._totals[key] = self._totals.get(key, 0.0) - b

    def _add_owner(self, owner: str, b: float) -> None:
        self._owner_hbm[owner] = self._owner_hbm.get(owner, 0.0) + b
        self._owner_hbm_counts[owner] = (
            self._owner_hbm_counts.get(owner, 0) + 1
        )

    def _sub_owner(self, owner: str, b: float) -> None:
        n = self._owner_hbm_counts.get(owner, 0) - 1
        if n <= 0:
            self._owner_hbm_counts.pop(owner, None)
            self._owner_hbm.pop(owner, None)
        else:
            self._owner_hbm_counts[owner] = n
            self._owner_hbm[owner] = self._owner_hbm.get(owner, 0.0) - b

    # ------------------------------------------------------------------
    # page accounting (driven by the allocator)

    def _class_of(self, owner: str, ref: int) -> PageClass:
        if ref > 1:
            return PageClass.SHARED_PREFIX
        rec = self._owner(owner)
        if rec.kind == "cache":
            return PageClass.COLD_CACHED
        if rec.kind == "scratch":
            return PageClass.SCRATCH
        if rec.frozen:
            return PageClass.FROZEN
        return PageClass.PRIVATE_SUFFIX

    def page_update(self, pid: int, holders: Iterable[str]) -> None:
        """Re-stamp page ``pid`` after any allocator mutation.

        ``holders`` is the allocator's current holder list for the page
        (one entry per table slot referencing it, so multiplicity is
        preserved); empty means the page was freed.  Fractional
        shared-page attribution lives here: each holder is charged
        ``page_bytes / ref``, reproducing the old ``owner_share``
        arithmetic exactly.
        """
        for owner, cls, b in self._page_entries.pop(pid, ()):
            tenant = self._owner(owner).tenant
            self._sub_total(tenant, cls, HBM, b)
            self._sub_owner(owner, b)
        holders = list(holders)
        if not holders:
            return
        ref = len(holders)
        entries: List[Tuple[str, PageClass, float]] = []
        for owner in holders:
            rec = self._owner(owner)
            cls = self._class_of(owner, ref)
            b = rec.page_bytes / ref
            entries.append((owner, cls, b))
            self._add_total(rec.tenant, cls, HBM, b)
            self._add_owner(owner, b)
        self._page_entries[pid] = entries

    def page_class(self, pid: int) -> Optional[PageClass]:
        """Class currently stamped on page ``pid`` (None if untracked).

        A page has exactly one class: shared pages are
        ``SHARED_PREFIX`` for every holder, sole pages take the
        holder's class.
        """
        entries = self._page_entries.get(pid)
        if not entries:
            return None
        return entries[0][1]

    def pages_of_class(self, owner: str, cls: PageClass) -> List[int]:
        """Page ids held by ``owner`` whose current stamp is ``cls``."""
        out = []
        for pid, entries in self._page_entries.items():
            for holder, c, _b in entries:
                if holder == owner and c is cls:
                    out.append(pid)
                    break
        return out

    # ------------------------------------------------------------------
    # tier accounting (driven by TieredKVStore)

    def _tier_owner(self, key: Hashable) -> str:
        if isinstance(key, tuple) and len(key) >= 2:
            if key[0] == "req":
                return str(key[1])
            if key[0] == "cache":
                return CACHE_OWNER
        return str(key)

    def tier_demote(self, key: Hashable, raw_bytes: float,
                    stored_bytes: float) -> None:
        """A block left HBM for the hierarchy: stamp it with its owner's
        class at demote time and account it at ``TO_HOST``."""
        if key in self._tier:
            self.tier_drop(key)
        owner = self._tier_owner(key)
        rec = self._owner(owner)
        if rec.kind == "cache":
            cls = PageClass.COLD_CACHED
        elif rec.kind == "scratch":
            cls = PageClass.SCRATCH
        elif rec.frozen:
            cls = PageClass.FROZEN
        else:
            cls = PageClass.PRIVATE_SUFFIX
        entry = _TierEntry(
            owner=owner, tenant=rec.tenant, cls=cls,
            raw_bytes=float(raw_bytes), stored_bytes=float(stored_bytes),
            location=TO_HOST,
        )
        self._tier[key] = entry
        self._tier_by_owner.setdefault(owner, set()).add(key)
        self._add_total(entry.tenant, cls, TO_HOST, entry.stored_bytes)

    def tier_move(self, key: Hashable, location: str) -> None:
        """Move a tracked block between locations, recording the flow
        (``flow("host", "disk")`` *is* the disk-spill metric)."""
        entry = self._tier.get(key)
        if entry is None or entry.location == location:
            return
        self._sub_total(entry.tenant, entry.cls, entry.location,
                        entry.stored_bytes)
        fkey = (entry.location, location)
        self._flows[fkey] = self._flows.get(fkey, 0.0) + entry.stored_bytes
        entry.location = location
        self._add_total(entry.tenant, entry.cls, location,
                        entry.stored_bytes)

    def tier_drop(self, key: Hashable) -> None:
        """A block left the hierarchy (promoted home, discarded, or
        extracted)."""
        entry = self._tier.pop(key, None)
        if entry is None:
            return
        self._sub_total(entry.tenant, entry.cls, entry.location,
                        entry.stored_bytes)
        keys = self._tier_by_owner.get(entry.owner)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._tier_by_owner[entry.owner]

    def flow(self, src: str, dst: str) -> float:
        """Cumulative bytes that moved ``src`` → ``dst``."""
        return self._flows.get((src, dst), 0.0)

    # ------------------------------------------------------------------
    # projections (admission estimates, satellite-1 drift fix)

    def note_projection(self, owner: str, tenant: str, est: float) -> None:
        """Record an admission-time demand estimate for ``owner``."""
        if owner in self._proj:
            self.drop_projection(owner)
        self._proj[owner] = (tenant, float(est))
        self._proj_by_tenant[tenant] = (
            self._proj_by_tenant.get(tenant, 0.0) + float(est)
        )
        self._proj_counts[tenant] = self._proj_counts.get(tenant, 0) + 1

    def drop_projection(self, owner: str) -> None:
        """Retire ``owner``'s demand estimate; the per-tenant float is
        dropped entirely when its last estimate leaves (exact settle —
        this replaces the old settle-on-empty reset)."""
        rec = self._proj.pop(owner, None)
        if rec is None:
            return
        tenant, est = rec
        n = self._proj_counts.get(tenant, 0) - 1
        if n <= 0:
            self._proj_counts.pop(tenant, None)
            self._proj_by_tenant.pop(tenant, None)
        else:
            self._proj_counts[tenant] = n
            self._proj_by_tenant[tenant] = (
                self._proj_by_tenant.get(tenant, 0.0) - est
            )

    def projected_bytes(self) -> float:
        """Total live demand estimate across tenants."""
        return sum(self._proj_by_tenant.values())

    def projected_by_tenant(self) -> Dict[str, float]:
        """Copy of the per-tenant demand estimates."""
        return dict(self._proj_by_tenant)

    def projected_tenants(self) -> List[str]:
        """Tenants with at least one live projection."""
        return list(self._proj_by_tenant.keys())

    def projected_recount(self) -> float:
        """Ground-truth projection total (``math.fsum`` over entries) —
        the regression oracle for incremental projection bookkeeping."""
        return math.fsum(est for _t, est in self._proj.values())

    # ------------------------------------------------------------------
    # queries

    def owner_bytes(self, owner: str) -> float:
        """HBM bytes attributed to ``owner`` (page fractions + fixed
        state) — the old ``owner_share × page_bytes + state_bytes``."""
        return self._owner_hbm.get(owner, 0.0)

    def class_bytes(self, cls: PageClass, tier: str = HBM) -> float:
        """Bytes of ``cls`` resident at ``tier``."""
        return sum(
            v for (t, c, loc), v in self._totals.items()
            if c is cls and loc == tier
        )

    def tier_bytes(self, tier: str) -> float:
        """Bytes resident at ``tier`` across all classes."""
        return sum(
            v for (_t, _c, loc), v in self._totals.items() if loc == tier
        )

    def hbm_bytes(self) -> float:
        """Total HBM-resident bytes (all classes)."""
        return self.tier_bytes(HBM)

    def tenant_class_bytes(self, tenant: str, cls: PageClass,
                           tier: str = HBM) -> float:
        """Bytes of ``cls`` at ``tier`` attributed to ``tenant``."""
        return self._totals.get((tenant, cls, tier), 0.0)

    def class_breakdown(self, tier: str = HBM) -> Dict[PageClass, float]:
        """Per-class byte totals at ``tier``."""
        out: Dict[PageClass, float] = {}
        for (_t, cls, loc), v in self._totals.items():
            if loc == tier:
                out[cls] = out.get(cls, 0.0) + v
        return out

    def tier_breakdown(self) -> Dict[str, float]:
        """Per-location byte totals across all classes."""
        out: Dict[str, float] = {}
        for (_t, _c, loc), v in self._totals.items():
            out[loc] = out.get(loc, 0.0) + v
        return out

    def sample_peaks(self) -> None:
        """Record the running per-class HBM high-water marks."""
        for cls, v in self.class_breakdown(HBM).items():
            if v > self._peaks.get(cls, 0.0):
                self._peaks[cls] = v

    def peak_class_bytes(self) -> Dict[PageClass, float]:
        """Per-class HBM peaks seen since construction."""
        return dict(self._peaks)

    def view(self, capacity_bytes: float = 0.0) -> LedgerView:
        """Snapshot for policy consumption."""
        return LedgerView(
            class_bytes=self.class_breakdown(HBM),
            tier_bytes=self.tier_breakdown(),
            tenant_projected=self.projected_by_tenant(),
            capacity_bytes=float(capacity_bytes),
        )

    # ------------------------------------------------------------------
    # ground truth

    def recount(self) -> Dict[Tuple[str, PageClass, str], float]:
        """Recompute every ``(tenant, class, tier)`` total from scratch
        by walking the attached allocator and tier store.

        This is the ground truth the incremental state must equal; the
        gate's ``ledger_matches_recount`` bit and the hypothesis suite
        both assert it.
        """
        totals: Dict[Tuple[str, PageClass, str], List[float]] = {}

        def put(tenant: str, cls: PageClass, tier: str, b: float) -> None:
            totals.setdefault((tenant, cls, tier), []).append(b)

        if self._alloc is not None:
            for pid, holders in self._alloc._holders.items():
                if not holders:
                    continue
                ref = len(holders)
                for owner in holders:
                    rec = self._owner(owner)
                    put(rec.tenant, self._class_of(owner, ref), HBM,
                        rec.page_bytes / ref)
        for owner, rec in self._owners.items():
            if rec.state_bytes:
                put(rec.tenant, PageClass.FIXED_STATE, HBM,
                    rec.state_bytes)
        for entry in self._tier.values():
            put(entry.tenant, entry.cls, entry.location,
                entry.stored_bytes)
        return {k: math.fsum(v) for k, v in totals.items()}

    def matches_recount(self) -> bool:
        """True when the incremental totals equal :meth:`recount` within
        float tolerance — the gate hard bit."""
        truth = self.recount()
        for key in set(truth) | set(self._totals):
            a = self._totals.get(key, 0.0)
            b = truth.get(key, 0.0)
            if not math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-6):
                return False
        return True

    def stats(self) -> Dict[str, Any]:
        """Serializable summary: per-class and per-tier bytes, peaks,
        projections, and the self-check bit (the bench ``memory`` key)."""
        by_class = {
            cls.value: self.class_bytes(cls, HBM) for cls in PageClass
        }
        peaks = self.peak_class_bytes()
        return {
            "by_class": by_class,
            "peak_by_class": {
                cls.value: peaks.get(cls, 0.0) for cls in PageClass
            },
            "by_tier": self.tier_breakdown(),
            "hbm_bytes": self.hbm_bytes(),
            "projected_bytes": self.projected_bytes(),
            "disk_spill_bytes": self.flow(HOST, DISK),
            "ledger_matches_recount": self.matches_recount(),
        }
