"""Multi-tenant continuous-batching serving engine on the policy layer.

The paper's scheduler in a PyTorch serving runtime: multiple tenants
submit requests into one engine (one model, one HBM pool — the "service
mode" of MURS §II).  Each request is a task of the pluggable
:class:`repro_torch.sched.SchedulingPolicy`:

    processed  = tokens consumed so far (prompt + generated)
    live bytes = its KV/state footprint from the PagedKVManager
    rate       = Δlive/Δtokens — measured online by the MURS Sampler, which
                 classifies full-attention decodes as linear, MLA as shallow-
                 linear, sliding-window/mamba as constant (paper §III models)

Every ``period`` ticks the policy runs against the pool: requests proposed
for suspension stop being scheduled (their KV pages stay resident — exactly
Spark's suspended tasks); one suspended request resumes per completion
(FIFO, starvation-free under MURS) and all resume when pressure drops below
yellow.  :class:`FairPolicy` is the stock baseline: no pressure response,
so the engine's reactive path (page-granular demotion of running work, or
hard failure when demotion is disabled) fires when the pool overcommits.
Admission is uniform — every policy queues at the door; what differs is
the admission line (``admission_headroom``) and how fast headroom appears
(a suspending policy demotes frozen KV to the host tier, a
pressure-oblivious one waits for completions or pays the reactive path).

TIERED KV (:mod:`repro_torch.serve.tiers`): below the HBM page pool sit a host
tier with REAL capacity and int8-compressed page storage
(``repro_torch.dist.compression.quantize``/``dequantize`` — the page's actual KV
values round-trip through the codes), and a disk tier whose traffic is the
paper's "data spilling" metric.  Demotion and promotion are page-granular
and ASYNCHRONOUS over a modeled PCIe link (latency ∝ compressed bytes, so
compression directly buys ticks): suspended-frozen pages and cold cached
prefixes demote individually while decode continues on resident pages — a
request stalls only when it is actually scheduled against a non-resident
page.  ``SchedulingPolicy.demotion_pressure(group)`` (sibling of
``cache_pressure``) lets :class:`MursPolicy` demote low-usage-rate
tenants' frozen KV *proactively*, before the reactive spill path fires —
the mechanism behind the paper's ~90% spill reduction.

The hot loop is CONTINUOUS BATCHING with CHUNKED PREFILL: prompts are
consumed in token-budgeted chunks (``prefill_chunk_tokens`` per tick)
interleaved with decode ticks, so one long prompt never stalls every
in-flight decode the way a monolithic prefill call does.  Decode runs
batched: one step through the paged-decode CUDA kernel advances every
active slot per tick with per-slot positions; prefill continuation runs
the same cache layout through a single-slot decode step.  KV lives in the
paged pool of :class:`PagedKVManager` — free-list block allocator,
per-request page tables, the same tables the ``paged_decode`` kernel
consumes.

PREFIX SHARING: admission matches each prompt against the pool's token
trie (:class:`repro_torch.serve.kv_cache.PrefixCache`).  Matched pages are
acquired by reference (refcount + 1, zero new bytes) and their KV is
installed from a snapshot taken when the prefix was first prefetched —
prefill compute is SKIPPED for cached tokens; chunked prefill starts at
the first uncached token.  Any later append into a shared page goes
through copy-on-write, so a shared page is never mutated.  Cold cached
prefixes evict under pressure in LRU order crossed with the policy's
``cache_pressure`` hint (MURS: low-usage-rate tenants first).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.memory_manager import MemoryPool
from repro_torch.core.sampler import Sampler
from repro_torch.sched import FairPolicy, MursConfig, MursPolicy, SchedulingPolicy
from repro_torch.models import (
    decode_step,
    decode_step_paged,
    init_cache,
    paged_decode_supported,
    prefill,
    resolve_device,
)
from repro_torch.roofline.analysis import tick_cost_model
from repro_torch.serve.kv_cache import (
    CACHE_OWNER,
    DEMOTED,
    PagedKVManager,
)
from repro_torch.serve.ledger import PageClass, PressurePlan
from repro_torch.serve.report import (
    COMPLETED,
    FAILED,
    UNFINISHED,
    RequestOutcome,
    ServeReport,
)
from repro_torch.serve.tiers import TierConfig, wire_bytes_for


def _leaves(tree: Any) -> List[torch.Tensor]:
    """Tensor leaves in ``jax.tree_util.tree_leaves`` order: dict keys
    sorted (``b10`` before ``b2``), lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


@dataclass
class Request:
    """One serving request: a prompt, a decode budget, and the engine's
    working state (slot, materialized position, generated tokens).

    The engine mutates the instance in place as it moves through the
    lifecycle — submit fresh objects per run."""

    request_id: str
    tenant: str
    prompt: List[int]
    max_new_tokens: int
    submit_tick: int = 0
    slot: int = -1
    pos: int = 0  # tokens materialized in the cache so far
    generated: List[int] = field(default_factory=list)
    # queued|prefill|decoding|suspended|offloaded|importing|done|failed
    state: str = "queued"
    finish_tick: int = -1
    #: MURS §III classification of this request's memory behaviour, as
    #: measured online by the sampler (constant/sub_linear/linear/super_linear)
    memory_model: str = "constant"
    offloads: int = 0  # times this request was a reactive-demotion victim
    #: prompt tokens covered by a prefix-cache match (0 = cold)
    cached_tokens: int = 0
    #: KV-snapshot key of the matched prefix (the caching prompt's tokens)
    snap_key: Optional[Tuple[int, ...]] = None
    first_token_tick: int = -1  # tick the first generated token appeared
    #: engine hit counters already incremented for this request — a
    #: suspend/resume replay re-installs the snapshot but must not
    #: re-count the dedup'd prefill work
    hit_counted: bool = False
    #: why the request failed ("" while not failed) — surfaced in the
    #: ServeReport outcome row
    fail_reason: str = ""
    #: arch name this request targets ("" → whatever model the engine
    #: that first sees it serves).  In a heterogeneous fleet the cluster
    #: router only places the request on replicas hosting this model;
    #: an engine handed a request for a model it does not serve fails it
    #: with a typed ``wrong_model`` outcome instead of silently decoding
    #: through the wrong weights
    model: str = ""

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def feed_tokens(self) -> List[int]:
        """Every token whose KV must be materialized before the next decode
        step: the prompt plus all generated tokens but the last (which is
        fed BY the next decode step).  This is also the replay sequence
        that rebuilds a slot cache after suspension moved the request out
        of its batch row."""
        if self.generated:
            return self.prompt + self.generated[:-1]
        return self.prompt

    @property
    def prefilling(self) -> bool:
        return self.pos < len(self.feed_tokens)


@dataclass
class MigrationTicket:
    """A request's portable state, as extracted by
    :meth:`ServingEngine.export_request` — everything another replica
    needs to continue it:

    * ``request`` — the :class:`Request` itself (tokens generated so far,
      position, tenant);
    * ``slot_cache`` — the full slot cache subtree
      (:meth:`ServingEngine._extract_slot`) when the request still held a
      batch row: bit-exact, so the target continues with identical
      numerics;
    * ``page_payloads`` — per-page KV values (frozen-payload captures and
      dequantized tier blocks) for slotless requests; complete coverage
      lets the target install pages instead of replaying prefill;
    * ``raw_bytes`` / ``wire_bytes`` — the migration's traffic accounting
      (wire = compressed bytes that cross the inter-replica link);
    * ``full_wire_bytes`` / ``precopy_wire_bytes`` / ``delta_pages`` —
      filled only by a DELTA cutover (``export_request`` with a
      ``baseline`` pre-copy): what a monolithic full copy would have
      shipped at cutover, what the pre-copy already shipped while the
      source kept serving, and how many dirty pages the delta re-sent
      (DESIGN.md §11).
    """

    request: Request
    slot_cache: Optional[Dict[str, Any]] = None
    page_payloads: Dict[int, np.ndarray] = field(default_factory=dict)
    raw_bytes: float = 0.0
    wire_bytes: float = 0.0
    source_tick: int = 0
    full_wire_bytes: float = 0.0
    precopy_wire_bytes: float = 0.0
    delta_pages: int = 0


@dataclass
class PrecopySnapshot:
    """Phase one of an incremental (delta) migration: a copy of the
    request's resident page payloads taken at ``epoch`` WHILE THE SOURCE
    KEEPS SERVING the request.  The cluster ships these bytes in the
    background; at cutover :meth:`ServingEngine.export_request` receives
    the snapshot as its ``baseline`` and re-ships only the pages the
    write-epoch ledger (:meth:`PagedKVManager.pages_written_since`) says
    changed after ``epoch`` — the dirty delta (DESIGN.md §11)."""

    request_id: str
    epoch: int
    payloads: Dict[int, np.ndarray] = field(default_factory=dict)
    raw_bytes: float = 0.0
    wire_bytes: float = 0.0


class _AdmissionQueue:
    """The engine's admission queue, indexed for O(1) membership and
    O(tenants) per-tick policy input instead of an O(queue) rebuild.

    Semantics match the plain list it replaced exactly: iteration yields
    requests in arrival order, and :meth:`tenant_counts` presents tenants
    in the order of their OLDEST queued request — the same key order the
    legacy ``by_tenant`` dict had, which :meth:`BasePolicy.assign`'s
    persistent round-robin cursor is sensitive to.  Per-request sequence
    numbers (monotonic, never reused) make that ordering survive
    mid-queue removals, where a naive per-tenant dict would not.
    """

    def __init__(self) -> None:
        self._order: Dict[str, Request] = {}  # rid → request, arrival order
        self._seq: Dict[str, int] = {}  # rid → global arrival sequence
        self._by_tenant: Dict[str, Dict[str, Request]] = {}
        self._next_seq = 0

    def append(self, req: Request) -> None:
        rid = req.request_id
        self._order[rid] = req
        self._seq[rid] = self._next_seq
        self._next_seq += 1
        self._by_tenant.setdefault(req.tenant, {})[rid] = req

    def remove(self, req: Request) -> None:
        rid = req.request_id
        del self._order[rid]
        del self._seq[rid]
        bucket = self._by_tenant[req.tenant]
        del bucket[rid]
        if not bucket:
            del self._by_tenant[req.tenant]

    def head(self, tenant: str) -> Optional[Request]:
        bucket = self._by_tenant.get(tenant)
        if not bucket:
            return None
        return next(iter(bucket.values()))

    def tenant_counts(self, exclude: Any = ()) -> Dict[str, int]:
        """``{tenant: queued}`` keyed in oldest-head-request order."""
        rows = []
        for tenant, bucket in self._by_tenant.items():
            if tenant in exclude:
                continue
            rows.append((self._seq[next(iter(bucket))], tenant, len(bucket)))
        rows.sort()
        return {tenant: n for _, tenant, n in rows}

    def __contains__(self, req: Request) -> bool:
        return req.request_id in self._order

    def __iter__(self):
        return iter(self._order.values())

    def __len__(self) -> int:
        return len(self._order)

    def __bool__(self) -> bool:
        return bool(self._order)


@dataclass
class EngineConfig:
    """Engine knobs: pool size, policy, tiering, kernels (see
    docs/OPERATIONS.md for the tuning guide)."""

    n_slots: int = 4
    max_seq: int = 128
    hbm_capacity_bytes: float = 1e6  # KV pool budget (simulated pressure)
    #: scheduling policy instance; None → resolved from ``scheduler``
    policy: Optional[SchedulingPolicy] = None
    #: legacy spelling: a MursConfig → MursPolicy, None → FairPolicy
    scheduler: Optional[MursConfig] = None
    #: engine ticks per unit of the policy's ``period`` — the seasonal
    #: pass runs every ``round(policy.period * murs_period_ticks)`` ticks
    murs_period_ticks: int = 1
    greedy: bool = True
    #: prefill token budget per engine tick — prompts longer than this are
    #: split into chunks interleaved with decode ticks (continuous batching)
    prefill_chunk_tokens: int = 64
    #: demote running work to the tier hierarchy instead of hard failure
    #: when the pool overcommits (False → OOM semantics, the paper's OME)
    offload_enabled: bool = True
    #: host-tier capacity for demoted pages (bytes AT REST, compressed);
    #: None → 4× the HBM pool
    host_capacity_bytes: Optional[float] = None
    #: HBM↔host link rate in bytes/tick; None → hbm_capacity/8 (a 1/8-pool
    #: transfer per tick) — compression halves the bytes that cross it
    pcie_bytes_per_tick: Optional[float] = None
    #: disk→host read rate; None → a quarter of the PCIe rate
    disk_bytes_per_tick: Optional[float] = None
    #: int8-compress demoted pages in the host tier
    tier_compress: bool = True
    #: pool fraction above which the engine PROACTIVELY demotes (frozen
    #: KV of tenants the policy's ``demotion_pressure`` marks, then cold
    #: cached pages) — the "before the reactive path" knob.  The default
    #: sits just ABOVE MursPolicy's red line (0.8): out of the box only
    #: excursions past it trigger demotion, so resumes rarely wait on
    #: promotion DMAs; deployments that want eager tiering (the
    #: benchmark's proactive leg) lower it to the policy's band
    demote_threshold: float = 0.85
    #: max page demotions initiated per proactive pass (bounds churn)
    demote_batch_pages: int = 4
    #: the reactive path frees DOWN TO this pool fraction, not merely out
    #: of overcommit: stopping at exactly-full leaves zero free pages, so
    #: promotions (and therefore every stalled victim) starve — the
    #: classic all-slots-stalled wedge.  Only applies when demotion is
    #: enabled; the hard-failure path still fires on true overcommit.
    reactive_watermark: float = 0.9
    #: prefix-sharing paged KV cache: admission matches prompts against the
    #: token trie, cached pages are shared by refcount (COW on append) and
    #: prefill is skipped up to the first uncached token
    prefix_cache: bool = True
    #: use the pre-vectorization O(live)-per-tick bookkeeping scans
    #: (full pool rescan, projected-demand resummation, state sweeps)
    #: instead of the incremental dirty-set/counter paths.  Semantics are
    #: identical by construction; the flag exists so the benchmark can
    #: measure the ticks/sec delta honestly
    legacy_bookkeeping: bool = False
    #: decode through the paged CUDA kernel when the architecture
    #: qualifies (pure full-attention stacks — see
    #: ``models.paged_decode_supported``): all active rows batch their
    #: live page tables into ONE ``paged_decode_attention`` call per
    #: layer.  False keeps the dense per-slot decode as a differential
    #: oracle (same spirit as ``legacy_bookkeeping``): identical greedy
    #: tokens by construction, so tests can diff the two paths
    paged_decode: bool = True
    #: quantize the paged KV pools to int8 (per pool-row absmax scales)
    #: and decode through ``paged_decode_attention_int8``.  Off by
    #: default: the ``paged_decode_attention`` path stays the
    #: differential oracle (tests diff the two).  Only takes effect when
    #: ``paged_decode`` is active for the architecture.
    paged_decode_int8: bool = False
    #: where the caches live and every step runs; "cuda" raises where
    #: there is no card (no fallback).  The device also decides which
    #: paged-decode path runs: the CUDA kernel on "cuda", its plain
    #: PyTorch version on "cpu"
    device: str = "cuda"
    #: host-side KV snapshots backing prefill-skip, LRU-bounded so a
    #: long-lived engine serving many distinct prompts cannot grow host
    #: memory without bound (each snapshot is one slot's full cache
    #: subtree).  Beyond the bound, matches on snapshot-less trie nodes
    #: still dedup pages — they just recompute the prefill (COW-guarded).
    max_prefix_snapshots: int = 64

    def resolve_policy(self) -> SchedulingPolicy:
        """The configured policy instance: ``policy`` wins, a legacy
        ``scheduler`` config wraps into MursPolicy, else FairPolicy."""
        if self.policy is not None and self.scheduler is not None:
            raise ValueError("pass either policy= or scheduler=, not both")
        if self.policy is not None:
            return self.policy
        if self.scheduler is not None:
            return MursPolicy(self.scheduler)
        return FairPolicy()


class ServingEngine:
    """One replica: continuous-batching paged serving over a single
    simulated HBM pool (DESIGN.md §2), scheduled through a pluggable
    :class:`~repro_torch.sched.protocol.SchedulingPolicy`."""

    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig) -> None:
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        #: the model this replica hosts, as an explicit spec (arch id +
        #: memory class + byte model) — every byte-accounting and
        #: migration gate below keys off this, not an implicit global
        self.spec = cfg.spec()
        self.pool = MemoryPool(capacity=ecfg.hbm_capacity_bytes)
        pcie = (
            ecfg.pcie_bytes_per_tick
            if ecfg.pcie_bytes_per_tick is not None
            else max(ecfg.hbm_capacity_bytes / 8.0, 1.0)
        )
        self.kv = PagedKVManager(
            capacity_bytes=ecfg.hbm_capacity_bytes,
            enable_prefix_cache=ecfg.prefix_cache,
            tier_config=TierConfig(
                host_capacity_bytes=(
                    ecfg.host_capacity_bytes
                    if ecfg.host_capacity_bytes is not None
                    else 4.0 * ecfg.hbm_capacity_bytes
                ),
                pcie_bytes_per_tick=pcie,
                disk_bytes_per_tick=(
                    ecfg.disk_bytes_per_tick
                    if ecfg.disk_bytes_per_tick is not None
                    else max(pcie / 4.0, 1.0)
                ),
                compress=ecfg.tier_compress,
            ),
        )
        self.policy: SchedulingPolicy = ecfg.resolve_policy()
        # eviction order consults the active policy's pressure plan:
        # LRU × the plan's COLD_CACHED score (the scores close over the
        # policy's live rate state, so binding the plan once is safe)
        _wiring_plan = self.policy.pressure()
        self.kv.cache_pressure_fn = lambda g: _wiring_plan.score(
            PageClass.COLD_CACHED, g
        )
        self.sampler = Sampler()
        self.tick = 0
        self.queue = _AdmissionQueue()
        self._restore: List[str] = []  # resumed/reloaded, waiting for a slot
        self.requests: Dict[str, Request] = {}  # full history (lookup/report)
        #: not-yet-terminal requests — every per-tick scan walks this, so
        #: tick cost is bounded by the in-flight set, not request history
        self._live: Dict[str, Request] = {}
        # ---- incremental bookkeeping (kept in BOTH modes; the
        # legacy_bookkeeping flag only selects which representation the
        # read paths consult)
        #: state → live request ids in that state (terminal states are
        #: dropped with the request) — O(1) counts for has_pending,
        #: replica_stats and the per-tick active-slot cost
        self._state_ids: Dict[str, set] = {}
        # (projected-demand bookkeeping lives in the KV manager's
        # MemoryLedger — note_projection/drop_projection in _track_live /
        # _drop_live; the front door's group_demand reads it there)
        #: rids whose state changed since the last pool sync — merged
        #: with the KV manager's allocator dirty set in _update_pool
        self._pool_dirty: set = set()
        self._submitted = 0  # every submission this engine ever accepted
        self.failed: List[str] = []
        self.completed: List[str] = []
        self.suspensions = 0
        self.peak_used_fraction = 0.0
        #: like peak_used_fraction but net of RECLAIMABLE bytes (cold
        #: cached prefixes are one evict_cache() from free — the page-cache
        #: notion of available memory); this is the dedup'd live demand
        self.peak_demand_fraction = 0.0
        self.chunked_prefill_ticks = 0
        self.reactive_offloads = 0  # reactive-demotion victims (stock path)
        self.swap_outs = 0  # frozen (suspended) pages demoted to the tiers
        self.proactive_demotions = 0  # pages demoted by the policy hint
        self.stall_ticks = 0  # request-ticks lost to non-resident KV
        self.transfer_stall_ticks = 0  # … of which waiting on tier DMA
        #: per-page KV payloads captured when a request froze (slot still
        #: attached) — handed to the host tier when its pages demote, so
        #: the int8 round-trip compresses REAL values, not placeholders
        self._frozen_payloads: Dict[str, Dict[int, np.ndarray]] = {}
        self.prefix_hits = 0  # requests that skipped prefill via the trie
        self.prefix_hit_tokens = 0  # prompt tokens whose prefill was skipped
        #: migrated-in requests waiting for a batch row to land in
        #: (rid → ticket); their KV installs from the ticket, not replay
        self._imports: Dict[str, MigrationTicket] = {}
        self.migrations_in = 0
        self.migrations_out = 0
        #: requests submitted here that declared a DIFFERENT model — each
        #: is failed with a typed ``wrong_model`` outcome (the router
        #: should never let this happen; the counter is the evidence)
        self.misroutes = 0
        #: modeled cost of the last step() in SECONDS — the replica's tick
        #: service time a cluster's straggler pass observes.  Derived from
        #: the roofline (weight stream + KV pages touched over HBM
        #: bandwidth vs FLOPs over peak, plus PCIe stall DMAs), not
        #: hand-set constants; deterministic, no wall clock.
        self._tick_cost_model = tick_cost_model(
            cfg, page_tokens=self.kv.page_tokens
        )
        self.last_tick_cost = self._tick_cost_model.idle_s
        self._tick_cost_count = 0
        self._tick_cost_sum = 0.0
        self._tick_cost_min = float("inf")
        self._tick_cost_max = 0.0
        self._tick_cost_values: set = set()  # bounded distinct sample
        self._tick_prefill_tokens = 0
        self._tick_decode_tokens = 0
        #: KV snapshots backing cached prefixes: snap_key (the caching
        #: prompt's token tuple) → (slot cache subtree, first greedy token,
        #: snapshot length).  Pruned when the trie evicts the last node
        #: referencing a snapshot.
        self._snaps: Dict[Tuple[int, ...], Tuple[Any, int, int]] = {}
        self._pruned_at_evictions = 0

        # slot-batched decode state: device tensors in the JAX package's
        # cache layout — "unit" leaves [reps, n_slots, ...], "suffix"
        # leaves [n_slots, ...].  The execution methods below write them
        # IN PLACE (the JAX engine donates and replaces them), so one copy
        # of the caches lives on the device, never two.
        self.device = resolve_device(ecfg.device)
        if params["embed"]["tokens"].device != self.device:
            raise ValueError(
                f"params live on {params['embed']['tokens'].device}, the "
                f"engine runs on {self.device}"
            )
        self._caches = init_cache(
            cfg, ecfg.n_slots, ecfg.max_seq, device=self.device
        )
        self._slot_req: List[Optional[str]] = [None] * ecfg.n_slots

        # ---- paged-kernel decode: the serving hot path.  Eligible stacks
        # batch every active row's live page table into one
        # paged_decode_attention call per layer (decode_step_paged); the
        # dense per-slot path stays as the differential oracle
        self._paged_ok = ecfg.paged_decode and paged_decode_supported(cfg)
        #: int8-quantized kernel path: only meaningful when the paged
        #: kernel serves decode at all
        self._paged_int8 = ecfg.paged_decode_int8 and self._paged_ok
        self.paged_decode_ticks = 0  # decode ticks served by the kernel
        self.paged_int8_ticks = 0  # … of which through the int8 kernel

    # ------------------------------------------------------------ execution
    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Stage int32 host arrays in ONE host→device copy; returns a
        device view of each, in order."""
        flat = np.concatenate(
            [np.asarray(a, np.int32).reshape(-1) for a in arrays]
        )
        staged = torch.from_numpy(flat).to(self.device)
        out, off = [], 0
        for a in arrays:
            n = int(np.prod(a.shape))
            out.append(staged[off:off + n].view(a.shape))
            off += n
        return out

    def _chunk_scan(self, tokens: List[int], slot: int, pos0: int):
        """Advance ONE slot by ``len(tokens)`` prompt tokens through the
        shared decode_step, a token at a time — the chunked-prefill
        continuation path of continuous batching.  The slot's cache is a
        view of the engine's, written in place.  Returns the last token's
        logits."""
        sub = {
            "unit": _tree_map(
                lambda x: x[:, slot:slot + 1], self._caches["unit"]
            ),
            "suffix": _tree_map(
                lambda x: x[slot:slot + 1], self._caches["suffix"]
            ),
        }
        toks, poss = self._to_device(
            np.asarray(tokens, np.int32)[:, None],
            np.arange(pos0, pos0 + len(tokens), dtype=np.int32),
        )
        logits = None
        for i in range(len(tokens)):
            logits, _ = decode_step(
                self.cfg, self.params, toks[i:i + 1], sub, poss[i:i + 1]
            )
        return logits[0, 0]

    # ----------------------------------------------------- live bookkeeping
    def _set_state(self, req: Request, new: str) -> None:
        """The one place a live request's state changes: keeps the
        per-state id sets exact and marks the rid for the next pool sync
        (a transition into/out of an accounted state moves pool bytes)."""
        old = req.state
        if new == old:
            return
        ids = self._state_ids.get(old)
        if ids is not None:
            ids.discard(req.request_id)
        self._state_ids.setdefault(new, set()).add(req.request_id)
        req.state = new
        self._pool_dirty.add(req.request_id)
        # suspension is a lifetime-class transition: the ledger restamps
        # the request's sole-held pages PRIVATE_SUFFIX ⇄ FROZEN
        if new == "suspended":
            self.kv.set_frozen(req.request_id, True)
        elif old == "suspended":
            self.kv.set_frozen(req.request_id, False)

    def _track_live(self, req: Request) -> None:
        rid = req.request_id
        self._live[rid] = req
        self._state_ids.setdefault(req.state, set()).add(rid)
        self.kv.ledger.note_projection(
            rid, req.tenant, self.estimate_request_bytes(req)
        )

    def _drop_live(self, req: Request) -> None:
        rid = req.request_id
        if self._live.pop(rid, None) is None:
            return
        ids = self._state_ids.get(req.state)
        if ids is not None:
            ids.discard(rid)
        # the ledger settles per-tenant projections exactly (the bucket
        # is dropped with its last entry), so there is no residue to
        # reset — the old "settle on empty" workaround is gone
        self.kv.ledger.drop_projection(rid)

    # ------------------------------------------------------------- tenants
    def submit(self, req: Request) -> bool:
        """Accept one request into the admission queue; always True (an
        engine never rejects at the door — put a
        :class:`repro_torch.serve.frontdoor.FrontDoor` in front for that)."""
        req.submit_tick = self.tick
        if not req.model:
            req.model = self.cfg.name
        self.requests[req.request_id] = req
        self._submitted += 1
        if req.model != self.cfg.name:
            # a misroute: this replica does not host the request's model.
            # Decoding it through the wrong weights would be silently
            # wrong output — fail typed instead, and count the event so
            # the model_zoo gate can assert the router never causes one.
            self.misroutes += 1
            req.state = "failed"
            req.finish_tick = self.tick
            req.fail_reason = (
                f"wrong_model: replica hosts {self.cfg.name!r}, "
                f"request targets {req.model!r}"
            )
            self.failed.append(req.request_id)
            return True
        self.queue.append(req)
        self._track_live(req)
        return True

    # ------------------------------------------------------------ migration
    def precopy_request(self, request_id: str) -> Optional[PrecopySnapshot]:
        """Phase one of an incremental drain migration: copy the
        request's resident page payloads WITHOUT disturbing it — the
        request keeps its slot, keeps decoding, keeps dirtying pages.
        The cluster ships the snapshot's bytes in the background and
        hands it back to :meth:`export_request` as the ``baseline`` at
        cutover, which then re-ships only the pages written since
        (DESIGN.md §11).

        Call between :meth:`step` calls (the snapshot's epoch is the
        last completed tick).  Returns None when nothing useful can be
        pre-copied: unknown/queued requests, parked imports, recurrent
        constant-state architectures (their state never travels
        page-wise), or a request with no extractable payloads — the
        caller falls back to a monolithic one-shot export.
        """
        req = self._live.get(request_id)
        if (
            req is None
            or req.state == "queued"
            or request_id in self._imports
            or self.spec.constant_state_bytes > 0
        ):
            return None
        table = self.kv.page_table(request_id)
        if not table:
            return None
        snap = PrecopySnapshot(request_id=request_id, epoch=self.tick - 1)
        frozen = self._frozen_payloads.get(request_id, {})
        for idx, pid in enumerate(table):
            if pid == DEMOTED:
                continue  # compressed block travels at cutover instead
            payload = (
                self._page_payload(req.slot, idx)
                if req.slot >= 0
                else frozen.get(idx)
            )
            if payload is not None:
                snap.payloads[idx] = payload
        if not snap.payloads:
            return None
        page_bytes = self.kv.bytes_for(self.cfg, 1)
        snap.raw_bytes = len(snap.payloads) * page_bytes
        snap.wire_bytes = wire_bytes_for(
            snap.raw_bytes, len(snap.payloads), self.ecfg.tier_compress
        )
        return snap

    def export_request(
        self,
        request_id: str,
        baseline: Optional[PrecopySnapshot] = None,
    ) -> Optional[MigrationTicket]:
        """Extract a live request's full state for migration to another
        replica; this engine forgets the request entirely (no double
        accounting — the cluster owns it while its bytes are on the wire).

        What travels depends on where the request's KV currently lives:
        a slot-holding request ships its whole slot cache subtree
        (:meth:`_extract_slot` — bit-exact); a suspended one ships the
        frozen-payload captures; demoted pages leave the tier hierarchy
        as their compressed blocks (:meth:`PagedKVManager.extract_demoted`
        — already int8, already paid the lossy round-trip).  Returns None
        for unknown/terminal requests.

        With ``baseline`` (a :meth:`precopy_request` snapshot of this
        request) the cutover is INCREMENTAL: the ticket carries the
        merged payload set but its ``wire_bytes`` charge only the pages
        the write-epoch ledger marks dirty since the pre-copy — the
        monolithic counterfactual is recorded in ``full_wire_bytes`` so
        the bench can gate ``delta < full``.  When the delta cannot be
        assembled (a dirty page with no extractable payload), the
        monolithic path below runs unchanged.
        """
        req = self._live.get(request_id)
        if req is None:
            return None
        ticket = MigrationTicket(request=req, source_tick=self.tick)
        parked = self._imports.pop(request_id, None)
        if parked is not None:
            # re-exported before it ever landed here: the previous
            # ticket's KV payload is still the request's only copy
            ticket.slot_cache = parked.slot_cache
            ticket.page_payloads = parked.page_payloads
            ticket.raw_bytes = parked.raw_bytes
            ticket.wire_bytes = parked.wire_bytes
        delta_done = False
        if (
            baseline is not None
            and baseline.request_id == request_id
            and parked is None
            and req.state != "queued"
            and self.spec.constant_state_bytes == 0
        ):
            delta_done = self._export_delta(req, ticket, baseline)
        if req.state != "queued" and parked is None and not delta_done:
            if req.slot >= 0:
                ticket.slot_cache = self._extract_slot(req.slot)
            else:
                for idx, payload in self._frozen_payloads.get(
                    request_id, {}
                ).items():
                    if payload is not None:
                        ticket.page_payloads[idx] = payload
            resident_pages = sum(
                1 for pid in self.kv.page_table(request_id) if pid != DEMOTED
            )
            resident_bytes = self.kv.request_bytes(request_id)
            ticket.raw_bytes += resident_bytes
            ticket.wire_bytes += wire_bytes_for(
                resident_bytes, resident_pages, self.ecfg.tier_compress
            )
            for idx, block in self.kv.extract_demoted(request_id).items():
                payload = block.decompress()
                if payload is not None:
                    ticket.page_payloads[idx] = payload
                ticket.raw_bytes += block.raw_bytes
                ticket.wire_bytes += block.stored_bytes
        # forget the request: pool, pages, policy, sampler, slot, queues
        if req in self.queue:
            self.queue.remove(req)
        if request_id in self._restore:
            self._restore.remove(request_id)
        self._release_slot(req)
        self.pool.release_owner(request_id)
        self.kv.release(request_id)
        self.sampler.forget(request_id)
        self.policy.drop(request_id)
        self._frozen_payloads.pop(request_id, None)
        self._imports.pop(request_id, None)
        self._drop_live(req)
        self.requests.pop(request_id, None)
        self.kv.reclaim()
        self._update_pool()
        self.migrations_out += 1
        return ticket

    def _export_delta(
        self,
        req: Request,
        ticket: MigrationTicket,
        baseline: PrecopySnapshot,
    ) -> bool:
        """Assemble the incremental cutover into ``ticket``: merged
        payloads = pre-copied pages overlaid with the pages dirtied
        after the baseline's epoch (plus pages the baseline never saw).
        Returns False — leaving the ticket untouched for the monolithic
        path — when any needed delta payload is unextractable."""
        rid = req.request_id
        table = self.kv.page_table(rid)
        resident = [i for i, pid in enumerate(table) if pid != DEMOTED]
        dirty = self.kv.pages_written_since(rid, baseline.epoch)
        delta_idx = [
            i for i in resident if i in dirty or i not in baseline.payloads
        ]
        frozen = self._frozen_payloads.get(rid, {})
        fresh: Dict[int, np.ndarray] = {}
        for i in delta_idx:
            payload = (
                self._page_payload(req.slot, i)
                if req.slot >= 0
                else frozen.get(i)
            )
            if payload is None:
                return False
            fresh[i] = payload
        merged = dict(baseline.payloads)
        merged.update(fresh)
        if not all(i in merged for i in resident):
            return False  # a clean page the baseline never captured
        ticket.page_payloads = merged
        page_bytes = self.kv.bytes_for(self.cfg, 1)
        delta_raw = len(delta_idx) * page_bytes
        ticket.raw_bytes += delta_raw
        if delta_idx:
            ticket.wire_bytes += wire_bytes_for(
                delta_raw, len(delta_idx), self.ecfg.tier_compress
            )
        ticket.delta_pages = len(delta_idx)
        ticket.precopy_wire_bytes = baseline.wire_bytes
        # the monolithic counterfactual: what one-shot cutover would ship
        resident_bytes = self.kv.request_bytes(rid)
        ticket.full_wire_bytes = wire_bytes_for(
            resident_bytes, len(resident), self.ecfg.tier_compress
        )
        for idx, block in self.kv.extract_demoted(rid).items():
            payload = block.decompress()
            if payload is not None:
                ticket.page_payloads[idx] = payload
            ticket.raw_bytes += block.raw_bytes
            ticket.wire_bytes += block.stored_bytes
            ticket.full_wire_bytes += block.stored_bytes
        return True

    def import_request(self, ticket: MigrationTicket) -> None:
        """Install a migrated request (the target side of a migration).

        A ticket carrying the slot cache subtree — or complete per-page
        payload coverage — lands LIVE: the request waits only for a batch
        row and free pages, then its KV installs via
        :meth:`_install_slot` / :meth:`_install_page_payload` and decode
        continues where the source stopped.  Anything less (partial
        payloads, shared-prefix pages whose values never left the source,
        recurrent constant state) falls back to the replay path the local
        suspend/resume machinery already uses — token-exact, just paying
        the prefill compute again.
        """
        req = ticket.request
        rid = req.request_id
        req.slot = -1
        self.requests[rid] = req
        self._track_live(req)
        self._submitted += 1
        self.migrations_in += 1
        if req.state == "queued":
            self.queue.append(req)
            return
        self.kv.register(
            rid, self.cfg, prompt_tokens=len(req.prompt), tenant=req.tenant
        )
        if ticket.slot_cache is not None or self._payload_covers(ticket):
            self._set_state(req, "importing")
            self._imports[rid] = ticket
        else:
            self._set_state(req, "suspended")
            req.pos = 0
            req.cached_tokens = 0
            req.snap_key = None
            self._restore.append(rid)

    def _payload_covers(self, ticket: MigrationTicket) -> bool:
        """True when per-page payloads alone can rebuild the request's
        cache on this replica: every materialized page shipped a value
        array, and the architecture keeps no recurrent constant state
        (mamba/ring-buffer state never travels page-wise)."""
        if self.spec.constant_state_bytes > 0:
            return False
        req = ticket.request
        pages = (req.pos + self.kv.page_tokens - 1) // self.kv.page_tokens
        return pages > 0 and all(
            ticket.page_payloads.get(i) is not None for i in range(pages)
        )

    def _land_imports(self, free_slots: List[int]) -> None:
        """Attach migrated-in requests to batch rows: allocate their pages
        (never into overcommit — a landing waits for real headroom) and
        install the shipped KV.  Runs before local restores in
        :meth:`_admit`: a migrated request already paid a link crossing;
        making it also queue behind local traffic would double-charge it.
        """
        for rid in list(self._imports):
            if not free_slots:
                return
            ticket = self._imports[rid]
            req = self.requests[rid]
            pages_needed = (
                max(req.pos, 1) + self.kv.page_tokens - 1
            ) // self.kv.page_tokens
            if self.kv.n_pages > 0 and self.kv.free_pages < pages_needed:
                self.kv.evict_cache(pages_needed - self.kv.free_pages)
                if self.kv.free_pages < pages_needed:
                    continue  # no headroom yet: land on a later tick
            slot = free_slots.pop(0)
            req.slot = slot
            self._slot_req[slot] = rid
            self.kv.grow_to(rid, max(req.pos, 1))
            if ticket.slot_cache is not None:
                self._install_slot(slot, ticket.slot_cache)
            else:
                for idx in range(pages_needed):
                    self._install_page_payload(
                        slot, idx, ticket.page_payloads[idx]
                    )
            self.kv.note_write(rid, 0, max(req.pos, 1), self.tick)
            self._set_state(req, "prefill" if req.prefilling else "decoding")
            # fresh rate window on this replica: the sampler must never
            # see the imported progress as one giant burst
            self.sampler.forget(rid)
            del self._imports[rid]
            self._update_pool()

    # ---------------------------------------------------------- checkpointing
    def snapshot_kv(
        self, page_budget: Optional[int] = None
    ) -> Optional[Dict[str, Any]]:
        """One periodic KV snapshot: the page payloads + token progress a
        crash restore needs, ordered by the ledger's
        :class:`~repro_torch.serve.ledger.PageClass` stamp — ``SHARED_PREFIX``
        pages first (they outlive any one request and shield the most
        replay per byte), then private suffix pages; ``SCRATCH`` pages
        would never checkpoint (§11).  ``page_budget`` truncates after
        the ordering, so whatever fits is always the longest-lived state.

        Returns ``{"epoch", "reqs": [{"rid", "pos", "generated",
        "pages": {index: payload}}], "raw_bytes", "stored_bytes"}`` —
        the cluster packs it into a self-describing checkpoint file —
        or None when there is nothing page-wise to persist (recurrent
        constant-state architectures, an empty engine).  Checkpoint
        bytes are accounted against the disk tier
        (:meth:`TieredKVStore.note_checkpoint`) as their own stream,
        distinct from spill.
        """
        if self.spec.constant_state_bytes > 0:
            return None
        # (shared-first rank, rid, idx, payload) — page granularity so a
        # tight budget still captures every request's shared prefix
        candidates: List[Tuple[int, str, int, np.ndarray]] = []
        meta: Dict[str, Request] = {}
        for rid, req in self._live.items():
            if req.state not in ("prefill", "decoding", "suspended"):
                continue
            if req.pos <= 0:
                continue
            frozen = self._frozen_payloads.get(rid, {})
            if req.slot < 0 and not frozen:
                continue
            table = self.kv.page_table(rid)
            shared = self.kv.shared_page_indices(rid)
            pages_needed = (
                req.pos + self.kv.page_tokens - 1
            ) // self.kv.page_tokens
            got_any = False
            for idx in range(min(pages_needed, len(table))):
                if table[idx] == DEMOTED:
                    continue
                payload = (
                    self._page_payload(req.slot, idx)
                    if req.slot >= 0
                    else frozen.get(idx)
                )
                if payload is None:
                    continue
                rank = 0 if idx in shared else 1
                candidates.append((rank, rid, idx, payload))
                got_any = True
            if got_any:
                meta[rid] = req
        if not candidates:
            return None
        candidates.sort(key=lambda c: (c[0], c[1], c[2]))
        if page_budget is not None:
            candidates = candidates[:page_budget]
        reqs: Dict[str, Dict[str, Any]] = {}
        for _, rid, idx, payload in candidates:
            req = meta[rid]
            entry = reqs.setdefault(
                rid,
                {
                    "rid": rid,
                    "pos": req.pos,
                    "generated": list(req.generated),
                    "pages": {},
                },
            )
            entry["pages"][idx] = payload
        page_bytes = self.kv.bytes_for(self.cfg, 1)
        raw = len(candidates) * page_bytes
        stored = wire_bytes_for(
            raw, len(candidates), self.ecfg.tier_compress
        )
        if self.kv.tiers is not None:
            self.kv.tiers.note_checkpoint(raw, stored)
        return {
            "epoch": self.tick - 1,
            "reqs": list(reqs.values()),
            "raw_bytes": raw,
            "stored_bytes": stored,
        }

    def restore_request(
        self, req: Request, page_payloads: Dict[int, np.ndarray]
    ) -> str:
        """Land a crash victim from checkpointed state (the restore side
        of :meth:`snapshot_kv`; ``req.pos`` / ``req.generated`` must
        already be rolled back to the checkpoint's values by the caller).

        Contiguous page coverage from index 0 decides how much replays:
        full coverage lands the request LIVE through the import path
        (zero recompute); partial coverage rolls ``pos`` back to the
        last covered page boundary and chunked prefill replays only the
        uncovered suffix; no coverage falls back to the full replay the
        suspend/resume machinery uses — which still keeps the restored
        ``generated`` tokens, so no decode work repeats even then.
        Returns ``"live"``, ``"suffix"``, ``"replay"``, or ``"queued"``.
        """
        rid = req.request_id
        req.slot = -1
        self.requests[rid] = req
        self._track_live(req)
        self._submitted += 1
        if req.state == "queued" or req.pos <= 0:
            self._set_state(req, "queued")
            req.pos = 0
            self.queue.append(req)
            return "queued"
        self.kv.register(rid, self.cfg, tenant=req.tenant)
        covered = 0
        while page_payloads.get(covered) is not None:
            covered += 1
        pos_covered = covered * self.kv.page_tokens
        outcome = "live"
        if pos_covered < req.pos:
            if covered == 0:
                self._set_state(req, "suspended")
                req.pos = 0
                req.cached_tokens = 0
                req.snap_key = None
                self._restore.append(rid)
                return "replay"
            # roll back to the covered boundary: the suffix replays
            req.pos = pos_covered
            outcome = "suffix"
        ticket = MigrationTicket(
            request=req,
            page_payloads={
                i: page_payloads[i] for i in range(covered)
            },
            source_tick=self.tick,
        )
        if not self._payload_covers(ticket):
            self._set_state(req, "suspended")
            req.pos = 0
            req.cached_tokens = 0
            req.snap_key = None
            self._restore.append(rid)
            return "replay"
        self._set_state(req, "importing")
        self._imports[rid] = ticket
        return outcome

    # ---------------------------------------------------------- cluster view
    @property
    def has_pending(self) -> bool:
        """True while any request still needs engine ticks."""
        if not self.ecfg.legacy_bookkeeping:
            # every non-terminal request is in _live (queued ones are in
            # the admission queue AND _live; terminal states are dropped
            # on finish/fail/export), so membership alone answers this
            return bool(self._live)
        return (
            bool(self.queue)
            or bool(self._imports)
            or any(
                r.state
                in ("prefill", "decoding", "suspended", "offloaded",
                    "importing")
                for r in self._live.values()
            )
        )

    def migratable_requests(self) -> List[Tuple[str, str]]:
        """``(request_id, state)`` of every non-terminal request, cheapest
        migration first: queued work ships zero KV bytes, slotless frozen
        state ships payloads, and running work last — extracting a slot
        cache mid-decode is exact but moves the most bytes."""
        order = {
            "queued": 0,
            "importing": 1,
            "offloaded": 2,
            "suspended": 3,
            "prefill": 4,
            "decoding": 5,
        }
        live = sorted(
            self._live.values(),
            key=lambda r: (
                order.get(r.state, 9), r.submit_tick, r.request_id
            ),
        )
        return [(r.request_id, r.state) for r in live]

    def replica_stats(self) -> Dict[str, Any]:
        """The load surface a cluster router scores placements against
        (see ``SchedulingPolicy.placement_score``), and the admission
        surface a :class:`~repro_torch.serve.frontdoor.FrontDoor` sheds
        against (``capacity_bytes`` / ``projected_bytes``).  ``model``
        and ``memory_class`` declare what this replica hosts — the
        router's capability filter."""
        cap = self.pool.capacity
        if self.ecfg.legacy_bookkeeping:
            # committed future demand: every non-terminal request here
            # will grow to its declared peak — materialized bytes alone
            # make a just-admitted heavy decode look as light as a
            # finished one, which is exactly the placement mistake
            projected_bytes = sum(
                self.estimate_request_bytes(r) for r in self._live.values()
            )
            suspended = float(
                sum(1 for r in self._live.values() if r.state == "suspended")
            )
        else:
            projected_bytes = self.kv.ledger.projected_bytes()
            suspended = float(len(self._state_ids.get("suspended", ())))
        demand = 0.0
        projected = 0.0
        if cap > 0:
            demand = (
                max(self.pool.used_bytes - self.kv.reclaimable_bytes, 0.0)
                / cap
            )
            projected = projected_bytes / cap
        busy = sum(1 for r in self._slot_req if r is not None)
        waiting = len(self.queue) + len(self._restore) + len(self._imports)
        stats = {
            "demand_fraction": demand,
            "projected_fraction": projected,
            "used_fraction": self.pool.used_fraction,
            "slot_load": (busy + waiting) / max(self.ecfg.n_slots, 1),
            "free_slots": float(self.ecfg.n_slots - busy),
            "queued": float(len(self.queue)),
            "live": float(len(self._live)),
            "suspended": suspended,
            "tick_cost": self.last_tick_cost,
            "capacity_bytes": float(cap),
            "projected_bytes": float(projected_bytes),
            "model": self.cfg.name,
            "memory_class": self.spec.memory_class,
        }
        # the class-aware view: per-lifetime-class HBM bytes, straight
        # off the ledger — placement and scale_pressure read these
        by_class = self.kv.ledger.class_breakdown()
        for cls in PageClass:
            stats[f"{cls.value}_bytes"] = by_class.get(cls, 0.0)
        stats["frozen_fraction"] = (
            by_class.get(PageClass.FROZEN, 0.0) / cap if cap > 0 else 0.0
        )
        stats["reclaimable_fraction"] = (
            self.kv.reclaimable_bytes / cap if cap > 0 else 0.0
        )
        return stats

    def tick_cost_stats(self) -> Dict[str, Any]:
        """Distribution of the roofline-derived tick costs this engine
        paid — the bench/gate evidence that costs are DERIVED (seconds,
        varying with the work each tick actually did), not hand-set
        constants.  ``distinct`` counts unique values seen (capped at 64
        samples); > 1 means the cost tracked the load."""
        n = self._tick_cost_count
        return {
            "source": "roofline",
            "ticks": n,
            "mean_s": (self._tick_cost_sum / n) if n else 0.0,
            "min_s": self._tick_cost_min if n else 0.0,
            "max_s": self._tick_cost_max,
            "distinct": len(self._tick_cost_values),
            "paged_decode_ticks": self.paged_decode_ticks,
        }

    def group_demand(self) -> Dict[str, float]:
        """Projected peak bytes per tenant over live requests — the front
        door's shedding input (who is actually filling the pool)."""
        if self.ecfg.legacy_bookkeeping:
            out: Dict[str, float] = {}
            for r in self._live.values():
                out[r.tenant] = (
                    out.get(r.tenant, 0.0) + self.estimate_request_bytes(r)
                )
            return out
        return self.kv.ledger.projected_by_tenant()

    def estimate_request_bytes(self, req: Request) -> float:
        """Page-rounded bytes the request will pin at its declared peak
        (prompt + max_new_tokens — the §III-B projected need, known at
        admission) — the router's inbound-load estimate.  Allocates
        nothing; prompt-only sizing would make a 40-token decode and a
        4-token decode look identical to placement.

        Per-model: the paged term is zero for a constant-state (mamba)
        model, whose whole estimate is its fixed state; an
        encoder-decoder model adds the encoder-side KV its prompt pins
        for the request's lifetime."""
        return (
            self.kv.bytes_for(self.cfg, req.total_tokens)
            + self.spec.constant_state_bytes
            + self.cfg.encoder_bytes(len(req.prompt))
        )

    # ------------------------------------------------------------ accounting
    def _update_pool(self) -> None:
        if self.ecfg.legacy_bookkeeping:
            for rid, req in self._live.items():
                if req.state in (
                    "prefill", "decoding", "suspended", "offloaded"
                ):
                    # offloaded requests still own HBM bytes until the
                    # last page demotes (and again as promotions land) —
                    # skipping them leaves stale live entries pinning the
                    # pool
                    self.pool.set_live(rid, self.kv.request_bytes(rid))
        else:
            # only owners whose attribution actually changed re-sync:
            # every allocator refcount event (incl. co-holders of shared
            # pages) and every state transition marks its rid dirty
            dirty = self.kv.drain_dirty()
            if self._pool_dirty:
                dirty |= self._pool_dirty
                self._pool_dirty = set()
            for rid in dirty:
                req = self._live.get(rid)
                if req is not None and req.state in (
                    "prefill", "decoding", "suspended", "offloaded"
                ):
                    self.pool.set_live(rid, self.kv.request_bytes(rid))
        if self.ecfg.prefix_cache:
            # cold cached prefixes are live pool bytes too — the policy
            # must see them (and eviction must relieve them)
            self.pool.set_live(CACHE_OWNER, self.kv.cache_bytes)
        self.peak_used_fraction = max(
            self.peak_used_fraction, self.pool.used_fraction
        )
        self.kv.ledger.sample_peaks()
        if self.pool.capacity > 0:
            demand = (
                self.pool.used_bytes - self.kv.reclaimable_bytes
            ) / self.pool.capacity
            self.peak_demand_fraction = max(self.peak_demand_fraction, demand)

    def _pressure_plan(self) -> PressurePlan:
        """Ask the policy how to relieve pressure, handing it the
        class-stamped ledger view (the one surface replacing the old
        ``cache_pressure``/``demotion_pressure``/``shed_order`` trio)."""
        return self.policy.pressure(self.kv.ledger.view(self.pool.capacity))

    def _reclaim_one(
        self, cls: PageClass, protect: Sequence[int] = ()
    ) -> bool:
        """Reclaim ONE page of ``cls`` (the plan loops this until the
        deficit clears or the class runs dry).  Returns False when the
        class has nothing left to give."""
        if cls is PageClass.SCRATCH:
            return self.kv.evict_scratch(1) > 0
        if cls is PageClass.COLD_CACHED:
            return self.kv.evict_cache(1, protect=protect) > 0
        if cls is PageClass.FROZEN:
            return self._demote_frozen_page()
        return False

    def _active(self) -> List[Request]:
        return [
            r
            for r in self._live.values()
            if r.state in ("prefill", "decoding")
        ]

    # ------------------------------------------------------------ admission
    def _admit(self) -> None:
        """Admit queued requests while slots and prompt headroom allow.

        A request that does not fit WAITS at the door (stock continuous-
        batching semantics: block until KV pages free up) — for every
        policy, so admission order is never a policy branch.  What differs
        is how fast headroom appears: a suspending policy swaps frozen KV
        to host and frees pages; a pressure-oblivious one waits for
        completions or pays the reactive spill path.
        """
        free_slots = [i for i, r in enumerate(self._slot_req) if r is None]
        # migrated-in requests land first (their KV installs from the
        # ticket, no replay), then local restores
        self._land_imports(free_slots)
        # resumed / promoted requests re-acquire a batch row first — their
        # slot cache is rebuilt by replaying feed_tokens through the
        # chunked-prefill path (their page-pool accounting never moved; a
        # request whose pages are still demoted waits here, resident-gated,
        # while the promotion pass DMAs them back)
        cursor = 0
        while cursor < len(self._restore) and free_slots:
            req = self.requests[self._restore[cursor]]
            if not self.kv.resident(req.request_id):
                cursor += 1
                continue
            self._restore.pop(cursor)
            if self.ecfg.prefix_cache:
                # replay can skip prefill too: a reloaded request re-shares
                # cached pages; a suspended one (pages retained) just reuses
                # the snapshot for the covered positions.  Neither counts
                # as a cache HIT — re-matching your own published prefix is
                # not cross-request sharing (count_stats/hit_counted)
                if self.kv.request_pages(req.request_id) == 0:
                    req.cached_tokens, req.snap_key = self.kv.match_prefix(
                        req.request_id,
                        req.feed_tokens,
                        float(self.tick),
                        count_stats=False,
                    )
                else:
                    req.cached_tokens, req.snap_key = self.kv.peek_prefix(
                        req.feed_tokens
                    )
                req.hit_counted = True
            slot = free_slots.pop(0)
            req.slot = slot
            self._slot_req[slot] = req.request_id
            self._set_state(req, "prefill")
            req.pos = 0
            self._frozen_payloads.pop(req.request_id, None)
            # replay rewinds processed-token counts: restart the rate
            # estimator so the sampler never sees progress go backwards
            # (a stale window would report rate 0 and invert MURS's
            # keep-the-lightest victim ordering)
            self.sampler.forget(req.request_id)
        # a tenant with suspended requests is a known heavy-pressure source:
        # don't admit more of its traffic until its queue drains (the sim's
        # launch gating, §I: "the resources are released from running heavy
        # tasks" — and handed to the light tenants)
        gated = {
            self.requests[tid].tenant
            for tid in self.policy.suspended_queue
            if tid in self.requests
        }
        headroom = self.policy.admission_headroom * self.pool.capacity
        # the policy's placement hook decides which tenant's head-of-line
        # request each free slot goes to (FAIR/MURS: round-robin across
        # tenants, PriorityPolicy: weighted stride) — FIFO within a tenant
        by_tenant: Optional[Dict[str, List[Request]]] = None
        if self.ecfg.legacy_bookkeeping:
            by_tenant = {}
            for r in self.queue:
                if r.tenant not in gated:
                    by_tenant.setdefault(r.tenant, []).append(r)
            pending = {t: len(v) for t, v in by_tenant.items()}
        else:
            # same mapping, same key order (tenants by oldest queued
            # request) — read off the queue's index instead of an
            # O(queue) rebuild every tick
            pending = self.queue.tenant_counts(exclude=gated)
        picks = self.policy.assign(len(free_slots), pending)
        for tenant in picks:
            if not free_slots:
                continue
            if by_tenant is not None:
                bucket = by_tenant.get(tenant)
                req = bucket[0] if bucket else None
            else:
                req = self.queue.head(tenant)
            if req is None:
                continue
            # capacity check: would this request's prompt fit below the
            # policy's admission line right now?  Pure arithmetic — no
            # allocator churn for a request that just waits at the door.
            # Pages a prefix-cache match would share cost nothing new;
            # ``protected`` shields them from this pass's own evictions.
            prompt_bytes, protected = self.kv.admission_probe(
                self.cfg, req.prompt
            )
            # encoder-decoder models pin the encoder-side cross-attention
            # KV at prefill too — admission must count it with the prompt
            prompt_bytes += self.cfg.encoder_bytes(len(req.prompt))
            if prompt_bytes > headroom:
                # can never fit, even into an empty pool: fail fast
                # (OOM semantics) instead of blocking the queue forever
                self.queue.remove(req)
                if by_tenant is not None:
                    by_tenant[tenant].pop(0)
                self._set_state(req, "failed")
                req.finish_tick = self.tick
                req.fail_reason = "prompt exceeds admission headroom"
                self.failed.append(req.request_id)
                self._drop_live(req)
                continue
            # reclaim class by class in the policy plan's order (stock:
            # SCRATCH, then COLD_CACHED, then FROZEN) — scratch and cold
            # cache are cheap drops; frozen suspended KV demotes PAGE BY
            # PAGE and only while that can actually open the door (no
            # more bytes leave HBM than the deficit requires).  The probe
            # above's shareable pages stay protected throughout.
            plan = self._pressure_plan()
            for cls in plan.reclaim_order:
                if cls is PageClass.FROZEN:
                    while (
                        self.pool.used_bytes + prompt_bytes > headroom
                        and self.pool.used_bytes
                        - self.kv.ledger.class_bytes(PageClass.FROZEN)
                        + prompt_bytes
                        <= headroom
                    ):
                        if not self._demote_frozen_page():
                            break
                        self._update_pool()
                else:
                    while self.pool.used_bytes + prompt_bytes > headroom:
                        if not self._reclaim_one(cls, protect=protected):
                            break
                        self._update_pool()
            if self.pool.used_bytes + prompt_bytes > headroom:
                break  # pool-bound: nobody else fits this tick either
            self.queue.remove(req)
            if by_tenant is not None:
                by_tenant[tenant].pop(0)
            self.kv.register(
                req.request_id,
                self.cfg,
                prompt_tokens=len(req.prompt),
                tenant=req.tenant,
            )
            if self.ecfg.prefix_cache:
                # the trie hands over every page of the longest cached
                # prefix by reference — prefill will start at the first
                # uncached token
                req.cached_tokens, req.snap_key = self.kv.match_prefix(
                    req.request_id, req.feed_tokens, float(self.tick)
                )
            self.kv.grow_to(req.request_id, len(req.prompt))
            slot = free_slots.pop(0)
            req.slot = slot
            self._slot_req[slot] = req.request_id
            self._set_state(req, "prefill")
            req.pos = 0
            self._update_pool()

    # --------------------------------------------------------- slot caches
    def _extract_slot(self, slot: int) -> Dict[str, Any]:
        """Copy one slot's cache subtree (the KV snapshot a cached prefix
        is installed from)."""
        return {
            "unit": _tree_map(
                lambda x: x[:, slot].clone(), self._caches["unit"]
            ),
            "suffix": _tree_map(
                lambda x: x[slot].clone(), self._caches["suffix"]
            ),
        }

    def _install_slot(self, slot: int, sub: Dict[str, Any]) -> None:
        """Write a snapshot subtree into ``slot`` of the batched caches,
        in place."""
        for s, o in zip(_leaves(self._caches["unit"]), _leaves(sub["unit"])):
            s[:, slot].copy_(o)
        for s, o in zip(
            _leaves(self._caches["suffix"]), _leaves(sub["suffix"])
        ):
            s[slot].copy_(o)

    # ---------------------------------------------------------- prefix COW
    def _cow_range(self, req: Request, start_pos: int, end_pos: int) -> None:
        """Copy-on-write guard before writing tokens [start_pos, end_pos):
        any shared page in that span is split so the shared copy is never
        mutated.  No-op over private pages."""
        if end_pos <= start_pos:
            return
        page = self.kv.page_tokens
        for idx in range(start_pos // page, (end_pos - 1) // page + 1):
            self.kv.make_private(req.request_id, idx)

    # ---------------------------------------------------------- tier payloads
    def _page_span(self, page_index: int) -> Tuple[int, int]:
        a = page_index * self.kv.page_tokens
        return a, min(a + self.kv.page_tokens, self.ecfg.max_seq)

    def _seq_leaf(self, x) -> bool:
        """True for cache leaves carrying a per-position axis at ``-2``
        (attention K/V ``[..., seq, hd]``, MLA latents ``[seq, rank]``) —
        the leaves a token-span page physically owns.  Constant-state
        leaves (mamba, ring buffers) have no such axis and never demote."""
        return x.ndim >= 2 and x.shape[-2] == self.ecfg.max_seq

    def _page_payload(self, slot: int, page_index: int) -> Optional[np.ndarray]:
        """The REAL bytes of one page: every cache value for the page's
        token span, flattened f32 — what the host tier int8-compresses.
        Leaves go in the JAX package's ``tree_leaves`` order (dict keys
        sorted), so a payload means the same thing on both sides."""
        a, b = self._page_span(page_index)
        if a >= b:
            return None
        parts = []
        for leaf in _leaves(self._caches["unit"]):
            x = leaf[:, slot]
            if self._seq_leaf(x):
                parts.append(x[..., a:b, :].float().reshape(-1))
        for leaf in _leaves(self._caches["suffix"]):
            x = leaf[slot]
            if self._seq_leaf(x):
                parts.append(x[..., a:b, :].float().reshape(-1))
        if not parts:
            return None
        return torch.cat(parts).cpu().numpy()

    def _install_page_payload(
        self, slot: int, page_index: int, payload: np.ndarray
    ) -> None:
        """Inverse of :meth:`_page_payload`: write the (dequantized)
        page span back into the slot cache, in place — the lossy int8
        round-trip lands in the values decode actually attends over."""
        a, b = self._page_span(page_index)
        if a >= b:
            return
        vals = torch.from_numpy(np.asarray(payload, np.float32)).to(
            self.device
        )
        off = 0
        views = [leaf[:, slot] for leaf in _leaves(self._caches["unit"])]
        views += [leaf[slot] for leaf in _leaves(self._caches["suffix"])]
        for x in views:
            if not self._seq_leaf(x):
                continue
            span = x[..., a:b, :]
            n = span.numel()
            span.copy_(vals[off:off + n].view(span.shape))
            off += n

    # -------------------------------------------------------------- prefill
    def _install_prefill(self, req: Request, tokens: List[int]) -> Any:
        """Monolithic prefill of ``tokens`` into the request's slot; returns
        the last-position logits."""
        (arr,) = self._to_device(np.asarray([tokens], np.int32))
        logits, caches = prefill(
            self.cfg, self.params, arr, max_seq=self.ecfg.max_seq
        )
        # install the request's cache into its slot (unit leaves carry the
        # repeat dim first → slot axis is 1; suffix leaves → axis 0)
        slot = req.slot
        for s, o in zip(_leaves(self._caches["unit"]), _leaves(caches["unit"])):
            s[:, slot].copy_(o[:, 0])
        for s, o in zip(
            _leaves(self._caches["suffix"]), _leaves(caches["suffix"])
        ):
            s[slot].copy_(o[0])
        req.pos = len(tokens)
        self.kv.note_write(req.request_id, 0, len(tokens), self.tick)
        return logits[0, -1]

    def _finish_prefill(self, req: Request, last_logits) -> None:
        if req.generated:
            # replay after suspension/offload: the cache is rebuilt; the
            # next decode step feeds generated[-1] — nothing new to sample
            self._set_state(req, "decoding")
            return
        next_tok = int(torch.argmax(last_logits))
        self._publish_prefix(req, next_tok)
        req.generated.append(next_tok)
        req.first_token_tick = self.tick
        self._set_state(req, "decoding")

    def _publish_prefix(self, req: Request, first_tok: int) -> None:
        """Insert a freshly prefilled prompt's pages into the trie and
        snapshot its slot KV so later identical/overlapping prompts skip
        prefill.  The request keeps decoding into its own pages: its first
        append into the now-shared terminal page copy-on-writes."""
        if not self.ecfg.prefix_cache or req.slot < 0:
            return
        feed = tuple(req.feed_tokens)
        inserted = self.kv.insert_prefix(
            req.request_id, feed, req.tenant, feed, float(self.tick)
        )
        if inserted and feed not in self._snaps:
            while len(self._snaps) >= self.ecfg.max_prefix_snapshots:
                # LRU: dict order is maintained by the touch in
                # _install_cached_prefix, so the head is the coldest
                self._snaps.pop(next(iter(self._snaps)))
            self._snaps[feed] = (
                self._extract_slot(req.slot),
                first_tok,
                len(feed),
            )

    def _install_cached_prefix(self, req: Request) -> None:
        """Skip prefill for trie-matched tokens: install the prefix's KV
        snapshot into the request's slot and continue from the first
        uncached token.  An exact-prompt hit finishes prefill outright —
        zero prefill compute, first token this tick."""
        snap = self._snaps.get(req.snap_key) if req.snap_key else None
        feed = req.feed_tokens
        if snap is None:
            # snapshot pruned between match and slot assignment: recompute
            # from scratch — writes into the still-shared pages COW first
            req.cached_tokens = 0
            req.snap_key = None
            return
        self._snaps[req.snap_key] = self._snaps.pop(req.snap_key)  # LRU touch
        caches_sub, first_tok, snap_len = snap
        self._install_slot(req.slot, caches_sub)
        self.kv.note_write(req.request_id, 0, max(snap_len, 1), self.tick)
        matched = min(req.cached_tokens, len(feed))
        count = not req.hit_counted  # replays must not re-count dedup work
        if count:
            self.prefix_hits += 1
            req.hit_counted = True
        if matched >= len(feed) and snap_len == len(feed):
            req.pos = len(feed)
            if count:
                self.prefix_hit_tokens += len(feed)
            if req.generated:
                # replay: next decode feeds last tok
                self._set_state(req, "decoding")
            else:
                req.generated.append(first_tok)
                req.first_token_tick = self.tick
                self._set_state(req, "decoding")
        else:
            # partial hit (or full-page hit needing last-position logits):
            # chunked prefill resumes at the first position whose logits or
            # KV the snapshot cannot provide
            req.pos = min(matched, len(feed) - 1)
            if count:
                self.prefix_hit_tokens += req.pos

    def _prefill_tick(self) -> None:
        """Consume up to ``prefill_chunk_tokens`` prompt tokens this tick.

        Short prompts take the monolithic fast path (one fused prefill
        call, same numerics as before); longer prompts start with one
        budget-sized monolithic chunk and continue through the single-slot
        decode path a chunk per tick — decode slots keep ticking in
        between, which is the whole point of chunked prefill.
        """
        budget = self.ecfg.prefill_chunk_tokens
        chunked = False
        for rid in list(self._slot_req):
            if rid is None:
                continue
            req = self.requests[rid]
            if req.state != "prefill":
                continue
            if not self.kv.resident(rid):
                self.stall_ticks += 1  # KV not fully in HBM: wait
                if self.kv.has_demoted(rid):
                    self.transfer_stall_ticks += 1  # tier DMA pending
                continue
            if req.pos == 0 and req.cached_tokens > 0:
                # prefix-cache hit: KV for the matched tokens installs
                # from the snapshot — no prefill compute, no budget, so
                # this runs even when a long cold prefill drained the
                # budget (an exact hit must never queue behind compute)
                self._install_cached_prefix(req)
                if req.state != "prefill":
                    continue  # exact hit: first token already sampled
            if budget <= 0:
                continue  # compute paths below need budget; hits don't
            feed = req.feed_tokens
            if req.pos == 0:
                if len(feed) <= budget:
                    self.kv.grow_to(rid, len(feed))
                    self._cow_range(req, 0, len(feed))
                    logits = self._install_prefill(req, feed)
                    budget -= len(feed)
                    self._tick_prefill_tokens += len(feed)
                    self._finish_prefill(req, logits)
                else:
                    # power-of-two first chunk: a partial leftover budget
                    # still starts the prompt (no starvation behind short
                    # traffic) while keeping the compiled shapes bounded
                    w = 1 << (budget.bit_length() - 1)
                    self.kv.grow_to(rid, w)
                    self._cow_range(req, 0, w)
                    self._install_prefill(req, feed[:w])
                    budget -= w
                    self._tick_prefill_tokens += w
                    chunked = True
            else:
                take = min(budget, len(feed) - req.pos)
                budget -= take
                self._tick_prefill_tokens += max(take, 0)
                last = None
                if take > 0:
                    self.kv.grow_to(rid, req.pos + take)
                    self._cow_range(req, req.pos, req.pos + take)
                    self.kv.note_write(
                        rid, req.pos, req.pos + take, self.tick
                    )
                # one continuation call per tick: the port runs eagerly, so
                # the JAX engine's power-of-two buckets (a bounded set of
                # compiled scan widths) have nothing to bound here
                if take > 0:
                    last = self._chunk_scan(
                        feed[req.pos:req.pos + take], req.slot, req.pos
                    )
                    req.pos += take
                chunked = True
                if not req.prefilling and last is not None:
                    self._finish_prefill(req, last)
            self.kv.grow_to(req.request_id, max(req.pos, 1))
        if chunked:
            self.chunked_prefill_ticks += 1
        self._update_pool()

    # --------------------------------------------------------------- decode
    def _decode_tick(self) -> float:
        """One decode tick over the resident active slots.  Returns the
        KV bytes the tick's attention read (the roofline's HBM traffic
        term), derived from the ledger's per-owner attribution — not a
        separately maintained tally."""
        active = []
        for i, rid in enumerate(self._slot_req):
            if rid is None or self.requests[rid].state != "decoding":
                continue
            if not self.kv.resident(rid):
                # tokens on overflow or demoted pages are not in HBM —
                # attention cannot read them; the request stalls until
                # reclaim() / promotion pages them back in
                self.stall_ticks += 1
                if self.kv.has_demoted(rid):
                    self.transfer_stall_ticks += 1
                continue
            active.append((i, self.requests[rid]))
        if not active:
            return 0.0
        self._tick_decode_tokens = len(active)
        kv_bytes_read = sum(
            self.kv.request_bytes(req.request_id) for _, req in active
        )
        plan = (
            self._paged_plan(active)
            if self._paged_ok and self.kv.n_pages > 0
            else None
        )
        if plan is not None:
            nxt = self._decode_paged_batch(active, plan)
        else:
            nxt = self._decode_dense_batch(active)
        for r, (i, req) in enumerate(active):
            req.pos += 1
            self.kv.grow_to(req.request_id, req.pos)
            # the KV write landed at position pos-1: if that page is shared
            # (an exact-prompt hit decoding past its cached terminal page),
            # split it first — shared pages are never mutated.  The paged
            # path addressed this page through a synthetic pool id, so
            # this is the FIRST allocator mutation either way: both decode
            # paths drive the same allocator event sequence.
            self.kv.make_private(
                req.request_id, (req.pos - 1) // self.kv.page_tokens
            )
            self.kv.note_write(
                req.request_id, req.pos - 1, req.pos, self.tick
            )
            req.generated.append(int(nxt[r]))
            if req.done:
                self._finish(req)
        self._update_pool()
        return kv_bytes_read

    def _decode_dense_batch(self, active) -> np.ndarray:
        """Dense per-slot decode over all slots (the differential oracle).

        Inputs are staged host-side in numpy and shipped in ONE copy; the
        argmax runs on the device over the whole batch and comes back in
        one transfer.  Only the active slots' caches are written.
        Returns next tokens aligned with ``active`` order.
        """
        n = self.ecfg.n_slots
        tokens = np.zeros((n, 1), np.int32)
        poss = np.zeros((n,), np.int32)
        rows = np.asarray([i for i, _ in active], np.int32)
        for i, req in active:
            tokens[i, 0] = req.generated[-1]
            poss[i] = req.pos
        tokens, poss, rows = self._to_device(tokens, poss, rows)
        logits, _ = decode_step(
            self.cfg, self.params, tokens, self._caches, poss,
            rows=rows.long(),
        )
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        return nxt[[i for i, _ in active]]

    def _paged_plan(self, active):
        """Rows sorted longest-first plus their ``gather_plan``, or None
        when a running request briefly overlaps an in-flight demotion (its
        table carries DEMOTED ids): the dense slot caches still hold every
        value, so that tick decodes on the dense path."""
        order = sorted(active, key=lambda sr: (-sr[1].pos, sr[0]))
        try:
            plan = self.kv.gather_plan(
                [req.request_id for _, req in order],
                [slot for slot, _ in order],
            )
        except ValueError:
            return None
        return order, plan

    def _decode_paged_batch(self, active, paged_plan) -> np.ndarray:
        """One decode tick through the paged-decode kernel.

        Batches every active row's LIVE page table (the same tables the
        byte accounting runs on) into a single ``decode_step_paged`` call:
        rows sorted longest-first, table width and pool bound trimmed to
        powers of two (``kv.gather_plan``), pad rows carrying an
        out-of-range slot so they write nothing of their own.  Returns next
        tokens aligned with ``active`` order — the sort exists only to trim
        the kernel's page sweep; bookkeeping (and the order-sensitive
        finish→resume chain) must see the same row order as the dense
        oracle.
        """
        P = self.kv.page_tokens
        # longest first: the trimmed width follows row 0, so the kernel's
        # page sweep never runs past the longest resident request
        order, (tables, src_slot, src_idx, n_pool) = paged_plan
        rows = len(order)
        # this tick's KV write lands in page pos // P, which may not exist
        # yet (page boundary) or may be shared (exact-prompt hit on a
        # cached terminal page).  Address it through a per-row SYNTHETIC
        # pool id mapped to the row's own slot cache instead of mutating
        # the allocator here: grow/COW/release then run ONLY in the shared
        # post-decode bookkeeping, in exactly the dense oracle's order —
        # the kernel wiring must not perturb the allocator event sequence
        # the scheduling policy observes.
        n_pool2 = 1 << max(n_pool + rows - 1, 0).bit_length()
        src_slot = np.pad(src_slot, (0, n_pool2 - n_pool))
        src_idx = np.pad(src_idx, (0, n_pool2 - n_pool))
        need = max(req.pos // P + 1 for _, req in order)
        w = 1 << max(max(need, tables.shape[1]) - 1, 0).bit_length()
        b = 1 << (rows - 1).bit_length()  # pow2 rows: the JAX engine's shapes
        tok = np.zeros((b, 1), np.int32)
        # pad rows carry slot == n_slots (see decode_step_paged)
        row_slot = np.full((b,), self.ecfg.n_slots, np.int32)
        poss = np.zeros((b,), np.int32)
        lens = np.zeros((b,), np.int32)
        tab = np.zeros((b, w), np.int32)
        for r, (slot, req) in enumerate(order):
            tok[r, 0] = req.generated[-1]
            row_slot[r] = slot
            poss[r] = req.pos
            lens[r] = req.pos + 1  # dense decode attends k_pos <= pos
            tab[r, : tables.shape[1]] = tables[r]
            wp = req.pos // P
            sid = n_pool + r
            tab[r, wp] = sid
            src_slot[sid] = slot
            src_idx[sid] = wp
        tok, row_slot, poss, tab, lens, src_slot, src_idx = self._to_device(
            tok, row_slot, poss, tab, lens, src_slot, src_idx
        )
        logits, _ = decode_step_paged(
            self.cfg, self.params, tok, self._caches, poss, row_slot, tab,
            lens, src_slot, src_idx,
            page_tokens=P, n_pool=n_pool2, int8=self._paged_int8,
        )
        self.paged_decode_ticks += 1
        if self._paged_int8:
            self.paged_int8_ticks += 1
        # batch argmax on the device: ONE transfer back per tick
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        row_of = {slot: r for r, (slot, _) in enumerate(order)}
        return nxt[[row_of[slot] for slot, _ in active]]

    def _finish(self, req: Request) -> None:
        self._set_state(req, "done")
        req.finish_tick = self.tick
        self.completed.append(req.request_id)
        self._drop_live(req)
        self._release_slot(req)
        self.pool.release_owner(req.request_id)
        self.kv.release(req.request_id)
        self.sampler.forget(req.request_id)
        self._frozen_payloads.pop(req.request_id, None)
        rid = self.policy.on_task_complete(req.request_id)
        if rid is not None:
            self._resume(rid)

    # ----------------------------------------------------------------- policy
    def _policy_pass(self) -> None:
        active = self._active()
        for r in active:
            self.sampler.observe(
                r.request_id,
                processed_bytes=float(r.pos),
                total_bytes=float(r.total_tokens),
                live_bytes=self.kv.request_bytes(r.request_id),
                group=r.tenant,
            )
        stats = self.sampler.stats([r.request_id for r in active])
        # expose the online §III classification on each request, and tell
        # the policy the DECLARED architecture class of each group it is
        # about to score (on this engine, every group runs this model)
        seen_groups = set()
        for st in stats:
            self.requests[st.task_id].memory_model = st.model.value
        for r in active:
            if r.tenant not in seen_groups:
                seen_groups.add(r.tenant)
                self.policy.note_group_class(
                    r.tenant, self.spec.memory_class
                )
        frozen = self.sampler.stats(
            [
                r.request_id
                for r in self._live.values()
                if r.state == "suspended"
            ]
        )
        decision = self.policy.propose(
            self.pool, stats, now=float(self.tick), suspended=frozen
        )
        for rid in decision.suspend:
            req = self.requests[rid]
            if req.state in ("decoding", "prefill"):
                self._set_state(req, "suspended")
                self.suspensions += 1
                if req.slot >= 0:
                    # capture the frozen pages' REAL KV values while the
                    # slot is still attached: if the policy later demotes
                    # them, the host tier compresses these bytes
                    self._frozen_payloads[rid] = {
                        idx: self._page_payload(req.slot, idx)
                        for idx in self.kv.demotable_indices(rid)
                    }
                self._release_slot(req)
        for rid in decision.resume:
            self._resume(rid)

    def _release_slot(self, req: Request) -> None:
        """Free the request's batch row (its KV pages stay accounted) — in
        a paged runtime batch rows are virtual, so a suspended request must
        not block admission of new work."""
        if req.slot >= 0:
            self._slot_req[req.slot] = None
            req.slot = -1

    def _resume(self, rid: str) -> None:
        req = self.requests.get(rid)
        if req is None:
            return
        if req.state == "suspended":
            # re-acquire a batch row; the slot cache is rebuilt by replay.
            # If frozen pages were demoted, the promotion pass DMAs them
            # back first (the restore loop is residency-gated).
            if rid not in self._restore:
                self._restore.append(rid)

    # ----------------------------------------------------------------- tick
    def step(self) -> None:
        """Advance one tick: admit, prefill a chunk, decode the batch,
        then the policy/demotion passes; updates ``last_tick_cost``."""
        stalls0 = self.stall_ticks
        self._tick_prefill_tokens = 0
        self._tick_decode_tokens = 0
        self._admit()
        self._prefill_tick()
        kv_bytes_read = self._decode_tick()
        # roofline-derived tick service time (modeled seconds): bytes
        # moved this tick — weight stream + the KV pages of the requests
        # actually decoded + prefill writes — over HBM bandwidth, vs
        # FLOPs over peak, plus one PCIe page DMA per stall.  Straggler
        # detection, placement scoring and the overload bench inherit
        # hardware-meaningful units from here (deterministic — no wall
        # clock in the simulation).
        cost = self._tick_cost_model.tick_seconds(
            decode_tokens=self._tick_decode_tokens,
            prefill_tokens=self._tick_prefill_tokens,
            kv_bytes_read=kv_bytes_read,
            stall_events=self.stall_ticks - stalls0,
        )
        self.last_tick_cost = cost
        self._tick_cost_count += 1
        self._tick_cost_sum += cost
        self._tick_cost_min = min(self._tick_cost_min, cost)
        self._tick_cost_max = max(self._tick_cost_max, cost)
        if len(self._tick_cost_values) < 64:
            self._tick_cost_values.add(round(cost, 15))
        period_ticks = max(
            round(self.policy.period * self.ecfg.murs_period_ticks), 1
        )
        if self.tick % period_ticks == 0:
            self._policy_pass()
        self._proactive_demotion()
        self._resolve_overcommit()
        # advance the tier hierarchy: completed promotions swap back into
        # page tables; pages a slot is still attached to get their
        # (dequantized) values written back into the cache
        for rid, idx, payload in self.kv.tick_tiers(float(self.tick)):
            req = self.requests.get(rid)
            if req is not None and req.slot >= 0 and payload is not None:
                self._install_page_payload(req.slot, idx, payload)
                self.kv.note_page_write(rid, idx, self.tick)
        self._promotion_pass()
        self.kv.reclaim()
        if (
            self.ecfg.prefix_cache
            and self.kv.cache_evictions != self._pruned_at_evictions
        ):
            # drop KV snapshots no trie node references anymore
            live = self.kv.live_snap_keys()
            self._snaps = {k: v for k, v in self._snaps.items() if k in live}
            self._pruned_at_evictions = self.kv.cache_evictions
        self.tick += 1

    def _frozen_victims(self, require_pressure: bool) -> List[Request]:
        """Suspended requests whose frozen KV may demote, best victim
        first: highest plan ``FROZEN`` score (the policy's hint — MURS
        marks low-usage-rate tenants), then fattest.  With
        ``require_pressure`` only positively-marked tenants qualify (the
        proactive pass is policy-opt-in; the reactive paths take anyone).
        """
        if self.ecfg.legacy_bookkeeping:
            frozen = [
                r
                for r in self._live.values()
                if r.state == "suspended"
            ]
        else:
            frozen = [
                self.requests[rid]
                for rid in sorted(self._state_ids.get("suspended", ()))
            ]
        victims = [
            r
            for r in frozen
            if r.request_id not in self._restore
            and self.kv.demotable_indices(r.request_id)
        ]
        plan = self._pressure_plan()
        if require_pressure:
            # the FIFO head resumes next (one per completion): demoting
            # its pages proactively would just buy a promotion stall —
            # keep it hot, demote from the back of the queue forward
            queue = self.policy.suspended_queue
            head = queue[0] if queue else None
            victims = [
                r
                for r in victims
                if plan.score(PageClass.FROZEN, r.tenant) > 0.0
                and r.request_id != head
            ]
        victims.sort(
            key=lambda r: (
                -plan.score(PageClass.FROZEN, r.tenant),
                -self.kv.request_bytes(r.request_id),
                r.request_id,
            )
        )
        return victims

    def _demote_frozen_page(self, require_pressure: bool = False) -> bool:
        """Demote ONE frozen page (best victim's last demotable page) to
        the tier hierarchy.  Nobody stalls — the owner is suspended; the
        page DMAs back when the policy resumes it.  Returns False when
        nothing is demotable."""
        victims = self._frozen_victims(require_pressure)
        if not victims:
            return False
        victim = victims[0]
        rid = victim.request_id
        idx = self.kv.demotable_indices(rid)[-1]
        payload = self._frozen_payloads.get(rid, {}).pop(idx, None)
        if not self.kv.demote_page(rid, idx, payload, float(self.tick)):
            return False
        self.swap_outs += 1
        return True

    def _proactive_demotion(self) -> None:
        """The demotion_pressure mechanism: above ``demote_threshold``
        pool usage, demote cold cached pages and positively-marked
        tenants' frozen KV — *before* the reactive spill path fires.
        FAIR/base mark nobody (pressure 0.0 everywhere), so the stock
        baseline only ever pays the reactive path below."""
        if self.pool.capacity <= 0:
            return
        budget = self.ecfg.demote_batch_pages
        line = self.ecfg.demote_threshold
        plan = self._pressure_plan()
        while budget > 0 and self.pool.used_fraction >= line:
            # walk the plan's proactive order (stock: frozen KV first —
            # it is the class the policy explicitly marked, it stalls
            # nobody, and demoting it leaves the warm prefix cache and
            # its hit rate intact; cold cached pages second, node-
            # preserving: the trie survives as host nodes, promotable
            # on the next match)
            reclaimed = False
            for cls in plan.proactive_order:
                if cls is PageClass.FROZEN:
                    reclaimed = self._demote_frozen_page(
                        require_pressure=True
                    )
                elif cls is PageClass.COLD_CACHED:
                    reclaimed = self._any_demotion_pressure(
                        plan
                    ) and self.kv.demote_cold_page(float(self.tick))
                elif cls is PageClass.SCRATCH:
                    reclaimed = self.kv.evict_scratch(1) > 0
                if reclaimed:
                    break
            if not reclaimed:
                break
            budget -= 1
            self.proactive_demotions += 1
            self._update_pool()

    def _any_demotion_pressure(self, plan: PressurePlan) -> bool:
        """True when the policy marks ANY live tenant for demotion —
        gates cold-page demotion so a pressure-oblivious policy keeps
        stock (evict-on-shortage) cache behaviour."""
        if self.ecfg.legacy_bookkeeping:
            tenants = {r.tenant for r in self._live.values()}
        else:
            tenants = self.kv.ledger.projected_tenants()
        return any(
            plan.score(PageClass.FROZEN, t) > 0.0 for t in tenants
        )

    def _promotion_pass(self) -> None:
        """Start tier→HBM DMAs for pages that are now wanted, inside the
        free-page budget (never promote into overcommit).

        Stalled RUNNING work is handled first, and atomically: a request
        is promoted only when ALL of its demoted pages fit the budget — a
        partial promotion leaves it just as stalled while handing the
        reactive path a fresh page to demote, which is the
        demote/promote ping-pong livelock.  When a stalled request cannot
        be fully restored (and nothing of it is in flight), it stops
        holding a batch row hostage: its remaining pages demote and it
        rejoins through the restore queue once real headroom exists.
        Then requests the policy resumed, then reactive victims coming
        back (both slotless, so partial progress across ticks is fine)."""
        budget = self.kv.free_pages - self.kv.inflight_promotions
        now = float(self.tick)
        for r in list(self._live.values()):
            if r.slot < 0 or r.state not in ("prefill", "decoding"):
                continue
            rid = r.request_id
            demoted = self.kv.demoted_page_count(rid)
            if demoted == 0:
                continue
            if self.kv.pending_transfers(rid):
                continue  # its own DMAs are still in the air: wait
            if 0 < demoted <= budget:
                budget -= self.kv.promote_request(rid, demoted, now)
            else:
                for idx in reversed(self.kv.demotable_indices(rid)):
                    self.kv.demote_page(
                        rid, idx, self._page_payload(r.slot, idx), now
                    )
                self._set_state(r, "offloaded")
                self._release_slot(r)
        wanted: List[str] = []
        for rid in self._restore:
            if self.kv.has_demoted(rid):
                wanted.append(rid)
        for r in self._live.values():
            # reactive victims auto-return once there is headroom: queue
            # them for a batch row (the restore loop is residency-gated,
            # so they wait there until their DMAs land)
            if r.state == "offloaded":
                if r.request_id not in self._restore:
                    self._restore.append(r.request_id)
                if r.request_id not in wanted:
                    wanted.append(r.request_id)
        for rid in wanted:
            if budget <= 0:
                break
            budget -= self.kv.promote_request(rid, budget, float(self.tick))

    def _resolve_overcommit(self) -> None:
        """Restore HBM residency when the page pool is overcommitted.

        One path for every policy (no scheduler branches), each stage
        LOOPED until the overcommit clears or the stage runs dry — a
        single fat victim may not cover the deficit, and leaving overflow
        pages standing stalls decode for a full tick per victim:

          1. reclaim class by class in the pressure plan's order (stock:
             SCRATCH, then cold cached prefixes — both stall nobody and
             free pages an overflow entry can reclaim into — then
             SUSPENDED requests' frozen pages, across however many
             victims it takes: the multi-victim bugfix);
          2. the stock reactive spill: demote the fattest ACTIVE
             request's pages one by one (it stalls on its own non-resident
             pages but keeps its slot cache; with demotion disabled, fail
             it — the paper's OME).
        """

        # a tick where every slot stalled skips the decode-path pool
        # refresh — resolving against that stale snapshot demotes pages
        # that were already freed (the promote/demote flip-flop livelock)
        self._update_pool()

        def hard_over() -> bool:
            return self.kv.overflow_pages > 0 or self.pool.used_fraction > 1.0

        if not hard_over():
            return
        # the watermark is the STOP line, never the trigger: once hard
        # overcommit fired, free down past exactly-full so promotions
        # have budget — but a merely-full pool is left alone (a steady
        # 90–100% working set must not churn through demotion)
        line = (
            self.ecfg.reactive_watermark if self.ecfg.offload_enabled else 1.0
        )

        def over() -> bool:
            return (
                self.kv.overflow_pages > 0
                or self.pool.used_fraction > line
            )

        plan = self._pressure_plan()
        for cls in plan.reclaim_order:
            while over() and self._reclaim_one(cls):
                self.kv.reclaim()
                self._update_pool()
        while over():
            if not self.ecfg.offload_enabled:
                if not hard_over():
                    break
                # no tier below HBM: the stock engine throws — fail the
                # fattest active request (the paper's OME scenario)
                victim = max(
                    self._active(),
                    key=lambda r: self.kv.request_bytes(r.request_id),
                    default=None,
                )
                if victim is None:
                    break
                self._fail(victim)
                continue
            victim = max(
                (
                    r
                    for r in self._active()
                    if self.kv.demotable_indices(r.request_id)
                ),
                key=lambda r: self.kv.request_bytes(r.request_id),
                default=None,
            )
            if victim is None:
                break  # nothing left to demote: overflow must wait
            rid = victim.request_id
            self.reactive_offloads += 1
            victim.offloads += 1
            for idx in reversed(self.kv.demotable_indices(rid)):
                payload = (
                    self._page_payload(victim.slot, idx)
                    if victim.slot >= 0
                    else None
                )
                if not self.kv.demote_page(rid, idx, payload, float(self.tick)):
                    break
                self.kv.reclaim()
                self._update_pool()
                if not over():
                    break
            if not self.kv.demotable_indices(rid):
                # fully demoted: free the batch row for someone resident;
                # the request replays when its pages promote back
                if victim.state in ("decoding", "prefill"):
                    self._set_state(victim, "offloaded")
                self._release_slot(victim)
        self.kv.reclaim()

    def _fail(self, victim: Request) -> None:
        self._set_state(victim, "failed")
        victim.finish_tick = self.tick
        victim.fail_reason = "pool overcommit with offload disabled (OOM)"
        self.failed.append(victim.request_id)
        self._drop_live(victim)
        self.pool.release_owner(victim.request_id)
        self.kv.release(victim.request_id)
        self.sampler.forget(victim.request_id)
        self.policy.drop(victim.request_id)
        self._release_slot(victim)
        self._frozen_payloads.pop(victim.request_id, None)
        self.kv.reclaim()
        self._update_pool()

    def run(self, max_ticks: int = 1000) -> ServeReport:
        """Tick until drained or the budget runs out; returns the typed
        :class:`~repro_torch.serve.report.ServeReport` (the legacy dict payload
        rides in ``report.extras``)."""
        while self.tick < max_ticks:
            if not self.has_pending:
                break
            self.step()
        return self.report()

    def memory_stats(self) -> Dict[str, Any]:
        """The ledger's class-stamped memory breakdown for this replica:
        per-class and per-tier byte totals, per-class peaks, projected
        bytes, the derived host→disk spill, and the
        ``ledger_matches_recount`` self-check (the gate hard bit)."""
        return self.kv.ledger.stats()

    def report(self) -> ServeReport:
        """Build the ServeReport for the run so far (also usable
        mid-flight — unfinished requests show up as such)."""
        lat = [
            r.finish_tick - r.submit_tick
            for r in self.requests.values()
            if r.state == "done"
        ]
        # ttft_ticks and latency_ticks must describe the SAME population
        # (completed requests): a request that emitted a first token and
        # was then shed/failed used to leak into the TTFT percentiles,
        # silently flattering them under shedding.  Failed-request TTFT
        # is reported separately — it is a real signal (work wasted past
        # first token), just not part of the serving-SLO distribution.
        ttft = [
            r.first_token_tick - r.submit_tick
            for r in self.requests.values()
            if r.state == "done" and r.first_token_tick >= 0
        ]
        ttft_failed = [
            r.first_token_tick - r.submit_tick
            for r in self.requests.values()
            if r.state == "failed" and r.first_token_tick >= 0
        ]
        prefix = dict(self.kv.prefix_stats())
        prefix["requests_hit"] = self.prefix_hits
        prefix["prefill_tokens_skipped"] = self.prefix_hit_tokens
        legacy = {
            "policy": self.policy.name,
            "model": self.cfg.name,
            "memory_class": self.spec.memory_class,
            "misroutes": self.misroutes,
            "paged_int8_ticks": self.paged_int8_ticks,
            "completed": len(self.completed),
            "failed": len(self.failed),
            "suspensions": self.suspensions,
            "peak_used_fraction": self.peak_used_fraction,
            "peak_demand_fraction": self.peak_demand_fraction,
            "offload_events": self.reactive_offloads,
            "swap_events": self.swap_outs,
            "proactive_demotions": self.proactive_demotions,
            "tiers": self.kv.tier_stats(),
            "stall_ticks": self.stall_ticks,
            "transfer_stall_ticks": self.transfer_stall_ticks,
            "mean_latency_ticks": sum(lat) / len(lat) if lat else None,
            "latency_ticks": sorted(lat),
            "ttft_ticks": sorted(ttft),
            "ttft_failed_ticks": sorted(ttft_failed),
            "prefix_cache": prefix,
            "ticks": self.tick,
            "tick_cost": self.tick_cost_stats(),
            "chunked_prefill_ticks": self.chunked_prefill_ticks,
            "migrations_in": self.migrations_in,
            "migrations_out": self.migrations_out,
            "tokens_generated": sum(
                len(r.generated) for r in self.requests.values()
            ),
            "memory_models": {
                r.request_id: r.memory_model for r in self.requests.values()
            },
            "memory": self.memory_stats(),
        }
        outcomes: List[RequestOutcome] = []
        for r in self.requests.values():
            if r.state == "done":
                outcomes.append(
                    RequestOutcome(
                        request_id=r.request_id,
                        tenant=r.tenant,
                        outcome=COMPLETED,
                        submit_tick=r.submit_tick,
                        finish_tick=r.finish_tick,
                        first_token_tick=r.first_token_tick,
                        tokens=len(r.generated),
                        model=r.model,
                    )
                )
            elif r.state == "failed":
                outcomes.append(
                    RequestOutcome(
                        request_id=r.request_id,
                        tenant=r.tenant,
                        outcome=FAILED,
                        submit_tick=r.submit_tick,
                        finish_tick=r.finish_tick,
                        first_token_tick=r.first_token_tick,
                        tokens=len(r.generated),
                        reason=r.fail_reason,
                        model=r.model,
                    )
                )
            else:
                outcomes.append(
                    RequestOutcome(
                        request_id=r.request_id,
                        tenant=r.tenant,
                        outcome=UNFINISHED,
                        submit_tick=r.submit_tick,
                        first_token_tick=r.first_token_tick,
                        tokens=len(r.generated),
                        reason=f"still {r.state} at tick budget",
                        model=r.model,
                    )
                )
        rep = ServeReport(
            policy=self.policy.name,
            submitted=self._submitted,
            ticks=self.tick,
            tokens_generated=legacy["tokens_generated"],
            throughput_tokens_per_tick=(
                legacy["tokens_generated"] / max(1, self.tick)
            ),
            outcomes=outcomes,
            tiering=legacy["tiers"],
            prefix=prefix,
            memory=legacy["memory"],
            extras=legacy,
        )
        rep.refresh_summaries()
        rep.apply_slo()  # no SLO at engine level: goodput = completion rate
        return rep
