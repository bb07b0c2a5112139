"""Paged KV-cache manager: page-granular HBM block allocation per request.

The serving engine's memory substrate.  Pages are fixed-size token spans
(``page_tokens``); a request holds ⌈len/page_tokens⌉ pages per layer-group,
drawn from a shared fixed-size HBM pool by :class:`PageBlockAllocator` —
a free list plus a per-request PAGE TABLE.  The same tables feed the CUDA
``paged_decode`` kernel (:mod:`repro_torch.kernels.paged_decode`): the scheduler's
byte accounting and the attention kernel's indirection consume one memory
model, instead of bytes-only bookkeeping on one side and dense caches on
the other.

Pages are REFCOUNTED: more than one page table may point at the same
physical page.  :class:`PrefixCache` exploits this — a token trie at page
granularity maps prompt prefixes onto already-materialized pages, so a
hundred tenants sharing one system prompt pin ONE copy of its KV, not a
hundred.  Writes into a shared page go through copy-on-write
(:meth:`PageBlockAllocator.ensure_private`); cold cached prefixes are
evicted under pressure by LRU crossed with the scheduling policy's
``cache_pressure`` hint (MURS: low-usage-rate tenants' cold prefixes go
first).  Fewer live bytes is the same lever the MURS scheduler pulls —
dedup attacks the pressure at its source (DESIGN.md §6).

The manager tracks the byte-exact HBM footprint of every request — this is
what the MURS sampler reads as the request's *live* bytes, and what decides
spill-to-host and OOM.  A shared page is charged fractionally (1/refcount)
to each holder so the per-owner shares sum to the physical total.  Pages
past pool capacity are OVERFLOW pages (ids ≥ ``n_pages``): the pool is
overcommitted, ``used_fraction`` exceeds 1.0, and the runtime's reactive
path fires.

Below HBM sits the TIER HIERARCHY (:mod:`repro_torch.serve.tiers`): pages demote
INDIVIDUALLY — a private page's entry becomes the :data:`DEMOTED` sentinel
(position preserved) while its bytes move, int8-compressed, over a modeled
PCIe link into a host tier with real capacity, overflowing to a disk tier
whose traffic is the paper's "data spilling" metric.  A request with
demoted pages is simply non-resident (it stalls only if actually
scheduled); promotion is likewise asynchronous and page-granular.  Cold
cached trie pages demote too: the node survives as a HOST node — the
prefix stays known, a later match promotes it back instead of recomputing
the prefill.

Byte model per architecture (the MURS memory-usage classification of
DESIGN.md §4 falls out of these):
    full attention  : 2 · n_kv · hd · bytes  per token per attn layer  (linear)
    MLA             : (kv_lora + rope)·bytes per token per layer       (linear,
                      ~57× shallower slope than per-head KV at dsv2 dims)
    sliding window  : bounded by window  (constant once past the window)
    mamba           : fixed state bytes  (constant)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.serve.ledger import CACHE_OWNER, MemoryLedger, PageClass

if TYPE_CHECKING:  # deferred: keeps this module import-light (numpy only)
    from repro_torch.serve.tiers import TierConfig, TieredKVStore

__all__ = [
    "CACHE_OWNER",  # re-exported from repro_torch.serve.ledger (defined there)
    "DEMOTED",
    "PageBlockAllocator",
    "PagedKVManager",
    "PrefixCache",
    "constant_state_bytes",
    "kv_bytes_per_token",
]

#: page-table sentinel for a page demoted to the tier hierarchy (host or
#: disk): the entry keeps its position — the tokens still exist, just not
#: in HBM — and :meth:`PageBlockAllocator.swap_in` re-materializes it
DEMOTED = -1


def kv_bytes_per_token(cfg: ArchConfig, dtype_bytes: int = 2) -> float:
    """Marginal HBM bytes per generated token (the memory-usage *rate*).

    Thin wrapper over :meth:`ArchConfig.kv_bytes_per_token` — the byte
    model lives on the config so layers that never import serve (cluster
    routing, policy scoring, benchmarks) read the same numbers."""
    return cfg.kv_bytes_per_token(dtype_bytes)


def constant_state_bytes(cfg: ArchConfig, dtype_bytes: int = 2) -> float:
    """Sequence-length-independent state (mamba states, local windows).

    Thin wrapper over :meth:`ArchConfig.constant_state_bytes`."""
    return cfg.constant_state_bytes(dtype_bytes)


class PageBlockAllocator:
    """Fixed-size HBM page pool: free list + refcounted per-owner tables.

    ``n_pages`` physical pages exist; allocation pops the free list (lowest
    id first on a fresh pool, then LIFO reuse for locality).  A page may be
    held by MULTIPLE owners (prefix sharing): :meth:`share` bumps its
    refcount, and the page returns to the free list only when the last
    holder releases it.  :meth:`ensure_private` is the copy-on-write
    primitive — an owner about to append into a shared page gets a private
    replacement; the shared page is never mutated.

    When the free list is empty, allocation hands out OVERFLOW page ids
    (≥ ``n_pages``) — the pool is overcommitted; callers detect this via
    :attr:`overflow_pages` / byte accounting and react (offload, fail,
    evict cached prefixes, or — under a proactive policy — never get here).
    Overflow pages are never shared: only HBM-resident pages are cacheable.
    """

    def __init__(
        self, n_pages: int, ledger: Optional[MemoryLedger] = None
    ) -> None:
        if n_pages < 0:
            raise ValueError(f"n_pages must be >= 0, got {n_pages}")
        self.n_pages = n_pages
        #: class-stamped byte ledger (single writer of byte tallies);
        #: every holder-set mutation below fans out through :meth:`_note`
        self.ledger = ledger
        if ledger is not None:
            ledger.attach_allocator(self)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._free_overflow: List[int] = []  # recycled overflow ids
        self._tables: Dict[str, List[int]] = {}
        self._ref: Dict[int, int] = {}  # page id → number of holders
        #: page id → owners holding it (reverse of the tables, DEMOTED
        #: entries excluded) — a refcount change on a SHARED page changes
        #: every co-holder's fractional share, so attribution updates
        #: must fan out to all of them
        self._holders: Dict[int, List[str]] = {}
        #: owners whose attributed share (:meth:`owner_share`) changed
        #: since the last :meth:`drain_dirty` — the engine's incremental
        #: pool-accounting sync reads and clears this instead of
        #: recomputing every live owner per tick
        self.dirty: set = set()
        self._next_overflow = n_pages
        self.overflow_pages = 0  # overflow pages currently held
        self.cow_events = 0  # copy-on-write page splits

    def drain_dirty(self) -> set:
        """Return-and-clear the owners whose page set changed since the
        last drain (the pool-sync dirty set)."""
        out = self.dirty
        self.dirty = set()
        return out

    def _note(self, pid: int) -> None:
        """Propagate a holder-set change on ``pid`` into the ledger (the
        ledger re-derives the page's class and fractional attribution)."""
        if self.ledger is not None:
            self.ledger.page_update(pid, self._holders.get(pid, ()))

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Distinct pages currently held (a shared page counts once)."""
        return len(self._ref)

    @property
    def page_id_bound(self) -> int:
        """Exclusive upper bound on every page id ever handed out — size
        pool-indexed arrays (k/v pools) with this, not
        ``n_pages + overflow_pages`` (overflow ids are recycled, but the
        high-water mark can exceed the current count)."""
        return self._next_overflow

    def table(self, owner: str) -> Tuple[int, ...]:
        return tuple(self._tables.get(owner, ()))

    def pages_held(self, owner: str) -> int:
        return len(self._tables.get(owner, ()))

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def owner_share(self, owner: str) -> float:
        """Fractionally attributed page count: a page shared by k holders
        charges 1/k to each, so shares sum to the physical page count.
        Demoted entries charge nothing — those bytes live in a lower
        tier, not in this pool."""
        return sum(
            1.0 / self._ref[pid]
            for pid in self._tables.get(owner, ())
            if pid != DEMOTED
        )

    def table_array(
        self, owners: Sequence[str], max_pages: Optional[int] = None
    ) -> np.ndarray:
        """Kernel-ready page tables: int32 ``[len(owners), max_pages]``.

        Rows are padded with page 0 — the paged_decode kernel masks tokens
        past ``seq_lens``, so padding entries cost a wasted DMA, never a
        wrong value.
        """
        tables = [self._tables.get(o, []) for o in owners]
        width = max_pages or max((len(t) for t in tables), default=1) or 1
        out = np.zeros((len(owners), width), np.int32)
        for i, t in enumerate(tables):
            if len(t) > width:
                raise ValueError(
                    f"owner {owners[i]!r} holds {len(t)} pages > max_pages={width}"
                )
            # demoted entries render as page 0 like padding: the kernel
            # must never be launched over a non-resident table (the engine
            # stalls such requests), so the value is a mask-safe filler
            out[i, : len(t)] = [max(pid, 0) for pid in t]
        return out

    # ---------------------------------------------------------- allocation
    def _alloc_page(self, owner: str) -> int:
        if self._free:
            pid = self._free.pop()
        elif self._free_overflow:
            pid = self._free_overflow.pop()
            self.overflow_pages += 1
        else:
            pid = self._next_overflow
            self._next_overflow += 1
            self.overflow_pages += 1
        self._ref[pid] = 1
        self._holders[pid] = [owner]
        self.dirty.add(owner)
        self._note(pid)
        return pid

    def _decref(self, pid: int, owner: str) -> bool:
        """Drop ``owner``'s reference; returns True iff the page became
        free.  Remaining co-holders' fractional shares grow, so they are
        marked dirty too."""
        holders = self._holders.get(pid)
        if holders is not None:
            try:
                holders.remove(owner)
            except ValueError:
                pass
        self.dirty.add(owner)
        n = self._ref[pid] - 1
        if n > 0:
            self._ref[pid] = n
            if holders:
                self.dirty.update(holders)
            self._note(pid)
            return False
        del self._ref[pid]
        self._holders.pop(pid, None)
        if pid < self.n_pages:
            self._free.append(pid)
        else:
            self._free_overflow.append(pid)
            self.overflow_pages -= 1
        self._note(pid)
        return True

    def grow_to(self, owner: str, n_pages_needed: int) -> int:
        """Extend ``owner``'s table to ``n_pages_needed``; returns #new pages."""
        table = self._tables.setdefault(owner, [])
        new = n_pages_needed - len(table)
        if new <= 0:
            return 0
        for _ in range(new):
            table.append(self._alloc_page(owner))
        return new

    def share(self, owner: str, pages: Sequence[int]) -> None:
        """Append existing live pages to ``owner``'s table (refcount +1 each).

        This is the prefix-sharing primitive: the pages stay owned by every
        current holder; ``owner`` must treat them as read-only until
        :meth:`ensure_private` splits them.
        """
        table = self._tables.setdefault(owner, [])
        for pid in pages:
            if pid not in self._ref:
                raise ValueError(f"page {pid} is not live; cannot share")
            if pid >= self.n_pages:
                raise ValueError(f"overflow page {pid} cannot be shared")
            self._ref[pid] += 1
            holders = self._holders.setdefault(pid, [])
            self.dirty.update(holders)  # their 1/k share just shrank
            holders.append(owner)
            self.dirty.add(owner)
            table.append(pid)
            self._note(pid)

    def ensure_private(self, owner: str, index: int) -> int:
        """Copy-on-write: make ``owner``'s page at table ``index`` private.

        If the page is shared (refcount > 1) the owner receives a freshly
        allocated replacement (the copy) and drops its reference to the
        shared original — which is NEVER mutated.  Returns the (possibly
        new) page id.
        """
        table = self._tables[owner]
        pid = table[index]
        if self._ref.get(pid, 0) <= 1:
            return pid
        new = self._alloc_page(owner)
        table[index] = new
        self._ref[pid] -= 1
        holders = self._holders.get(pid)
        if holders is not None:
            try:
                holders.remove(owner)
            except ValueError:
                pass
            self.dirty.update(holders)  # co-holders' shares grew
        self._note(pid)
        self.cow_events += 1
        return new

    def free(self, owner: str) -> int:
        """Release every page reference ``owner`` holds; returns the count
        of HBM table entries released (shared pages stay live for others;
        demoted entries hold no HBM page — the caller must discard their
        tier copies)."""
        table = self._tables.pop(owner, [])
        released = 0
        for pid in table:
            if pid == DEMOTED:
                continue
            self._decref(pid, owner)
            released += 1
        return released

    # ------------------------------------------------------------- demotion
    def swap_out(self, owner: str, index: int) -> int:
        """Demote ``owner``'s page at table ``index`` out of HBM: the
        physical page returns to the free list and the entry becomes the
        :data:`DEMOTED` sentinel (position preserved).  Only PRIVATE
        (refcount 1) physical pages are demotable — a shared page is
        pinned by its other holders, and an overflow id is the legacy
        overcommit representation, not a resident page.  Returns the
        freed page id."""
        table = self._tables[owner]
        pid = table[index]
        if pid == DEMOTED:
            raise ValueError(f"page {owner!r}[{index}] is already demoted")
        if pid >= self.n_pages:
            raise ValueError(f"overflow page {pid} cannot be demoted")
        if self._ref.get(pid, 0) != 1:
            raise ValueError(f"shared page {pid} cannot be demoted")
        self._decref(pid, owner)
        table[index] = DEMOTED
        return pid

    def swap_in(self, owner: str, index: int) -> int:
        """Re-materialize a demoted entry: allocates a page (overflow id
        under a drained pool — the normal overcommit machinery then
        applies) and writes it back into the table slot."""
        table = self._tables[owner]
        if table[index] != DEMOTED:
            raise ValueError(f"page {owner!r}[{index}] is not demoted")
        pid = self._alloc_page(owner)
        table[index] = pid
        return pid

    def demoted_indices(self, owner: str) -> Tuple[int, ...]:
        return tuple(
            i
            for i, pid in enumerate(self._tables.get(owner, ()))
            if pid == DEMOTED
        )

    def take_free(self, owner: str) -> Optional[int]:
        """Append one FREE-LIST page to ``owner``'s table, or None when
        the free list is empty (never hands out overflow ids) — the
        promotion path for cache-held pages, which must be physical."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._ref[pid] = 1
        self._holders[pid] = [owner]
        self.dirty.add(owner)
        self._tables.setdefault(owner, []).append(pid)
        self._note(pid)
        return pid

    def release_pages(self, owner: str, pages: Sequence[int]) -> None:
        """Release specific page references from ``owner``'s table (one
        table entry per listed id) — the prefix cache's eviction path."""
        table = self._tables.get(owner, [])
        for pid in pages:
            table.remove(pid)
            self._decref(pid, owner)

    # ------------------------------------------------------------ residency
    def resident(self, owner: str) -> bool:
        """True iff every page of ``owner`` is a physical HBM page.

        A request holding overflow pages (legacy overcommit) or DEMOTED
        entries (tiered out to host/disk) cannot be decoded — those
        tokens are not in HBM — until :meth:`reclaim` / :meth:`swap_in`
        bring them back.
        """
        return all(
            0 <= pid < self.n_pages for pid in self._tables.get(owner, ())
        )

    def reclaim(self) -> int:
        """Page overflow entries back into freed physical pages (the DMA
        that resolves overcommit); returns the number of pages moved."""
        moved = 0
        for owner, table in self._tables.items():
            for i, pid in enumerate(table):
                if pid >= self.n_pages and self._free:
                    # overflow pages are never shared → refcount is 1
                    self._free_overflow.append(pid)
                    del self._ref[pid]
                    self._holders.pop(pid, None)
                    self._note(pid)
                    new = self._free.pop()
                    self._ref[new] = 1
                    self._holders[new] = [owner]
                    self.dirty.add(owner)
                    table[i] = new
                    self._note(new)
                    self.overflow_pages -= 1
                    moved += 1
        return moved


@dataclass
class _PrefixNode:
    """One cached page: the trie node for a (page-aligned) token prefix."""

    page_id: int
    n_tokens: int  # valid tokens in this page (< page_tokens ⇒ terminal)
    group: str  # tenant that materialized it (cache_pressure key)
    snap_key: Tuple[int, ...]  # engine-side KV snapshot this page came from
    last_use: float
    #: True when the page was demoted to the tier hierarchy: the node
    #: survives (the prefix is still KNOWN) but holds no HBM page
    #: (``page_id`` is :data:`DEMOTED`); a match stops at it and triggers
    #: promotion instead of sharing
    host: bool = False


class PrefixCache:
    """Token trie over the page pool: prompt prefix → shared pages.

    Nodes live at page-granular depths — the node for ``tokens[:d·P]``
    records the physical page holding tokens ``[(d−1)·P, d·P)`` of that
    prefix.  A cached prompt's final PARTIAL page is stored as a terminal
    node keyed by the full prompt, so an exact-prompt repeat shares every
    page (its first append then triggers copy-on-write).  The cache holds
    one allocator reference per node (owner :data:`CACHE_OWNER`); a node
    whose page refcount is 1 is COLD — no live request uses it — and is
    the only kind eviction may touch.

    Eviction order is LRU crossed with the scheduling policy's
    ``cache_pressure(group)`` hint: highest pressure first, then least
    recently used, deepest leaf first; inner nodes are never evicted
    before their descendants (the trie stays connected).
    """

    def __init__(self, alloc: PageBlockAllocator, page_tokens: int) -> None:
        self.alloc = alloc
        self.page_tokens = page_tokens
        self._nodes: Dict[Tuple[int, ...], _PrefixNode] = {}
        self._children: Dict[Tuple[int, ...], int] = {}  # key → child nodes
        # parent full-page key → terminal (partial-page) keys beneath it
        self._terminals: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}
        #: called with a node key when a match walks into a HOST node —
        #: the manager promotes the page so the NEXT match can share it
        self.promote_cb: Optional[Callable[[Tuple[int, ...]], None]] = None
        #: called with a node key when a host node's tier copy becomes
        #: garbage (re-adopted by a fresh prefill, or dropped)
        self.on_host_drop: Optional[Callable[[Tuple[int, ...]], None]] = None
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.shared_pages_acquired = 0
        self.insertions = 0
        self.evictions = 0

    # ------------------------------------------------------------- queries
    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    @property
    def evictable_pages(self) -> int:
        """Pages eviction could free by cascading leaf-first: COLD nodes
        (refcount 1) with no warm descendant.  A single ``evict`` step
        only takes leaves, but evicting a leaf exposes its parent — this
        counts the whole reclaimable chain, which is what "reclaimable
        bytes" means for the demand metric."""
        blocked = set()
        for key, node in self._nodes.items():
            # warm (request-shared) nodes pin their chain; HOST nodes do
            # not — eviction may drop them to reach the ancestors
            if not node.host and self.alloc.refcount(node.page_id) != 1:
                k = key
                while k:
                    blocked.add(k)
                    k = self._parent(k)
        return sum(
            1
            for key, node in self._nodes.items()
            if key not in blocked and not node.host
        )

    def live_snap_keys(self) -> set:
        return {node.snap_key for node in self._nodes.values()}

    def _parent(self, key: Tuple[int, ...]) -> Tuple[int, ...]:
        return key[: ((len(key) - 1) // self.page_tokens) * self.page_tokens]

    def _evictable(self, key: Tuple[int, ...]) -> bool:
        if self._children.get(key, 0) > 0:
            return False  # inner node: descendants would be orphaned
        if self._nodes[key].host:
            return False  # no HBM page to free; lives in the tier store
        return self.alloc.refcount(self._nodes[key].page_id) == 1

    # --------------------------------------------------------------- match
    def _walk(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        """Longest chain of cached nodes covering a prefix of ``tokens``."""
        toks = tuple(tokens)
        keys: List[Tuple[int, ...]] = []
        d = self.page_tokens
        while d <= len(toks):
            key = toks[:d]
            if key not in self._nodes:
                break
            keys.append(key)
            d += self.page_tokens
        base = keys[-1] if keys else ()
        best: Optional[Tuple[int, ...]] = None
        for term in self._terminals.get(base, ()):
            if len(term) <= len(toks) and toks[: len(term)] == term:
                if best is None or len(term) > len(best):
                    best = term
        if best is not None:
            keys.append(best)
        return keys

    def probe(
        self, tokens: Sequence[int]
    ) -> Tuple[int, Optional[Tuple[int, ...]], Tuple[int, ...]]:
        """(matched token count, snapshot key, matched page ids) without
        acquiring pages — the admission arithmetic, plus the page set an
        admission-time eviction must not victimize (the pages it is about
        to count as free-to-share).  The walk stops at the first HOST
        node: a demoted page cannot be shared until it is promoted."""
        keys = self._hbm_chain(self._walk(tokens))
        if not keys:
            return 0, None, ()
        pages = tuple(self._nodes[k].page_id for k in keys)
        return len(keys[-1]), self._nodes[keys[-1]].snap_key, pages

    def _hbm_chain(
        self, keys: List[Tuple[int, ...]]
    ) -> List[Tuple[int, ...]]:
        """Truncate a walk chain at the first non-HBM (host) node."""
        out: List[Tuple[int, ...]] = []
        for k in keys:
            if self._nodes[k].host:
                break
            out.append(k)
        return out

    def peek(self, tokens: Sequence[int]) -> Tuple[int, Optional[Tuple[int, ...]]]:
        """(matched token count, snapshot key) without acquiring pages."""
        matched, snap_key, _ = self.probe(tokens)
        return matched, snap_key

    def match(
        self,
        owner: str,
        tokens: Sequence[int],
        now: float = 0.0,
        count_stats: bool = True,
    ) -> Tuple[int, Optional[Tuple[int, ...]]]:
        """Longest-prefix match that ACQUIRES the cached pages for ``owner``
        (refcount +1 each, appended to its page table, LRU refreshed).
        Returns (matched token count, snapshot key).

        ``count_stats=False`` keeps the hit/dedup counters untouched — an
        offload-reload re-matching the request's OWN published prefix is
        a real page re-share but not evidence of cross-request sharing,
        and must not satisfy the benchmark's hit-rate acceptance bit."""
        if count_stats:
            self.lookups += 1
            self.lookup_tokens += len(tokens)
        walked = self._walk(tokens)
        keys = self._hbm_chain(walked)
        if len(keys) < len(walked) and self.promote_cb is not None:
            # the match ran into a demoted page: promote it so the next
            # identical prompt (a few ticks from now) shares the full
            # chain — page-granular, asynchronous re-warming
            self.promote_cb(walked[len(keys)])
        if not keys:
            return 0, None
        pages = [self._nodes[k].page_id for k in keys]
        self.alloc.share(owner, pages)
        for k in keys:
            self._nodes[k].last_use = now
        matched = len(keys[-1])
        if count_stats:
            self.hits += 1
            self.hit_tokens += matched
            self.shared_pages_acquired += len(pages)
        return matched, self._nodes[keys[-1]].snap_key

    # -------------------------------------------------------------- insert
    def insert(
        self,
        owner_table: Sequence[int],
        tokens: Sequence[int],
        group: str,
        snap_key: Tuple[int, ...],
        now: float = 0.0,
    ) -> int:
        """Record ``tokens``'s pages (from a finished prefill) in the trie.

        Full pages first, then the trailing partial page as a terminal
        node.  Pages already cached (by an identical earlier prompt) are
        skipped; overflow (host-resident) pages are never cached.  Returns
        the number of nodes inserted.
        """
        toks = tuple(tokens)
        P = self.page_tokens
        inserted = 0
        full = len(toks) // P
        for d in range(1, full + 1):
            key = toks[: d * P]
            if key in self._nodes:
                self._nodes[key].last_use = now
                self._readopt(key, owner_table, d - 1)
                continue
            parent = toks[: (d - 1) * P]
            if parent and parent not in self._nodes:
                break  # keep the trie connected
            if d - 1 >= len(owner_table):
                break
            pid = owner_table[d - 1]
            if pid >= self.alloc.n_pages or pid < 0:
                break  # never cache overflow or demoted entries
            self.alloc.share(CACHE_OWNER, [pid])
            self._nodes[key] = _PrefixNode(pid, P, group, snap_key, now)
            self._children[parent] = self._children.get(parent, 0) + 1
            inserted += 1
        rem = len(toks) % P
        if rem:
            key = toks
            parent = toks[: full * P]
            if key in self._nodes:
                self._nodes[key].last_use = now
                self._readopt(key, owner_table, full)
            elif (
                (full == 0 or parent in self._nodes)
                and full < len(owner_table)
                and 0 <= owner_table[full] < self.alloc.n_pages
            ):
                self.alloc.share(CACHE_OWNER, [owner_table[full]])
                self._nodes[key] = _PrefixNode(
                    owner_table[full], rem, group, snap_key, now
                )
                self._children[parent] = self._children.get(parent, 0) + 1
                self._terminals.setdefault(parent, []).append(key)
                inserted += 1
        if inserted:
            self.insertions += 1
        return inserted

    def _readopt(
        self, key: Tuple[int, ...], owner_table: Sequence[int], index: int
    ) -> None:
        """A fresh prefill re-materialized a prefix whose node had been
        demoted: the node adopts the new HBM page and the tier copy is
        dropped (it would otherwise be a second resident copy)."""
        node = self._nodes[key]
        if not node.host or index >= len(owner_table):
            return
        pid = owner_table[index]
        if not (0 <= pid < self.alloc.n_pages):
            return
        self.alloc.share(CACHE_OWNER, [pid])
        node.page_id = pid
        node.host = False
        if self.on_host_drop is not None:
            self.on_host_drop(key)

    # ------------------------------------------------------------- demotion
    def demote_node(self, key: Tuple[int, ...]) -> int:
        """Mark a COLD node as tier-resident: releases the cache's HBM
        page (the node's position in the trie survives, so the prefix is
        still matchable-after-promotion) and returns the freed page id.
        The caller moves the bytes into the tier store."""
        node = self._nodes[key]
        if node.host:
            raise ValueError(f"node {key!r} is already demoted")
        pid = node.page_id
        if self.alloc.refcount(pid) != 1:
            raise ValueError(f"page {pid} is warm (shared); only cold pages demote")
        node.page_id = DEMOTED
        node.host = True
        self.alloc.release_pages(CACHE_OWNER, [pid])
        return pid

    def demotable_victim(
        self, pressure: Optional[Callable[[str], float]] = None
    ) -> Optional[Tuple[int, ...]]:
        """The node cold-page demotion should move next (policy pressure
        × LRU, deepest first).  Unlike eviction there is NO leaf-first
        constraint: demotion keeps the node, so the trie stays connected
        whatever order pages leave HBM — a chain of host nodes re-warms
        progressively as matches promote it front to back."""
        best_key, best_rank = None, None
        for key, node in self._nodes.items():
            if node.host or self.alloc.refcount(node.page_id) != 1:
                continue
            p = float(pressure(node.group)) if pressure is not None else 0.0
            rank = (-p, node.last_use, -len(key))
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        return best_key

    def promote_node(self, key: Tuple[int, ...]) -> bool:
        """A tier promotion completed: give the node a fresh physical
        page.  When the free list cannot supply one, a LEAF node is
        dropped (a later identical prompt just re-prefills) — an INNER
        host node must stay: removing it would orphan its still-cached
        descendants, so it simply remains host and the next match
        retries the promotion.  Returns True when the node is
        HBM-backed again."""
        node = self._nodes.get(key)
        if node is None or not node.host:
            return False
        pid = self.alloc.take_free(CACHE_OWNER)
        if pid is None:
            if self._children.get(key, 0) == 0:
                self._remove_node(key, release_page=False)
            return False
        node.page_id = pid
        node.host = False
        return True

    # ------------------------------------------------------------ eviction
    def evict(
        self,
        n_pages: int,
        pressure: Optional[Callable[[str], float]] = None,
        protect: Sequence[int] = (),
    ) -> int:
        """Evict up to ``n_pages`` COLD cached pages; returns #evicted.

        Victim order: highest ``pressure(group)`` first (the policy's
        hint — MURS returns high pressure for low-usage-rate tenants),
        then least-recently-used, then deepest leaf.  Pages referenced by
        any live request (refcount > 1), inner nodes, and ``protect``-ed
        page ids (pages an in-flight admission probe just counted as
        free-to-share) are untouchable.
        """
        freed = 0
        protected = frozenset(protect)
        while freed < n_pages:
            victim = self._pick_victim(pressure, protected)
            if victim is None:
                break
            if self._nodes[victim].host:
                # dropping a host leaf frees no HBM page, but it unblocks
                # the HBM ancestors above it — without this, a demoted
                # terminal pins its whole chain against eviction forever
                self._remove_node(victim, release_page=False)
            else:
                self._evict_node(victim)
                freed += 1
        return freed

    def _pick_victim(
        self,
        pressure: Optional[Callable[[str], float]],
        protected: frozenset = frozenset(),
    ) -> Optional[Tuple[int, ...]]:
        """Best eviction victim: HBM cold leaves first (they actually free
        pages); host leaves only as a last resort (they merely unblock
        their ancestors)."""
        best_key, best_rank = None, None
        for key, node in self._nodes.items():
            if node.host:
                if self._children.get(key, 0) > 0:
                    continue  # host inner node: still anchors descendants
            elif node.page_id in protected or not self._evictable(key):
                continue
            p = float(pressure(node.group)) if pressure is not None else 0.0
            rank = (node.host, -p, node.last_use, -len(key))
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        return best_key

    def evict_node_for_page(self, pid: int) -> bool:
        """Drop the (leaf) node holding ``pid`` regardless of its warmth —
        the copy-on-write ownership transfer: when a writer needs the page
        private and the cache is the only other holder, releasing the
        cache's reference makes the page private IN PLACE, with no
        allocation at all.  Returns True if a node was dropped."""
        for key, node in self._nodes.items():
            if node.page_id == pid and self._children.get(key, 0) == 0:
                self._evict_node(key)
                return True
        return False

    def _evict_node(self, key: Tuple[int, ...]) -> None:
        self._remove_node(key, release_page=True)

    def _remove_node(self, key: Tuple[int, ...], release_page: bool) -> None:
        """Unlink a (leaf) node from the trie.  ``release_page=False`` is
        the host-node variant: there is no HBM page to release, but any
        tier copy must be dropped via ``on_host_drop``."""
        node = self._nodes.pop(key)
        parent = self._parent(key)
        remaining = self._children.get(parent, 1) - 1
        if remaining > 0:
            self._children[parent] = remaining
        else:
            # zero-count entries must go: their keys are full token tuples
            # and a long-lived engine churns through unboundedly many
            self._children.pop(parent, None)
        if node.n_tokens < self.page_tokens:
            terms = self._terminals.get(parent)
            if terms and key in terms:
                terms.remove(key)
                if not terms:
                    del self._terminals[parent]
        if release_page:
            self.alloc.release_pages(CACHE_OWNER, [node.page_id])
        elif self.on_host_drop is not None:
            self.on_host_drop(key)
        self.evictions += 1


@dataclass
class PagedKVManager:
    """Byte accounting + page-table allocation for a shared HBM region.

    The page pool is sized lazily on the first :meth:`register` (the page
    byte size depends on the architecture): ``n_pages = ⌊capacity /
    page_bytes⌋``.  Architectures with zero marginal KV bytes (mamba:
    constant state) hold no pages at all.  One pool can host MIXED page
    owners — requests registered under different :class:`ArchConfig`\\ s
    keep their own per-page byte geometry for attribution
    (:meth:`request_bytes`, :meth:`page_bytes_of`), while prefix-trie
    sharing stays restricted to the arch that sized the pool
    (:attr:`pool_arch`): token ids alone do not identify KV values
    across architectures.

    With ``enable_prefix_cache`` a :class:`PrefixCache` trie is attached:
    :meth:`match_prefix` / :meth:`insert_prefix` are the serving engine's
    admission hooks, and page shortage triggers cold-prefix eviction
    ordered by ``cache_pressure_fn`` (the active scheduling policy's
    hint) before the allocator falls back to overflow ids.
    """

    capacity_bytes: float
    page_tokens: int = 16
    enable_prefix_cache: bool = False
    cache_pressure_fn: Optional[Callable[[str], float]] = None
    #: tier hierarchy below HBM (host + disk); None → demotion disabled
    tier_config: Optional["TierConfig"] = None
    #: the single writer of byte tallies (DESIGN.md §13) — created here
    #: when not injected, and shared with the allocator and tier store so
    #: every byte the pool tracks carries a ``(tenant, class, tier)`` stamp
    ledger: Optional[MemoryLedger] = None
    #: owners registered as SCRATCH (speculative-decoding draft pages):
    #: eviction prefers their pages over every other class
    _scratch: set = field(default_factory=set)
    _page_bytes: Dict[str, float] = field(default_factory=dict)
    _state_bytes: Dict[str, float] = field(default_factory=dict)
    #: request id → arch name it registered under — one pool can host
    #: MIXED page owners (a model-zoo engine), each with its own
    #: per-page byte geometry; the prefix trie stays single-arch (token
    #: ids alone do not identify KV values across architectures)
    _arch: Dict[str, str] = field(default_factory=dict)
    _alloc: Optional[PageBlockAllocator] = None
    _prefix: Optional[PrefixCache] = None
    _pool_page_bytes: float = 0.0
    #: arch whose geometry sized the physical pool (first nonzero
    #: registrant); only its requests may share trie pages
    _pool_arch: Optional[str] = None
    tiers: Optional["TieredKVStore"] = None
    #: request ids whose attributed bytes changed outside the allocator
    #: (constant-state registration); merged into :meth:`drain_dirty`
    _dirty: set = field(default_factory=set)
    #: per-request, per-table-index WRITE EPOCHS — the delta-migration
    #: ledger (DESIGN.md §11).  The engine stamps every cache-write site
    #: (prefill install, chunked scan, decode append, payload install)
    #: with its tick; a drain pre-copy records the epoch it snapshotted
    #: at, and :meth:`pages_written_since` answers which pages the
    #: cutover must re-ship.  Distinct from the owner-level ``_dirty``
    #: set above, which tracks BYTE-ATTRIBUTION changes for the pool
    #: accounting, not page content.
    _write_epoch: Dict[str, Dict[int, int]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.ledger is None:
            self.ledger = MemoryLedger()
        if self.tier_config is not None:
            from repro_torch.serve.tiers import TieredKVStore

            self.tiers = TieredKVStore(self.tier_config, ledger=self.ledger)

    # ------------------------------------------------------------ requests
    def page_bytes_for(self, cfg: ArchConfig) -> float:
        """One page's HBM bytes under ``cfg``'s geometry — THE page-size
        arithmetic; :meth:`register` and :meth:`admission_probe` both use
        it, so the pool and per-request paths cannot diverge."""
        return kv_bytes_per_token(cfg) * self.page_tokens

    def register(
        self,
        request_id: str,
        cfg: ArchConfig,
        prompt_tokens: int = 0,
        tenant: str = "",
    ) -> None:
        """Start tracking a request: derive its per-page bytes from the
        arch config and create the allocator on first use.

        Requests of DIFFERENT architectures may register into one pool
        (mixed page owners): each keeps its own per-page byte geometry
        for attribution (:meth:`request_bytes`), while physical page
        count is sized once, by the first nonzero-KV registrant.

        ``prompt_tokens`` adds the encoder-side cross-attention KV an
        encoder-decoder model pins for this prompt (zero elsewhere) into
        the request's fixed state bytes — it is written once at prefill
        and never grows with decode, so it rides with the constant-state
        term rather than the paged per-token term."""
        page_bytes = self.page_bytes_for(cfg)
        self._page_bytes[request_id] = page_bytes
        self._state_bytes[request_id] = constant_state_bytes(
            cfg
        ) + cfg.encoder_bytes(prompt_tokens)
        self._arch[request_id] = cfg.name
        self._dirty.add(request_id)
        self.ledger.register_owner(
            request_id,
            tenant=tenant,
            kind="request",
            page_bytes=page_bytes,
            state_bytes=self._state_bytes[request_id],
        )
        if self._alloc is None and page_bytes > 0:
            self._alloc = PageBlockAllocator(
                int(self.capacity_bytes // page_bytes), ledger=self.ledger
            )
            self._pool_page_bytes = page_bytes
            self._pool_arch = cfg.name
            self.ledger.register_owner(
                CACHE_OWNER, kind="cache", page_bytes=page_bytes
            )
            if self.enable_prefix_cache:
                self._prefix = PrefixCache(self._alloc, self.page_tokens)
                self._prefix.promote_cb = self._promote_cache_node
                self._prefix.on_host_drop = self._drop_cache_tier_copy
        if self._alloc is not None and page_bytes > 0:
            self._alloc.grow_to(request_id, 0)  # materialize an empty table

    @property
    def pool_arch(self) -> Optional[str]:
        """Arch name whose page geometry sized the pool (None before the
        first nonzero-KV registration)."""
        return self._pool_arch

    def page_bytes_of(self, request_id: str) -> float:
        """The request's own per-page byte size (its model's geometry —
        NOT necessarily the pool's)."""
        return self._page_bytes.get(request_id, 0.0)

    def _prefix_eligible(self, request_id: str) -> bool:
        """Prefix pages are only shareable within the pool's arch: the
        trie is keyed by token ids alone, and identical tokens under
        different architectures hold different KV values."""
        return (
            self._pool_arch is None
            or self._arch.get(request_id, self._pool_arch) == self._pool_arch
        )

    def grow_to(self, request_id: str, n_tokens: int) -> float:
        """Ensure pages cover ``n_tokens``; returns newly allocated bytes.

        When the free list cannot cover the growth, cold cached prefixes
        are evicted first (policy-ordered) — overflow ids are the last
        resort, not the first response to a warm cache.
        """
        page_bytes = self._page_bytes.get(request_id, 0.0)
        if page_bytes <= 0.0 or self._alloc is None:
            return 0.0
        need = (n_tokens + self.page_tokens - 1) // self.page_tokens
        new = need - self._alloc.pages_held(request_id)
        if new > 0 and self._prefix is not None:
            short = new - self._alloc.free_pages
            if short > 0:
                self._prefix.evict(short, self.cache_pressure_fn)
        return self._alloc.grow_to(request_id, need) * page_bytes

    def bytes_for(self, cfg: ArchConfig, n_tokens: int) -> float:
        """Page-rounded HBM bytes ``n_tokens`` would occupy — an
        arithmetic admission probe that allocates nothing."""
        pages = (n_tokens + self.page_tokens - 1) // self.page_tokens
        return pages * self.page_bytes_for(cfg)

    def admission_probe(
        self, cfg: ArchConfig, tokens: Sequence[int]
    ) -> Tuple[float, Tuple[int, ...]]:
        """Admission arithmetic net of prefix-cache hits: (bytes the NEW
        pages for ``tokens`` would occupy, the matched page ids).  The
        caller must pass the page ids as ``protect`` to any eviction it
        runs before acquiring the match — otherwise the eviction can
        victimize exactly the cold pages this probe just counted as
        free-to-share, and the later allocation overshoots the line that
        was checked."""
        total = (len(tokens) + self.page_tokens - 1) // self.page_tokens
        page_bytes = self.page_bytes_for(cfg)
        if self._prefix is None or (
            self._pool_arch is not None and cfg.name != self._pool_arch
        ):
            return total * page_bytes, ()
        matched, _, pages = self._prefix.probe(tokens)
        new = max(total - len(pages), 0)
        if pages and matched % self.page_tokens:
            # the match ends in a shared PARTIAL page: the request's first
            # append into it copy-on-writes onto a fresh page — count that
            # page now or admission admits one page more than it checked
            new += 1
        return new * page_bytes, pages

    def release(self, request_id: str) -> float:
        """Free every page the request owns (tier copies included);
        returns the bytes returned to the pool."""
        pages = 0
        if self._alloc is not None:
            if self.tiers is not None:
                # drop tier copies of demoted pages — their owner is gone
                for idx in self._alloc.demoted_indices(request_id):
                    self.tiers.discard(("req", request_id, idx))
            pages = self._alloc.free(request_id)
        pb = self._page_bytes.pop(request_id, 0.0)
        sb = self._state_bytes.pop(request_id, 0.0)
        self._dirty.add(request_id)
        self._write_epoch.pop(request_id, None)
        self.ledger.release_owner(request_id)
        return pages * pb + sb

    def set_frozen(self, request_id: str, frozen: bool) -> None:
        """Stamp a request suspended (or resumed): its sole-held pages
        restamp ``PRIVATE_SUFFIX`` ⇄ ``FROZEN`` in the ledger — frozen
        bytes are the proactive-demotion pass's primary target."""
        self.ledger.set_frozen(request_id, frozen)

    # ------------------------------------------------------------- scratch
    def register_scratch(
        self, owner: str, n_pages: int, tenant: str = ""
    ) -> int:
        """Allocate ``n_pages`` SCRATCH-class pages under ``owner`` (the
        speculative-decoding draft-page hook): eviction prefers scratch
        over every other class.  Returns the number of pages allocated
        (0 when the pool has not been sized yet)."""
        if self._alloc is None or self._pool_page_bytes <= 0:
            return 0
        if owner not in self._scratch:
            self.ledger.register_owner(
                owner,
                tenant=tenant,
                kind="scratch",
                page_bytes=self._pool_page_bytes,
            )
            self._scratch.add(owner)
        self._dirty.add(owner)
        return self._alloc.grow_to(
            owner, self._alloc.pages_held(owner) + n_pages
        )

    def evict_scratch(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` scratch pages (newest first per owner)
        — the cheapest reclaim there is: scratch holds draft state that
        is free to regenerate.  Returns the number of pages freed."""
        if self._alloc is None:
            return 0
        freed = 0
        for owner in list(self._scratch):
            while freed < n_pages:
                table = self._alloc.table(owner)
                live = [pid for pid in table if pid >= 0]
                if not live:
                    break
                self._alloc.release_pages(owner, [live[-1]])
                freed += 1
            if freed >= n_pages:
                break
        return freed

    def release_scratch(self, owner: str) -> int:
        """Free every page of a scratch owner and retire it from the
        ledger; returns the number of pages released."""
        self._scratch.discard(owner)
        pages = self._alloc.free(owner) if self._alloc is not None else 0
        self.ledger.release_owner(owner)
        self._dirty.add(owner)
        return pages

    @property
    def scratch_bytes(self) -> float:
        """HBM bytes currently held by the SCRATCH class."""
        return self.ledger.class_bytes(PageClass.SCRATCH)

    def drain_dirty(self) -> set:
        """Owners whose attributed bytes may have changed since the last
        drain (registration, release, and every allocator refcount event
        — including co-holders of shared pages)."""
        out = self._dirty
        self._dirty = set()
        if self._alloc is not None:
            out |= self._alloc.drain_dirty()
        return out

    # ------------------------------------------------------ write epochs
    def note_write(
        self, request_id: str, start_tok: int, end_tok: int, epoch: int
    ) -> None:
        """Stamp the pages covering tokens ``[start_tok, end_tok)`` as
        written at ``epoch`` (the engine tick).  Every engine cache-write
        site calls this; the delta-migration cutover ships only pages
        whose stamp is newer than the pre-copy's epoch."""
        if end_tok <= start_tok:
            return
        ledger = self._write_epoch.setdefault(request_id, {})
        first = start_tok // self.page_tokens
        last = (end_tok - 1) // self.page_tokens
        for idx in range(first, last + 1):
            ledger[idx] = epoch

    def note_page_write(
        self, request_id: str, page_index: int, epoch: int
    ) -> None:
        """Stamp one table index as written at ``epoch`` (payload
        installs land whole pages, not token spans)."""
        self._write_epoch.setdefault(request_id, {})[page_index] = epoch

    def pages_written_since(self, request_id: str, epoch: int) -> set:
        """Table indices written STRICTLY AFTER ``epoch`` — the dirty
        delta between a pre-copy snapshot taken at ``epoch`` and now.
        Pages never stamped (e.g. installed before the ledger existed)
        are conservatively treated as dirty by the caller, not here."""
        ledger = self._write_epoch.get(request_id, {})
        return {idx for idx, e in ledger.items() if e > epoch}

    def write_epochs(self, request_id: str) -> Dict[int, int]:
        """The request's full write-epoch ledger (copy)."""
        return dict(self._write_epoch.get(request_id, {}))

    # ----------------------------------------------------- tier transitions
    def demote_page(
        self,
        request_id: str,
        index: int,
        payload: Optional[np.ndarray] = None,
        now: float = 0.0,
    ) -> bool:
        """Demote ONE private HBM page of ``request_id`` into the tier
        hierarchy (async: the page leaves HBM now, lands in host DRAM
        when the PCIe transfer completes).  Returns False when the page
        is not demotable (shared, overflow, already demoted, no tiers)."""
        if self.tiers is None or self._alloc is None:
            return False
        table = self._alloc.table(request_id)
        if index >= len(table):
            return False
        pid = table[index]
        if pid == DEMOTED or pid >= self._alloc.n_pages:
            return False
        if self._alloc.refcount(pid) != 1:
            return False  # shared with the trie/another request: pinned
        self._alloc.swap_out(request_id, index)
        self.tiers.demote(
            ("req", request_id, index),
            self._page_bytes.get(request_id, self._pool_page_bytes),
            payload,
            now,
        )
        return True

    def demotable_indices(self, request_id: str) -> Tuple[int, ...]:
        """Table indices demote_page would accept (private HBM pages)."""
        if self._alloc is None:
            return ()
        return tuple(
            i
            for i, pid in enumerate(self._alloc.table(request_id))
            if 0 <= pid < self._alloc.n_pages
            and self._alloc.refcount(pid) == 1
        )

    def shared_page_indices(self, request_id: str) -> set:
        """Table indices backed by SHARED physical pages (refcount > 1:
        cached prefixes and co-held prompt pages) — the long-lived
        lifetime class of DESIGN.md §6, and therefore the pages a KV
        checkpoint persists first (§11): they outlive any one request
        and shield the most replay work per byte."""
        if self._alloc is None:
            return set()
        return {
            i
            for i, pid in enumerate(self._alloc.table(request_id))
            if pid >= 0
            and self.ledger.page_class(pid) is PageClass.SHARED_PREFIX
        }

    def has_demoted(self, request_id: str) -> bool:
        """True if any of the request's pages live below HBM."""
        if self._alloc is None:
            return False
        return bool(self._alloc.demoted_indices(request_id))

    def demoted_page_count(self, request_id: str) -> int:
        """Number of the request's pages currently demoted to a tier."""
        if self._alloc is None:
            return 0
        return len(self._alloc.demoted_indices(request_id))

    def pending_transfers(self, request_id: str) -> bool:
        """True while any of the request's pages are ON THE LINK (demotion
        not yet landed in host, or promotion not yet landed in HBM)."""
        if self.tiers is None or self._alloc is None:
            return False
        return any(
            self.tiers.location(("req", request_id, idx))
            in ("to_host", "to_hbm")
            for idx in self._alloc.demoted_indices(request_id)
        )

    def promote_request(self, request_id: str, max_pages: int, now: float = 0.0) -> int:
        """Begin promoting up to ``max_pages`` of the request's demoted
        pages (those already landed in host/disk; in-flight demotions
        must finish first).  Returns the number of promotions started."""
        if self.tiers is None or self._alloc is None or max_pages <= 0:
            return 0
        started = 0
        for idx in self._alloc.demoted_indices(request_id):
            key = ("req", request_id, idx)
            if self.tiers.location(key) in ("host", "disk"):
                if self.tiers.promote(key, now):
                    started += 1
                    if started >= max_pages:
                        break
        return started

    def extract_demoted(self, request_id: str) -> Dict[int, object]:
        """Pull the compressed tier blocks of the request's DEMOTED pages
        out of the hierarchy (live-migration extraction): ``{table index →
        CompressedBlock}``.  Each block leaves host/disk for good — any
        in-flight transfer cancels — and the caller owns the bytes; the
        table entries stay :data:`DEMOTED`, so the caller must
        :meth:`release` the request afterwards (the migration source) or
        re-materialize the pages itself (there is no third option: an
        extracted page has no copy left on this replica)."""
        out: Dict[int, object] = {}
        if self.tiers is None or self._alloc is None:
            return out
        for idx in self._alloc.demoted_indices(request_id):
            block = self.tiers.extract(("req", request_id, idx))
            if block is not None:
                out[idx] = block
        return out

    def demote_cold_page(self, now: float = 0.0) -> bool:
        """Demote one COLD cached trie page (policy-ordered victim) into
        the tier hierarchy.  Unlike eviction the prefix stays KNOWN: the
        node survives as a host node, a later match promotes it back."""
        if self.tiers is None or self._prefix is None:
            return False
        victim = self._prefix.demotable_victim(self.cache_pressure_fn)
        if victim is None:
            return False
        self._prefix.demote_node(victim)
        self.tiers.demote(("cache", victim), self._pool_page_bytes, None, now)
        return True

    def _promote_cache_node(self, key: Tuple[int, ...]) -> None:
        if self.tiers is not None:
            self.tiers.promote(("cache", key))

    def _drop_cache_tier_copy(self, key: Tuple[int, ...]) -> None:
        if self.tiers is not None:
            self.tiers.discard(("cache", key))

    def tick_tiers(
        self, now: float = 0.0
    ) -> List[Tuple[str, int, Optional[np.ndarray]]]:
        """Advance the tier hierarchy one tick.  Completed request-page
        promotions are swapped back into their tables (overflow ids under
        a drained pool — the normal overcommit machinery applies) and
        returned as ``(request_id, page_index, dequantized_payload)`` so
        the engine can restore the page's KV values; completed cache-node
        promotions re-attach their trie nodes internally."""
        if self.tiers is None:
            return []
        restored: List[Tuple[str, int, Optional[np.ndarray]]] = []
        for kind, key, payload in self.tiers.tick(now):
            if kind != "resident":
                continue
            if key[0] == "req":
                _, rid, idx = key
                if (
                    rid in self._page_bytes
                    and self._alloc is not None
                    and idx < len(self._alloc.table(rid))
                    and self._alloc.table(rid)[idx] == DEMOTED
                ):
                    self._alloc.swap_in(rid, idx)
                    restored.append((rid, idx, payload))
            elif key[0] == "cache" and self._prefix is not None:
                if not self._prefix.promote_node(key[1]):
                    # the DMA landed but no free page could back it; if
                    # the node survived (an inner host node — dropping
                    # it would orphan descendants), park the bytes back
                    # in the hierarchy so a later match can retry —
                    # otherwise the node would be host with NO tier copy
                    node = self._prefix._nodes.get(key[1])
                    if node is not None and node.host:
                        self.tiers.demote(
                            key, self._pool_page_bytes, None, now,
                            repark=True,
                        )
        return restored

    @property
    def inflight_promotions(self) -> int:
        return self.tiers.inflight_promotions if self.tiers is not None else 0

    def tier_stats(self) -> Dict[str, float]:
        """Tier-hierarchy counters for the report (empty-shape when
        tiering is disabled)."""
        if self.tiers is None:
            return {"enabled": False}
        stats: Dict[str, float] = {"enabled": True}
        stats.update(self.tiers.stats())
        return stats

    # -------------------------------------------------------- prefix cache
    def peek_prefix(
        self, tokens: Sequence[int]
    ) -> Tuple[int, Optional[Tuple[int, ...]]]:
        """(matched token count, snapshot key) — no pages acquired."""
        if self._prefix is None:
            return 0, None
        return self._prefix.peek(tokens)

    def match_prefix(
        self,
        request_id: str,
        tokens: Sequence[int],
        now: float = 0.0,
        count_stats: bool = True,
    ) -> Tuple[int, Optional[Tuple[int, ...]]]:
        """Acquire the longest cached prefix of ``tokens`` for
        ``request_id`` (its page table must be empty).  Returns (matched
        token count, snapshot key).  ``count_stats=False`` for replays —
        re-sharing your own published prefix is not a cache hit."""
        if self._prefix is None or self._alloc is None:
            return 0, None
        if not self._prefix_eligible(request_id):
            return 0, None
        if self._alloc.pages_held(request_id) > 0:
            raise ValueError(
                f"match_prefix needs an empty table for {request_id!r}"
            )
        return self._prefix.match(request_id, tokens, now, count_stats)

    def insert_prefix(
        self,
        request_id: str,
        tokens: Sequence[int],
        group: str,
        snap_key: Tuple[int, ...],
        now: float = 0.0,
    ) -> int:
        """Publish a finished prefill's pages into the trie; returns the
        number of newly cached pages.  Off-pool-arch requests publish
        nothing (their KV is not shareable under the pool's trie)."""
        if self._prefix is None or self._alloc is None:
            return 0
        if not self._prefix_eligible(request_id):
            return 0
        return self._prefix.insert(
            self._alloc.table(request_id), tokens, group, snap_key, now
        )

    def make_private(self, request_id: str, page_index: int) -> None:
        """Copy-on-write guard: call before writing tokens into the page at
        ``page_index`` of the request's table.  No-op for private pages.

        Like :meth:`grow_to`, a COW under a drained free list sheds cache
        before handing out overflow ids: first by OWNERSHIP TRANSFER —
        if the cache is the only other holder of the page, dropping its
        node makes the page private in place with no allocation — then by
        evicting some other cold page to back the copy."""
        if self._alloc is None:
            return
        if page_index >= self._alloc.pages_held(request_id):
            return
        pid = self._alloc.table(request_id)[page_index]
        if (
            self._alloc.refcount(pid) > 1
            and self._alloc.free_pages == 0
            and self._prefix is not None
        ):
            if (
                self._alloc.refcount(pid) == 2
                and self._prefix.evict_node_for_page(pid)
                and self._alloc.refcount(pid) <= 1
            ):
                return  # transferred: already private, nothing to copy
            self._prefix.evict(1, self.cache_pressure_fn, protect=(pid,))
        self._alloc.ensure_private(request_id, page_index)

    def evict_cache(self, n_pages: int, protect: Sequence[int] = ()) -> int:
        """Evict up to ``n_pages`` cold cached pages (policy-ordered);
        ``protect`` shields pages an admission probe just counted."""
        if self._prefix is None:
            return 0
        return self._prefix.evict(n_pages, self.cache_pressure_fn, protect)

    def live_snap_keys(self) -> set:
        return self._prefix.live_snap_keys() if self._prefix else set()

    @property
    def evictable_cache_pages(self) -> int:
        return self._prefix.evictable_pages if self._prefix else 0

    @property
    def reclaimable_bytes(self) -> float:
        """Bytes one eviction call away from being free — the ledger's
        ``COLD_CACHED`` + ``SCRATCH`` HBM totals (cold cached pages are
        held by the cache alone; scratch is droppable by definition) —
        the OS page-cache notion of "available".  Pool demand = used −
        reclaimable."""
        return self.ledger.class_bytes(
            PageClass.COLD_CACHED
        ) + self.ledger.class_bytes(PageClass.SCRATCH)

    @property
    def cache_bytes(self) -> float:
        """Pool bytes attributed to the prefix cache (its fractional share
        of the pages it holds — a page also held by a request is mostly
        charged to the request).  A ledger owner query."""
        return self.ledger.owner_bytes(CACHE_OWNER)

    @property
    def cow_events(self) -> int:
        return self._alloc.cow_events if self._alloc is not None else 0

    @property
    def cache_evictions(self) -> int:
        return self._prefix.evictions if self._prefix is not None else 0

    def prefix_stats(self) -> Dict[str, float]:
        """Machine-readable prefix-cache trajectory for BENCH_serve.json."""
        p = self._prefix
        if p is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "lookups": p.lookups,
            "hits": p.hits,
            "hit_rate": p.hits / p.lookups if p.lookups else 0.0,
            "hit_tokens": p.hit_tokens,
            "lookup_tokens": p.lookup_tokens,
            "token_hit_rate": (
                p.hit_tokens / p.lookup_tokens if p.lookup_tokens else 0.0
            ),
            "shared_pages_acquired": p.shared_pages_acquired,
            "dedup_bytes": p.shared_pages_acquired * self._pool_page_bytes,
            "cached_pages": p.cached_pages,
            "insertions": p.insertions,
            "evictions": p.evictions,
            "cow_events": self.cow_events,
        }

    # ------------------------------------------------------------- queries
    def page_table(self, request_id: str) -> Tuple[int, ...]:
        """The request's page table — the paged_decode kernel's indirection."""
        if self._alloc is None:
            return ()
        return self._alloc.table(request_id)

    def table_array(
        self, request_ids: Sequence[str], max_pages: Optional[int] = None
    ) -> np.ndarray:
        """Kernel-ready ``[B, max_pages]`` int32 page tables (padded)."""
        if self._alloc is None:
            return np.zeros((len(request_ids), max_pages or 1), np.int32)
        return self._alloc.table_array(request_ids, max_pages)

    def gather_plan(
        self, request_ids: Sequence[str], slots: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Export one decode batch for the paged kernel: width-trimmed
        page tables plus pool-page PROVENANCE — which batch slot's dense
        cache holds each referenced pool page, and at which logical page
        index inside that slot.

        ``request_ids`` and ``slots`` are parallel; callers sort rows by
        sequence length (longest first) so the returned width trims the
        kernel's page grid to the longest resident request.  Returns
        ``(tables, src_slot, src_idx, n_pool)``:

        * ``tables``  int32 ``[B, W]`` — W is the smallest power of two
          covering the longest request's table (bounded compile cache);
        * ``src_slot``/``src_idx`` int32 ``[n_pool]`` — provenance of
          every referenced page id (unreferenced ids stay 0: the kernel
          masks them via ``seq_lens``, so they are never read);
        * ``n_pool`` — power-of-two exclusive bound on referenced ids.

        A shared (prefix) page may be owned by several rows; any owner's
        slot cache holds identical values for it, so last-writer-wins
        provenance is safe.  Raises ``ValueError`` when a request holds
        demoted pages — those tokens are not in HBM and the caller must
        keep the request off the kernel path.
        """
        rows = [self.page_table(rid) for rid in request_ids]
        if any(pid < 0 for row in rows for pid in row):
            raise ValueError(
                "gather_plan: request holds demoted (non-HBM) pages"
            )
        max_pages = max((len(row) for row in rows), default=0)
        width = 1 << max(max_pages - 1, 0).bit_length()
        tables = self.table_array(request_ids, max(width, 1))
        bound = max((pid for row in rows for pid in row), default=0) + 1
        n_pool = 1 << max(bound - 1, 0).bit_length()
        src_slot = np.zeros(max(n_pool, 1), np.int32)
        src_idx = np.zeros(max(n_pool, 1), np.int32)
        for row, slot in zip(rows, slots):
            for j, pid in enumerate(row):
                src_slot[pid] = slot
                src_idx[pid] = j
        return tables, src_slot, src_idx, max(n_pool, 1)

    def request_pages(self, request_id: str) -> int:
        return self._alloc.pages_held(request_id) if self._alloc else 0

    def resident(self, request_id: str) -> bool:
        """True iff the request's KV is fully HBM-resident (decodable)."""
        return self._alloc.resident(request_id) if self._alloc else True

    def reclaim(self) -> int:
        """Page overflow entries back in; returns pages moved.  Cold cached
        prefixes are evicted first when they are what stands between an
        overflow page and residency."""
        if self._alloc is None:
            return 0
        if self._prefix is not None:
            short = self._alloc.overflow_pages - self._alloc.free_pages
            if short > 0:
                self._prefix.evict(short, self.cache_pressure_fn)
        return self._alloc.reclaim()

    def request_bytes(self, request_id: str) -> float:
        """The request's attributed HBM bytes (shared pages fractionally,
        plus its fixed state) — a ledger owner query."""
        return self.ledger.owner_bytes(request_id)

    @property
    def n_pages(self) -> int:
        """Physical pages in the pool (0 until the first register sizes it)."""
        return self._alloc.n_pages if self._alloc is not None else 0

    @property
    def free_pages(self) -> int:
        return self._alloc.free_pages if self._alloc is not None else 0

    @property
    def overflow_pages(self) -> int:
        return self._alloc.overflow_pages if self._alloc is not None else 0

    @property
    def page_id_bound(self) -> int:
        """Exclusive upper bound on every page id ever handed out."""
        return self._alloc.page_id_bound if self._alloc is not None else 0

    @property
    def used_bytes(self) -> float:
        """Physical bytes held: the ledger's total HBM-resident bytes —
        per-owner fractional shares sum to the physical total, so a page
        shared k ways is counted exactly once."""
        return self.ledger.hbm_bytes()

    @property
    def used_fraction(self) -> float:
        """Pool occupancy.  A zero-capacity pool (constant-state / mamba
        deployments hold no KV pages at all) with nothing in it is EMPTY
        (0.0), not full — reporting 1.0 made every ``> threshold`` check
        fire permanently for a pool that cannot hold anything; a
        zero-capacity pool that somehow holds bytes is saturated (1.0)."""
        if self.capacity_bytes:
            return self.used_bytes / self.capacity_bytes
        return 0.0 if not self.used_bytes else 1.0
