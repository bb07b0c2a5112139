"""Tiered KV hierarchy below HBM: compressed host tier + disk-spill tier.

The serving engine's memory below the page pool used to be free and
boolean — "offload" released a request's whole page table and replayed
the prompt, with no host capacity, no transfer cost, and no disk.  This
module is the missing hierarchy, modeled the way the MURS paper treats
the space below the heap (its "data spilling" is our disk-tier traffic):

    HBM (page pool)  ──demote──▶  host DRAM  ──LRU evict──▶  disk
         ▲                           │
         └────────promote────────────┘ (disk reads pay the slow link)

Three pieces:

* **int8 page compression** — demoted pages are stored quantized through
  :func:`repro_torch.dist.compression.quantize` / ``dequantize`` (symmetric
  per-tensor int8, error ≤ scale/2).  Byte accounting follows the same
  model everywhere: a page of ``raw_bytes`` (2-byte elements) stores and
  *moves* as ``raw_bytes/2 + 4`` bytes — compression directly halves the
  PCIe ticks a transfer occupies.  When the caller hands a real payload
  (the engine extracts the page's token span from its slot cache), the
  actual int8 codes are kept and the dequantized array is returned on
  promotion, so the lossy round-trip is real, not notional.

* **a PCIe bandwidth model** — one FIFO link; each transfer drains at its
  tier's rate (``pcie_bytes_per_tick`` for host, the slower
  ``disk_bytes_per_tick`` for disk reads).  Demotion frees the HBM page
  immediately (the bytes are in flight); promotion lands only when the
  transfer completes — the tick gap is the engine's transfer stall.

* **a disk third tier** — host DRAM has *capacity*; when a completing
  demotion would overflow it, cold host entries spill to disk (LRU).
  ``disk_spill_bytes`` is the paper's spill metric: traffic that fell out
  of both fast tiers.  Disk writes are buffered (cost bytes, not link
  time); disk reads pay the slow link on promotion.

Invariants (pinned by the hypothesis property test in
``tests/test_tiers.py``):

* a page is in exactly ONE place: HBM (untracked), in flight, host, or
  disk — never two tiers at once;
* raw bytes are conserved across demotion, host→disk eviction, and
  promotion (a block's ``raw_bytes`` never changes while tracked);
* a demoted page is never readable (``touch`` False) until a
  ``("resident", key, payload)`` promotion event has been emitted.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.dist.compression import dequantize, quantize
from repro_torch.serve.ledger import MemoryLedger

__all__ = [
    "TierConfig",
    "CompressedBlock",
    "PcieLink",
    "TieredKVStore",
    "wire_bytes_for",
]

#: location states of a tracked block (untracked ⇒ resident in HBM)
TO_HOST = "to_host"
HOST = "host"
DISK = "disk"
TO_HBM = "to_hbm"

#: f32 scale riding along with each quantized block (wire + at-rest)
_SCALE_BYTES = 4.0
#: int8 codes are half the bytes of the 2-byte-element page model
_INT8_RATIO = 0.5


def wire_bytes_for(raw_bytes: float, n_pages: int, compress: bool) -> float:
    """Wire/at-rest size of ``n_pages`` pages totalling ``raw_bytes``
    under the tier compression model — the byte arithmetic every link in
    the system (PCIe demotion, inter-replica migration) shares, so
    "compression halves the transfer" means the same thing everywhere."""
    if not compress or raw_bytes <= 0.0:
        return max(raw_bytes, 0.0)
    return raw_bytes * _INT8_RATIO + _SCALE_BYTES * max(n_pages, 1)


@dataclass(frozen=True)
class TierConfig:
    """Capacities and link rates of the hierarchy below HBM."""

    #: host-DRAM budget for demoted pages (bytes AT REST, i.e. compressed)
    host_capacity_bytes: float
    #: HBM↔host link rate; a transfer of n bytes occupies n/rate ticks
    pcie_bytes_per_tick: float = float("inf")
    #: disk→host read rate (slower; disk writes are buffered and free)
    disk_bytes_per_tick: float = float("inf")
    #: int8-compress demoted pages (off ⇒ raw bytes move and rest)
    compress: bool = True

    def __post_init__(self) -> None:
        if self.host_capacity_bytes < 0:
            raise ValueError("host_capacity_bytes must be >= 0")
        if self.pcie_bytes_per_tick <= 0 or self.disk_bytes_per_tick <= 0:
            raise ValueError("link rates must be > 0 bytes/tick")


@dataclass
class CompressedBlock:
    """One demoted page at rest: int8 codes + scale, or raw when
    compression is off.  ``raw_bytes`` is the page's HBM (byte-model)
    size and never changes while the block lives — the conservation
    invariant of the tier hierarchy."""

    raw_bytes: float
    stored_bytes: float
    codes: Optional[np.ndarray] = None  # int8 payload (when one was given)
    scale: float = 0.0
    quant_error: float = 0.0  # max |payload − dequantized| of this block
    last_use: float = 0.0

    @classmethod
    def compress(
        cls, raw_bytes: float, payload: Optional[np.ndarray], compress: bool
    ) -> "CompressedBlock":
        """Build a block: int8-quantize the payload when ``compress``
        (recording the measured round-trip error), else store raw."""
        if not compress:
            return cls(raw_bytes=raw_bytes, stored_bytes=raw_bytes)
        stored = raw_bytes * _INT8_RATIO + _SCALE_BYTES
        if payload is None:
            return cls(raw_bytes=raw_bytes, stored_bytes=stored)
        q, scale = quantize(payload)
        deq = np.asarray(dequantize(q, scale))
        err = float(np.max(np.abs(payload - deq))) if payload.size else 0.0
        return cls(
            raw_bytes=raw_bytes,
            stored_bytes=stored,
            codes=np.asarray(q),
            scale=float(scale),
            quant_error=err,
        )

    def decompress(self) -> Optional[np.ndarray]:
        """Dequantized payload, or None for a byte-count-only block."""
        if self.codes is None:
            return None
        return np.asarray(dequantize(self.codes, self.scale))


@dataclass
class _Transfer:
    key: Hashable
    kind: str  # "demote" | "promote"
    nbytes: float
    rate: float
    remaining: float


class PcieLink:
    """One FIFO channel: transfers queue and drain in order, each at its
    own rate (host transfers at PCIe speed, disk reads slower).  A tick
    is one unit of time; the front transfer drains first and any leftover
    time flows to the next — so a half-page transfer does not round up to
    a whole tick."""

    def __init__(self) -> None:
        self._queue: List[_Transfer] = []
        self.completed_transfers = 0
        self.moved_bytes = 0.0

    @property
    def queued_bytes(self) -> float:
        return sum(t.remaining for t in self._queue)

    @property
    def in_flight(self) -> int:
        return len(self._queue)

    def submit(self, tr: _Transfer) -> None:
        self._queue.append(tr)

    def send(
        self, key: Hashable, nbytes: float, rate: float,
        kind: str = "migrate",
    ) -> None:
        """Queue a transfer of ``nbytes`` at ``rate`` — the convenience
        entry for callers outside the tier store (e.g. a serving
        cluster's inter-replica network reusing this link model)."""
        self.submit(
            _Transfer(
                key=key, kind=kind, nbytes=nbytes, rate=rate,
                remaining=nbytes,
            )
        )

    def cancel(self, key: Hashable) -> Optional[_Transfer]:
        """Pull a queued transfer off the link (e.g. its owner died);
        returns it, or None if not queued."""
        for i, tr in enumerate(self._queue):
            if tr.key == key:
                return self._queue.pop(i)
        return None

    def tick(self) -> List[_Transfer]:
        """Advance one tick of link time; returns completed transfers."""
        done: List[_Transfer] = []
        t = 1.0
        while self._queue and t > 1e-12:
            tr = self._queue[0]
            if math.isinf(tr.rate):
                # infinite link rate = instantaneous transfer; the naive
                # arithmetic below would produce dt·rate = 0·inf = NaN
                # and wedge the transfer in flight forever
                tr.remaining = 0.0
            else:
                need = tr.remaining / tr.rate
                dt = min(t, need)
                tr.remaining -= dt * tr.rate
                t -= dt
            if tr.remaining <= 1e-9:
                self._queue.pop(0)
                self.completed_transfers += 1
                self.moved_bytes += tr.nbytes
                done.append(tr)
        return done


class TieredKVStore:
    """Demotion/promotion orchestrator over host + disk with one link.

    Keys are opaque hashables (the KV manager uses ``("req", rid, idx)``
    for request pages and ``("cache", token_key)`` for cold trie pages).
    A key the store does not track is, by definition, HBM-resident.
    """

    def __init__(
        self, config: TierConfig, ledger: Optional[MemoryLedger] = None
    ) -> None:
        self.config = config
        self.link = PcieLink()
        #: the class-stamped byte ledger — the single writer of resident
        #: byte tallies (``host_used_bytes`` and ``disk_spill_bytes`` are
        #: ledger queries below); a standalone store owns a private one
        self.ledger = ledger if ledger is not None else MemoryLedger()
        self.ledger.attach_tiers(self)
        self._blocks: Dict[Hashable, CompressedBlock] = {}
        self._state: Dict[Hashable, str] = {}
        # ---- cumulative traffic counters (the spill metrics)
        self.spilled_bytes = 0.0  # raw bytes demoted out of HBM
        self.wire_bytes = 0.0  # compressed bytes submitted to the link
        self.disk_read_bytes = 0.0  # disk→HBM promotions (stored bytes)
        self.demotions = 0
        self.promotions = 0
        self.discards = 0
        self.extractions = 0  # blocks handed to a migration (not garbage)
        self.max_quant_error = 0.0
        self.host_peak_bytes = 0.0  # high-water mark of host occupancy
        # ---- checkpoint traffic (DESIGN.md §11: a third byte stream,
        # distinct from spill and migration — durable snapshot writes
        # through the disk tier's buffered write path)
        self.checkpoint_bytes = 0.0  # compressed snapshot bytes written
        self.checkpoint_raw_bytes = 0.0  # pre-compression page bytes
        self.checkpoints = 0

    # ------------------------------------------------------------- queries
    def location(self, key: Hashable) -> str:
        """One of "hbm" / "to_host" / "host" / "disk" / "to_hbm"."""
        return self._state.get(key, "hbm")

    def tracked(self, key: Hashable) -> bool:
        return key in self._state

    def touch(self, key: Hashable) -> bool:
        """Read attempt: True iff the page is HBM-resident.  A tracked
        (demoted) page is unreadable until its promotion event fires."""
        return key not in self._state

    @property
    def host_used_bytes(self) -> float:
        """Stored bytes at rest in the host tier — a ledger query."""
        return self.ledger.tier_bytes(HOST)

    @property
    def disk_spill_bytes(self) -> float:
        """Host→disk eviction traffic (stored bytes) — the paper's spill
        metric, DERIVED from the ledger's host→disk flow rather than
        counted separately."""
        return self.ledger.flow(HOST, DISK)

    @property
    def tracked_raw_bytes(self) -> float:
        return sum(b.raw_bytes for b in self._blocks.values())

    @property
    def inflight_promotions(self) -> int:
        return sum(1 for s in self._state.values() if s == TO_HBM)

    @property
    def compression_ratio(self) -> float:
        """Raw bytes per stored/wire byte (≈2 for int8 over 2-byte KV)."""
        return self.spilled_bytes / self.wire_bytes if self.wire_bytes else 1.0

    def keys_in(self, *states: str) -> List[Hashable]:
        return [k for k, s in self._state.items() if s in states]

    # ----------------------------------------------------------- transitions
    def demote(
        self,
        key: Hashable,
        raw_bytes: float,
        payload: Optional[np.ndarray] = None,
        now: float = 0.0,
        repark: bool = False,
    ) -> None:
        """Begin moving an HBM page to the host tier.  The HBM copy is
        gone the moment this is called (the caller frees the physical
        page); the bytes are in flight until the link delivers them.

        ``repark=True`` marks a BOUNCE-BACK: a promotion that landed but
        could not be re-attached (no free page) returning to the host
        tier.  The page never became HBM-resident, so it is link traffic
        (``wire_bytes``) but NOT new spill — counting it as
        ``spilled_bytes`` would inflate a gated metric by a page per
        round trip under sustained free-page scarcity."""
        if key in self._state:
            raise ValueError(f"page {key!r} is already demoted ({self._state[key]})")
        block = CompressedBlock.compress(raw_bytes, payload, self.config.compress)
        block.last_use = now
        self.max_quant_error = max(self.max_quant_error, block.quant_error)
        self._blocks[key] = block
        self._state[key] = TO_HOST
        self.ledger.tier_demote(key, raw_bytes, block.stored_bytes)
        self.wire_bytes += block.stored_bytes
        if not repark:
            self.spilled_bytes += raw_bytes
            self.demotions += 1
        self.link.submit(
            _Transfer(
                key=key,
                kind="demote",
                nbytes=block.stored_bytes,
                rate=self.config.pcie_bytes_per_tick,
                remaining=block.stored_bytes,
            )
        )

    def promote(self, key: Hashable, now: float = 0.0) -> bool:
        """Begin moving a host/disk page back to HBM; returns False when
        the page is not promotable yet (still in flight, or unknown)."""
        state = self._state.get(key)
        if state not in (HOST, DISK):
            return False
        block = self._blocks[key]
        block.last_use = now
        rate = self.config.pcie_bytes_per_tick
        if state == DISK:
            self.disk_read_bytes += block.stored_bytes
            rate = min(rate, self.config.disk_bytes_per_tick)
        self._state[key] = TO_HBM
        self.ledger.tier_move(key, TO_HBM)
        self.promotions += 1
        self.link.submit(
            _Transfer(
                key=key,
                kind="promote",
                nbytes=block.stored_bytes,
                rate=rate,
                remaining=block.stored_bytes,
            )
        )
        return True

    def discard(self, key: Hashable) -> None:
        """Forget a tracked page (its owner finished): cancels any
        in-flight transfer and drops the host/disk copy."""
        if key not in self._state:
            return
        self.link.cancel(key)
        del self._state[key]
        del self._blocks[key]
        self.ledger.tier_drop(key)
        self.discards += 1

    def extract(self, key: Hashable) -> Optional[CompressedBlock]:
        """Remove a tracked block and hand its compressed payload to the
        caller — the live-migration extraction.  Unlike :meth:`discard`
        the bytes are NOT garbage: the caller ships them to another
        replica, so they leave this hierarchy intact (any in-flight
        transfer is cancelled; the block's codes ride along)."""
        if key not in self._state:
            return None
        self.link.cancel(key)
        del self._state[key]
        block = self._blocks.pop(key)
        self.ledger.tier_drop(key)
        self.extractions += 1
        return block

    # ---------------------------------------------------------------- clock
    def tick(self, now: float = 0.0) -> List[Tuple[str, Hashable, Any]]:
        """Advance one tick of link time.  Returns events:

        ``("resident", key, payload)`` — a promotion completed; the page
        is HBM-resident again and ``payload`` is the dequantized array
        (None when the demotion carried no payload).  Host arrivals that
        overflow host capacity cascade to disk here (LRU), which is where
        ``disk_spill_bytes`` accrues.
        """
        events: List[Tuple[str, Hashable, Any]] = []
        for tr in self.link.tick():
            if tr.key not in self._state:
                continue  # discarded while in flight (defensive)
            if tr.kind == "demote":
                self._state[tr.key] = HOST
                self._blocks[tr.key].last_use = now
                # ledger first: the overflow cascade below reads the
                # host tier's occupancy through it
                self.ledger.tier_move(tr.key, HOST)
                self._spill_host_overflow(tr.key)
                # sampled AFTER the overflow cascade: the high-water mark
                # must never claim the host tier held more than it can
                self.host_peak_bytes = max(
                    self.host_peak_bytes, self.host_used_bytes
                )
            else:
                block = self._blocks.pop(tr.key)
                del self._state[tr.key]
                self.ledger.tier_drop(tr.key)
                events.append(("resident", tr.key, block.decompress()))
        return events

    def _spill_host_overflow(self, arriving: Hashable) -> None:
        """Evict LRU host entries to disk until the host tier fits its
        capacity again.  The arriving block is the last resort victim
        (a host tier smaller than one block sends it straight to disk)."""
        while self.host_used_bytes > self.config.host_capacity_bytes:
            victims = [
                k
                for k, s in self._state.items()
                if s == HOST and k != arriving
            ]
            if not victims:
                victims = [arriving] if self._state.get(arriving) == HOST else []
            if not victims:
                break
            victim = min(victims, key=lambda k: self._blocks[k].last_use)
            self._state[victim] = DISK
            # the ledger's host→disk flow IS the spill metric
            self.ledger.tier_move(victim, DISK)
            if victim == arriving:
                break

    # ----------------------------------------------------------- checkpoints
    def note_checkpoint(self, raw_bytes: float, stored_bytes: float) -> None:
        """Account one KV snapshot written through the disk tier.

        Checkpoint writes ride the buffered disk-write path (cost bytes,
        not link time — same model as host→disk eviction), but they are a
        SEPARATE byte stream from spill: spill is pages falling out of
        the fast tiers under pressure, a checkpoint is a durable copy of
        pages that stay resident (DESIGN.md §11 keeps the two metrics
        from being conflated)."""
        self.checkpoint_raw_bytes += max(raw_bytes, 0.0)
        self.checkpoint_bytes += max(stored_bytes, 0.0)
        self.checkpoints += 1

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        """Machine-readable tier trajectory for ``BENCH_serve.json``."""
        return {
            "spilled_bytes": self.spilled_bytes,
            "wire_bytes": self.wire_bytes,
            "disk_spill_bytes": self.disk_spill_bytes,
            "disk_read_bytes": self.disk_read_bytes,
            "compression_ratio": self.compression_ratio,
            "host_used_bytes": self.host_used_bytes,
            "host_peak_bytes": self.host_peak_bytes,
            "host_capacity_bytes": self.config.host_capacity_bytes,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "extractions": self.extractions,
            "transfers_completed": self.link.completed_transfers,
            "transfers_in_flight": self.link.in_flight,
            "max_quant_error": self.max_quant_error,
            "checkpoint_bytes": self.checkpoint_bytes,
            "checkpoint_raw_bytes": self.checkpoint_raw_bytes,
            "checkpoints": self.checkpoints,
        }
