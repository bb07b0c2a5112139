"""Shared memory-pool accounting (the JVM-heap / HBM-pool analogue).

The pool tracks two byte classes per owner, mirroring JVM generations:

    transient  — young-generation objects; reclaimed wholesale by a minor GC
                 (on the accelerator: per-step activations freed at step end)
    live       — old-generation / long-living objects: shuffle buffers, cached
                 RDD blocks (on the accelerator: KV caches, cached activations)

The MURS pressure indicator is the fraction of *live* bytes in the pool,
measured right after a minor GC (paper §IV: "the percentage of the heap usage
after a minor GC represents the living data objects in the heap").

``live_bytes`` / ``used_fraction`` sit on every hot path of the serving
engine (admission headroom checks, overcommit resolution, per-tick peak
tracking — many reads per tick), so the owner maps are
:class:`_OwnerLedger` dicts that maintain a running total through every
mutation path, turning each read into O(1) instead of O(owners).  The
ledger IS a dict — callers that reach past the MemoryPool API and mutate
``pool.live`` directly (``pop``/``clear``/item assignment) stay correct.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

__all__ = ["MemoryPool", "OutOfMemoryError"]


class OutOfMemoryError(RuntimeError):
    """Raised when a non-reclaimable allocation exceeds pool capacity."""


class _OwnerLedger(Dict[str, float]):
    """``Dict[str, float]`` with an O(1) running :attr:`total`.

    Every mutating dict method is overridden to keep ``total`` exact;
    emptying the ledger resets it to literal 0.0 so float error cannot
    accumulate across fill/drain cycles.
    """

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.total = float(sum(self.values()))

    def _settle(self) -> None:
        if not self:
            self.total = 0.0

    def __setitem__(self, key: str, value: float) -> None:
        self.total += value - super().get(key, 0.0)
        super().__setitem__(key, value)

    def __delitem__(self, key: str) -> None:
        self.total -= super().__getitem__(key)
        super().__delitem__(key)
        self._settle()

    def pop(self, key, *default):
        if key in self:
            self.total -= super().__getitem__(key)
        out = super().pop(key, *default)
        self._settle()
        return out

    def popitem(self):
        key, value = super().popitem()
        self.total -= value
        self._settle()
        return key, value

    def clear(self) -> None:
        super().clear()
        self.total = 0.0

    def update(self, *args, **kwargs) -> None:
        for key, value in dict(*args, **kwargs).items():
            self[key] = value

    def setdefault(self, key, default=0.0):
        if key not in self:
            self[key] = default
        return super().__getitem__(key)

    def copy(self) -> "_OwnerLedger":
        return _OwnerLedger(self)


@dataclass
class MemoryPool:
    """Byte-accurate shared pool with live/transient accounting per owner."""

    capacity: float
    live: Dict[str, float] = field(default_factory=_OwnerLedger)
    transient: Dict[str, float] = field(default_factory=_OwnerLedger)

    def __post_init__(self) -> None:
        # a caller-supplied plain dict still gets O(1) totals
        if not isinstance(self.live, _OwnerLedger):
            self.live = _OwnerLedger(self.live)
        if not isinstance(self.transient, _OwnerLedger):
            self.transient = _OwnerLedger(self.transient)

    # ------------------------------------------------------------------ sums
    @property
    def live_bytes(self) -> float:
        live = self.live
        if isinstance(live, _OwnerLedger):
            return live.total
        return sum(live.values())  # someone replaced the dict wholesale

    @property
    def transient_bytes(self) -> float:
        transient = self.transient
        if isinstance(transient, _OwnerLedger):
            return transient.total
        return sum(transient.values())

    @property
    def used_bytes(self) -> float:
        return self.live_bytes + self.transient_bytes

    @property
    def free_bytes(self) -> float:
        return max(self.capacity - self.used_bytes, 0.0)

    @property
    def used_fraction(self) -> float:
        """An EMPTY zero-capacity pool reads 0.0 (not permanently full):
        constant-state deployments legitimately run with no pool at all."""
        if self.capacity > 0:
            return self.used_bytes / self.capacity
        return 0.0 if not self.used_bytes else 1.0

    @property
    def live_fraction(self) -> float:
        """The MURS pressure indicator: long-living bytes / capacity."""
        if self.capacity > 0:
            return self.live_bytes / self.capacity
        return 0.0 if not self.live_bytes else 1.0

    # ------------------------------------------------------------- mutation
    def add_live(self, owner: str, nbytes: float) -> None:
        self.live[owner] = max(self.live.get(owner, 0.0) + nbytes, 0.0)

    def set_live(self, owner: str, nbytes: float) -> None:
        self.live[owner] = max(float(nbytes), 0.0)

    def add_transient(self, owner: str, nbytes: float) -> None:
        self.transient[owner] = max(
            self.transient.get(owner, 0.0) + nbytes, 0.0
        )

    def release_owner(self, owner: str) -> float:
        """Free everything held by ``owner`` (task completed/evicted)."""
        freed = self.live.pop(owner, 0.0) + self.transient.pop(owner, 0.0)
        return freed

    def minor_gc(self) -> float:
        """Reclaim all transient bytes; returns surviving (live) bytes."""
        self.transient.clear()
        return self.live_bytes

    def owner_bytes(self, owner: str) -> float:
        return self.live.get(owner, 0.0) + self.transient.get(owner, 0.0)
