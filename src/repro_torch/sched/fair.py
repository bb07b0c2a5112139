"""FAIR — the stock baseline policy (Spark fair scheduler pool / naive
serving admission).

Round-robin core handout across tenants (inherited from
:class:`BasePolicy`), no pressure response: ``propose`` never suspends
and ``admission_headroom`` is 1.0, so the runtimes apply stock semantics
— admit until the pool is full, then resolve overcommit reactively
(spill / offload-to-host, or OOM-style hard failure when no spill path
exists).  The ``pressure()`` plan stays at the BasePolicy stock: every
per-class score is 0.0 for every tenant, so prefix-cache eviction order
is pure LRU and frozen KV is never demoted proactively — reactive-only
tiering is exactly what "stock" means.  Likewise ``placement_score``
stays at the base 0.0 for every replica, so cross-replica routing under
FAIR is the router's round-robin tie-break: pressure-oblivious request
spraying, the multi-server stock baseline.  The plan's shed key is
likewise the inherited FIFO-over-groups order: under admission overload
the earliest-arrived tenant sheds first, with no regard for who is
actually filling the pool — the failure mode the usage-rate order is
measured against.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

from .protocol import BasePolicy, SchedulingDecision

if TYPE_CHECKING:
    from repro_torch.core.memory_manager import MemoryPool
    from repro_torch.core.sampler import TaskStats

__all__ = ["FairPolicy"]


class FairPolicy(BasePolicy):
    """Pressure-oblivious round-robin: the paper's comparison baseline."""

    name = "fair"
    proactive = False

    def __init__(self, period: float = 1.0) -> None:
        super().__init__()
        self.period = period

    def propose(
        self,
        pool: "MemoryPool",
        running: Sequence["TaskStats"],
        now: float = 0.0,
        suspended: Sequence["TaskStats"] = (),
    ) -> SchedulingDecision:
        return SchedulingDecision(reason="fair")
