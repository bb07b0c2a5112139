"""The :class:`Server` protocol — one front door shape for every runtime.

:class:`repro_torch.serve.engine.ServingEngine` (one replica),
:class:`repro_torch.serve.cluster.ServingCluster` (many replicas) and
:class:`repro_torch.serve.frontdoor.FrontDoor` (admission control wrapping
either) all satisfy this structural type, so the open-loop traffic
driver (:func:`repro_torch.serve.traffic.drive`) and every benchmark leg
target the protocol, never a concrete class:

    submit(request) → bool      accept a request (False = rejected at
                                the door; only the FrontDoor rejects)
    step()                      advance one engine tick
    run(max_ticks) → ServeReport   drive to completion, typed report
    replica_stats() → mapping   the load surface (capacity / projected
                                bytes / slots / queue depths)
    has_pending → bool          work still needs ticks
    tick → int                  the current simulation tick
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable

from repro_torch.serve.report import ServeReport

__all__ = ["Server"]


@runtime_checkable
class Server(Protocol):
    """Structural type every serving front door satisfies."""

    def submit(self, req: Any) -> bool: ...

    def step(self) -> None: ...

    def run(self, max_ticks: int = 1000) -> ServeReport: ...

    def replica_stats(self) -> Dict[str, float]: ...

    @property
    def has_pending(self) -> bool: ...
