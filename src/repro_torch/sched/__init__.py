"""Pluggable scheduling-policy layer (MURS §IV, generalized).

The paper's claim is that ONE memory-usage-rate scheduler can govern all
co-resident tasks of a service.  This package makes the scheduler a first-
class, swappable policy that the serving engine
(:mod:`repro_torch.serve.engine`), its cluster router and its front door
consume — MURS-vs-FAIR comparisons are policy swaps, never divergent
code paths.

Policies:
  * :class:`FairPolicy`     — Spark's fair scheduler pool: round-robin core
                              assignment, no pressure response (the stock
                              baseline; spills / OOMs reactively).
  * :class:`MursPolicy`     — Algorithm 1: yellow/red bands, rate-ranked
                              suspension, FIFO resume, spill guard.
  * :class:`PriorityPolicy` — tenant-weighted stride scheduling with
                              weight-ordered shedding under pressure
                              (demonstrates the layer is actually pluggable).
"""

from .fair import FairPolicy
from .murs import MursConfig, MursPolicy
from .priority import PriorityConfig, PriorityPolicy
from .protocol import BasePolicy, SchedulingDecision, SchedulingPolicy

__all__ = [
    "BasePolicy",
    "FairPolicy",
    "MursConfig",
    "MursPolicy",
    "PriorityConfig",
    "PriorityPolicy",
    "SchedulingDecision",
    "SchedulingPolicy",
]
