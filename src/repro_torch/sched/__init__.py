"""Pluggable scheduling-policy layer (MURS §IV, generalized).

  * :class:`FairPolicy` — round-robin, no pressure response (the stock
    baseline).
  * :class:`MursPolicy` — Algorithm 1: yellow/red bands, rate-ranked
    suspension, FIFO resume, spill guard.
"""

from .fair import FairPolicy
from .murs import MursConfig, MursPolicy
from .protocol import BasePolicy, SchedulingDecision, SchedulingPolicy

__all__ = [
    "BasePolicy",
    "FairPolicy",
    "MursConfig",
    "MursPolicy",
    "SchedulingDecision",
    "SchedulingPolicy",
]
