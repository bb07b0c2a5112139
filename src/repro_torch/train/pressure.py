"""Pressure-adaptive gradient accumulation — MURS applied to training.

Copied from the JAX package's ``repro.train.pressure`` (it imports no
JAX), its one import rewritten to the port's ``repro_torch.sched``.

The paper's scheduler manages a shared pool by reducing the parallelism of
memory-heavy work when usage crosses the yellow threshold.  The training
analogue of "number of running tasks" is the **microbatch width**: fewer
tokens in flight per backward = smaller live-activation set, at the cost of
more accumulation steps.  This controller drives that trade-off with the
MURS thresholds and hysteresis:

    usage ≥ red     → double the accumulation factor immediately (halve the
                      in-flight activations) — the ComputeSpill analogue
    usage ≥ yellow  → double after ``patience`` consecutive hot steps
    usage < relax·yellow for ``patience`` steps → halve (recover throughput)

``probe`` abstracts the pool reading: on a card it is
``torch.cuda.memory_allocated() / total memory``; tests inject synthetic
probes.  The Trainer builds a step per factor (cached per factor).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List

from ..sched import MursConfig


@dataclass
class PressureAdaptiveAccumulator:
    probe: Callable[[], float]  # → pool used fraction in [0, 1]
    config: MursConfig = field(default_factory=MursConfig)
    min_factor: int = 1
    max_factor: int = 64
    patience: int = 3
    relax: float = 0.5  # shrink when usage < relax × yellow
    factor: int = 1
    _hot: int = 0
    _cool: int = 0
    history: List[dict] = field(default_factory=list)

    def step(self) -> int:
        """Observe pressure, maybe adapt; returns the factor to use next."""
        usage = float(self.probe())
        cfg = self.config
        changed = None
        if usage >= cfg.red and self.factor < self.max_factor:
            self.factor = min(self.factor * 2, self.max_factor)
            changed = "red-double"
            self._hot = self._cool = 0
        elif usage >= cfg.yellow:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.patience and self.factor < self.max_factor:
                self.factor = min(self.factor * 2, self.max_factor)
                changed = "yellow-double"
                self._hot = 0
        elif usage < self.relax * cfg.yellow:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.patience and self.factor > self.min_factor:
                self.factor = max(self.factor // 2, self.min_factor)
                changed = "cool-halve"
                self._cool = 0
        else:
            self._hot = self._cool = 0
        self.history.append(
            {"usage": usage, "factor": self.factor, "event": changed}
        )
        return self.factor
