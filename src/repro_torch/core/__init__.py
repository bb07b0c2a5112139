"""MURS core: memory-usage models, sampler, Algorithm-1 scheduler, pool.

The paper's contribution (a memory-usage-rate based scheduler for
service-mode data processing systems) as a composable library:

  * :mod:`usage_models` — the four growth models + online rate estimation
  * :mod:`sampler` — the seasonal per-task metric sampler
  * :mod:`memory_manager` — shared pool (JVM-heap / HBM) accounting
  * :mod:`repro_torch.sched` — Algorithm 1 (yellow/red, suspend/resume,
    spill guard); the aliases below keep core's API
  * :mod:`tasks`, :mod:`service`, :mod:`spark_sim` — the faithful
    reproduction environment for the paper's own evaluation (host only:
    no tensor arithmetic, so its metrics equal the JAX package's)
"""

from ..sched.murs import MursConfig
from ..sched.murs import MursPolicy as MursScheduler
from ..sched.protocol import SchedulingDecision

from .memory_manager import MemoryPool, OutOfMemoryError
from .sampler import Sampler, TaskStats
from .usage_models import (
    RateEstimator,
    UsageModel,
    classify_trace,
    fit_power_law,
    live_bytes_at,
)

__all__ = [
    "MemoryPool",
    "OutOfMemoryError",
    "Sampler",
    "TaskStats",
    "MursConfig",
    "MursScheduler",
    "SchedulingDecision",
    "RateEstimator",
    "UsageModel",
    "classify_trace",
    "fit_power_law",
    "live_bytes_at",
]
