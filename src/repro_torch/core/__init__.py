"""MURS core: memory-usage models, the seasonal sampler and the pool."""

from .memory_manager import MemoryPool, OutOfMemoryError
from .sampler import Sampler, TaskStats
from .usage_models import RateEstimator, UsageModel

__all__ = [
    "MemoryPool",
    "OutOfMemoryError",
    "Sampler",
    "TaskStats",
    "RateEstimator",
    "UsageModel",
]
