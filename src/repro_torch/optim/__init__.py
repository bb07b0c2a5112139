from . import adamw
from .adamw import AdamWConfig, AdamWState

__all__ = ["adamw", "AdamWConfig", "AdamWState"]
