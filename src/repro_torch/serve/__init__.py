"""Serving layer: the MURS engine over a paged KV pool with KV tiers."""

from .engine import EngineConfig, MigrationTicket, Request, ServingEngine
from .kv_cache import PagedKVManager, PrefixCache, kv_bytes_per_token
from .ledger import LedgerView, MemoryLedger, PageClass, PressurePlan
from .report import RequestOutcome, ServeReport
from .server import Server
from .tiers import TierConfig, TieredKVStore

__all__ = [
    "EngineConfig",
    "LedgerView",
    "MemoryLedger",
    "MigrationTicket",
    "PageClass",
    "PagedKVManager",
    "PrefixCache",
    "PressurePlan",
    "Request",
    "RequestOutcome",
    "ServeReport",
    "Server",
    "ServingEngine",
    "TierConfig",
    "TieredKVStore",
    "kv_bytes_per_token",
]
