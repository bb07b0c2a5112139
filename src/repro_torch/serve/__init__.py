"""Public surface of the serving stack: engine, cluster, front door,
traffic generators, and the typed :class:`ServeReport` (DESIGN.md
§§2 and 8–9, 11; operator guide in docs/OPERATIONS.md)."""

from .cluster import ClusterConfig, ServingCluster
from .engine import (
    EngineConfig,
    ExtraInputsNotServed,
    MigrationTicket,
    PrecopySnapshot,
    Request,
    ServingEngine,
)
from .frontdoor import FrontDoor, FrontDoorConfig, TokenBucket
from .ledger import LedgerView, MemoryLedger, PageClass, PressurePlan
from .kv_cache import (
    CACHE_OWNER,
    DEMOTED,
    PageBlockAllocator,
    PagedKVManager,
    PrefixCache,
    constant_state_bytes,
    kv_bytes_per_token,
)
from .report import (
    COMPLETED,
    FAILED,
    LOST,
    RATE_LIMITED,
    SHED,
    UNFINISHED,
    LatencySummary,
    RequestOutcome,
    ServeReport,
    SloSpec,
)
from .server import Server
from .tiers import TierConfig, TieredKVStore
from .traffic import (
    Arrival,
    TenantProfile,
    bursty_trace,
    diurnal_trace,
    drive,
    poisson_trace,
)

__all__ = [
    "CACHE_OWNER",
    "COMPLETED",
    "Arrival",
    "ClusterConfig",
    "DEMOTED",
    "EngineConfig",
    "ExtraInputsNotServed",
    "FAILED",
    "FrontDoor",
    "FrontDoorConfig",
    "LOST",
    "LatencySummary",
    "LedgerView",
    "MemoryLedger",
    "MigrationTicket",
    "PageClass",
    "PrecopySnapshot",
    "PageBlockAllocator",
    "PagedKVManager",
    "PrefixCache",
    "PressurePlan",
    "RATE_LIMITED",
    "Request",
    "RequestOutcome",
    "SHED",
    "Server",
    "ServeReport",
    "ServingCluster",
    "ServingEngine",
    "SloSpec",
    "TenantProfile",
    "TierConfig",
    "TieredKVStore",
    "TokenBucket",
    "UNFINISHED",
    "bursty_trace",
    "constant_state_bytes",
    "diurnal_trace",
    "drive",
    "kv_bytes_per_token",
    "poisson_trace",
]
