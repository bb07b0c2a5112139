"""Distribution substrate: int8 quantization shared by the KV tiers, and
fault tolerance (straggler detection and checkpoint-restoring restarts)."""

from repro_torch.dist import compression, fault

__all__ = ["compression", "fault"]
