"""Distribution substrate: SPMD sharding rules, per-arch presets, gradient
compression, and fault tolerance.

* :mod:`repro_torch.dist.sharding` — logical-axis → mesh-axis rules over a
  ``DeviceMesh``, the :func:`shard` activation pin, and regex param-path
  rules.
* :mod:`repro_torch.dist.presets` — per-architecture overrides and
  input/batch shardings for the dry-run launcher.
* :mod:`repro_torch.dist.compression` — int8 quantization with
  error-feedback gradient compression (also used by the KV tiers).
* :mod:`repro_torch.dist.fault` — straggler detection, checkpoint-restoring
  restart policy, and elastic resharding across mesh layouts.
"""

from repro_torch.dist import compression, fault, presets, sharding
from repro_torch.dist.sharding import (
    Rules,
    current_rules,
    make_rules,
    param_shardings,
    param_spec_for_path,
    shard,
    use_rules,
)

__all__ = [
    "Rules",
    "compression",
    "current_rules",
    "fault",
    "make_rules",
    "param_shardings",
    "param_spec_for_path",
    "presets",
    "shard",
    "sharding",
    "use_rules",
]
