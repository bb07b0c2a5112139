"""Checkpointing for serving KV and any tree of tensors.

:func:`save` / :func:`restore` move nested dicts, lists and tuples of
tensors through an atomic, compressed, codec-portable on-disk format
(the JAX package's, byte for byte); :func:`restore_leaves` reads
self-describing flat checkpoints (the serving cluster's periodic KV
snapshots) without a target structure; :class:`AsyncCheckpointer`
backgrounds the serialize-and-write; :func:`latest_step_path` is the
resume discovery both :class:`repro_torch.dist.fault.RestartManager` and
``ServingCluster.crash_replica`` use.
"""

from .checkpointing import (
    AsyncCheckpointer,
    latest_step_path,
    restore,
    restore_leaves,
    save,
)

__all__ = [
    "AsyncCheckpointer",
    "latest_step_path",
    "restore",
    "restore_leaves",
    "save",
]
