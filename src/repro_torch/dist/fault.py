"""Fault tolerance: stragglers and restart-from-checkpoint.

Two pieces a trainer or the serving cluster composes:

* :class:`StragglerDetector` — per-host step-time statistics; a host whose
  mean exceeds ``ratio ×`` the across-host median is flagged, and
  :meth:`rebalance_weights` yields inverse-speed work weights.
* :class:`RestartManager` — resume from the newest checkpoint in a
  directory, with a bounded-retry exponential-backoff policy for
  crash/preemption loops.
* :func:`elastic_reshard` — place a restored host tree onto whatever mesh
  the current rules describe.

The serving cluster composes the same pieces (DESIGN.md §8, §11):
:class:`StragglerDetector` runs over per-replica tick service times to
trigger live KV migration, and ``ServingCluster`` applies the
:class:`RestartManager` retry/backoff policy per crashed *request* —
with KV checkpoints standing in for parameter checkpoints, so a restore
replays only the checkpoint-uncovered suffix.
"""

from __future__ import annotations

import collections
import logging
import statistics
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpointing import latest_step_path, restore
from repro_torch.dist.sharding import Rules, path_str
from repro_torch.tree import tree_map_with_path

PyTree = Any
log = logging.getLogger(__name__)


class StragglerDetector:
    """Flag hosts whose mean step time exceeds ``ratio``× the median."""

    def __init__(
        self,
        min_samples: int = 5,
        ratio: float = 1.5,
        window: int = 64,
    ) -> None:
        self.min_samples = min_samples
        self.ratio = ratio
        self._times: Dict[str, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=window)
        )

    def observe(self, host: str, step_time_s: float) -> None:
        self._times[host].append(step_time_s)

    def forget(self, host: str) -> None:
        """Drop a host's samples — it restarted or was replaced, so its
        history describes a process that no longer exists."""
        self._times.pop(host, None)

    def _means(self) -> Dict[str, float]:
        return {
            h: sum(ts) / len(ts)
            for h, ts in self._times.items()
            if len(ts) >= self.min_samples
        }

    def stragglers(self) -> List[str]:
        means = self._means()
        if len(means) < 2:
            return []
        median = statistics.median(means.values())
        return sorted(h for h, m in means.items() if m > self.ratio * median)

    def rebalance_weights(self) -> Dict[str, float]:
        """Work weights ∝ host speed (1/mean step time), summing to 1.

        Means come from :meth:`_means` — the same ``min_samples``-gated
        statistics :meth:`stragglers` consults — so one noisy first sample
        from a fresh host cannot skew the whole weight vector.  Hosts
        still below ``min_samples`` keep their current share: they are
        excluded from the inverse-speed ranking and assigned the uniform
        weight (no evidence = no penalty, no bonus).  When NO host has
        enough samples yet the fallback is explicit: every observed host
        weighs equally.
        """
        means = self._means()
        observed = [h for h, ts in self._times.items() if ts]
        if not observed:
            return {}
        if not means:
            # explicit all-hosts fallback: nobody has min_samples yet, so
            # there is no trustworthy speed signal — split work evenly
            return {h: 1.0 / len(observed) for h in observed}
        inv = {h: 1.0 / max(m, 1e-9) for h, m in means.items()}
        unranked = [h for h in observed if h not in means]
        if unranked:
            # under-sampled hosts take the mean ranked weight
            uniform = sum(inv.values()) / len(inv)
            for h in unranked:
                inv[h] = uniform
        total = sum(inv.values())
        return {h: v / total for h, v in inv.items()}


class RestartManager:
    """Resume-from-latest + bounded retries with exponential backoff."""

    def __init__(
        self,
        ckpt_dir: str,
        *,
        max_retries: int = 3,
        backoff_s: float = 1.0,
        max_backoff_s: float = 60.0,
    ) -> None:
        if max_backoff_s < backoff_s:
            raise ValueError(
                f"max_backoff_s ({max_backoff_s}) must be >= backoff_s "
                f"({backoff_s})"
            )
        self.ckpt_dir = ckpt_dir
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.failures = 0
        self.last_heartbeat: Optional[Tuple[int, float]] = None

    # ------------------------------------------------------------- resume
    def resume(self, like: PyTree) -> Tuple[Optional[PyTree], int]:
        """(restored tree, step) from the newest checkpoint, or (None, 0);
        each leaf lands where ``like``'s tensor at its place lives."""
        path = latest_step_path(self.ckpt_dir)
        if path is None:
            return None, 0
        tree, step = restore(path, like)
        log.info("resumed from %s at step %d", path, step)
        return tree, step

    # ------------------------------------------------------ retry policy
    def should_retry(self) -> bool:
        return self.failures < self.max_retries

    def on_failure(self, exc: BaseException) -> float:
        """Record a failure; returns the backoff delay in seconds.

        Exponential growth is CAPPED at ``max_backoff_s``: a long
        preemption loop (every retry failing for hours) must produce a
        bounded sleep, not an uncapped ``2**n`` that quietly reaches
        hour-scale delays before the retry budget runs out.
        """
        self.failures += 1
        delay = min(
            self.backoff_s * (2.0 ** (self.failures - 1)), self.max_backoff_s
        )
        log.warning(
            "step failed (%s: %s) — retry %d/%d after %.1fs",
            type(exc).__name__, exc, self.failures, self.max_retries, delay,
        )
        return delay

    def on_success(self) -> None:
        self.failures = 0

    def record_heartbeat(self, step: int) -> None:
        self.last_heartbeat = (step, time.monotonic())


def elastic_reshard(tree: PyTree, rules: Rules) -> PyTree:
    """Place a (host-side) tree onto ``rules.mesh`` under the param rules.

    The checkpoint format stores plain host arrays, so restoring onto a
    different mesh shape is just a fresh placement decision: every leaf
    becomes a ``DTensor`` (``distribute_tensor``, which moves it to the
    mesh's device) with the placements its path resolves to under the
    *current* rules (unknown paths → replicated).
    """
    from torch.distributed.tensor import distribute_tensor

    def place(key_path, leaf):
        t = torch.as_tensor(leaf)
        spec = rules.spec_for_path(path_str(key_path), t.dim())
        spec = rules.fit(spec, tuple(t.shape))  # the new mesh may not divide
        return distribute_tensor(t, rules.mesh, rules.placements(spec))

    return tree_map_with_path(place, tree)
