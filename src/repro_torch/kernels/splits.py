"""What the kernels that split their work across CTAs share: the card's
SM count, the cut of an axis into splits, a plan cache keyed by shape and
device, one f32 workspace per stream for the splits' partial results
(K1, K4) and one zeroed int32 counter array per stream for a kernel whose
last CTA merges (K1).

A plan comes from the shapes alone: lengths and positions stay on the
device, so planning never waits for the card.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def even_split(length: int, ctas: int, sms: int, per_sm: int, min_len: int,
               max_len: Optional[int] = None) -> Tuple[int, int]:
    """(n_splits, split_len) of an axis of ``length`` items that ``ctas``
    CTAs each sweep: enough splits that ``ctas`` · n_splits reaches
    ``per_sm`` · ``sms``, none shorter than ``min_len`` items (unless the
    axis is), none longer than ``max_len``, and split_len · n_splits ≥
    length with no empty last split."""
    n = min(-(-per_sm * sms // ctas), length // min_len)
    if max_len is not None:
        n = max(n, -(-length // max_len))
    if n <= 1:
        return 1, length
    split_len = -(-length // n)
    return -(-length // split_len), split_len


def plan_cache(plan: Callable) -> Callable:
    """``plan(*shape, sms)`` cached per (shape, CUDA device index): the
    returned function takes ``(*shape, index)`` and reads the device's SM
    count once."""
    @functools.lru_cache(maxsize=None)
    def cached(*args):
        *shape, index = args
        return plan(*shape, sm_count(index))

    return cached


#: one split workspace per (device, stream), reused by every call on that
#: stream: the stream orders the calls, and each call merges its splits
#: before the next starts, so none overwrites another's partial results
_workspaces: Dict[Tuple[torch.device, int], torch.Tensor] = {}
#: one counter array per (device, stream): zero between calls (the last
#: CTA of each tile sets its counter back to 0)
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _grown(store, key, numel, make) -> torch.Tensor:
    buf = store.get(key)
    if buf is None or buf.numel() < numel:
        buf = make(numel)
        store[key] = buf
    return buf


def workspace(device: torch.device, stream: int,
              numel: int) -> torch.Tensor:
    """At least ``numel`` f32 of ``stream``'s split workspace on
    ``device``, grown with ``torch.empty`` when a call needs more (the
    caching allocator hands the old block only to later work on the same
    stream)."""
    return _grown(_workspaces, (device, stream), numel,
                  lambda n: torch.empty(n, dtype=torch.float32,
                                        device=device))


def counters(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    """At least ``numel`` int32 arrival counters of ``stream`` on
    ``device``, all 0: a kernel counts its splits' arrivals at each tile
    with an integer atomic and its last CTA sets the counter back to 0.
    Grown with ``torch.zeros`` when a call needs more."""
    return _grown(_counters, (device, stream), numel,
                  lambda n: torch.zeros(n, dtype=torch.int32,
                                        device=device))
