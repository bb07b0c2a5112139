"""The port's tracer: named spans and cumulative counters, kept in memory.

Off by default.  The engine, the model, the MoE block and the train step
open spans at their layer boundaries (``engine.step`` and its passes,
``model.forward``, ``model.layer``, ``moe.*``, ``train.*``); an operator
turns the tracer on around the stretch to look at and reads it back::

    from repro_torch import obs

    obs.enable()
    ...                       # serve or train
    rec = obs.collect()       # {"spans": [...], "counters": {...}, "dropped": n}
    obs.disable()

Each span is a :class:`Span`: its name, start and end on
``time.perf_counter_ns``, the id of the span that was open on the same
thread when it opened (``None`` at the top of a thread), the thread and
its attributes.  Autograd runs a backward, and with it the recompute of
a checkpointed layer, on a thread of its own, so those spans start new
trees; a span opened during a backward carries ``recompute=True``.
Spans end up in the buffer in the order they close, a child before its
parent.

While a ``torch.profiler`` runs, every span also opens
``torch.profiler.record_function("repro_torch." + name)``: the span then
lies on the profiler's timeline beside the kernels it launched.

With the tracer off a span costs one test of a module flag and returns a
shared object that does nothing; call sites pass only attributes that
are cheap to build.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

#: spans kept between two ``collect()``; later ones are dropped and counted
LIMIT = 1 << 20
#: the profiler's name of a span is this prefix and the span's name
PREFIX = "repro_torch."


class Span(NamedTuple):
    id: int
    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[int]
    thread: int
    attrs: Dict[str, Any]


_on = False
_spans: List[Span] = []
_dropped = 0
_counters: Dict[str, int] = {}
_ids = itertools.count()
_local = threading.local()
_lock = threading.Lock()


class _Off:
    """The span returned while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "stack", "rf")

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        if torch._C._current_graph_task_id() != -1:
            self.attrs["recompute"] = True
        self.rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        if len(_spans) < LIMIT:
            _spans.append(Span(self.id, self.name, self.t0, t1, self.parent,
                               threading.get_ident(), self.attrs))
        else:
            with _lock:
                _dropped += 1
        return False


def span(name: str, **attrs):
    """A context manager timing the code inside it as the span ``name``."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    """Turn the tracer on, with an empty buffer and every counter at 0."""
    global _on, _dropped
    _spans.clear()
    _counters.clear()
    _dropped = 0
    _on = True


def disable() -> None:
    """Turn the tracer off; what it holds stays until ``collect()``."""
    global _on
    _on = False


def collect() -> dict:
    """The spans closed since the last collect (which leave the buffer),
    the number dropped past ``LIMIT``, and the counters' totals."""
    global _dropped
    spans = _spans[:]
    del _spans[:len(spans)]  # a span closing meanwhile stays for the next
    with _lock:
        out = {"spans": spans, "counters": dict(_counters),
               "dropped": _dropped}
        _dropped = 0
    return out
