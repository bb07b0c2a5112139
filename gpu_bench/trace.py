"""The traced slice: ``torch.profiler`` over a steady stretch of a run,
reduced to the device's busy time, the kernels' device time by name, and
the device's idle gaps named by the benchmark's span that was open on the
host when the device went idle.

Spans are ``torch.profiler.record_function`` ranges the benchmark opens
around its calls into the port (:func:`span`); they cost nothing while no
profiler runs.  The slice starts and ends where the device is idle
(after a synchronising step), each end marked in the trace: its length
on the host's clock is the traced window.  The profiler may run on after
the slice, so that reducing its events, which takes seconds, waits until
the run's loop is over.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, Optional

import torch

PREFIX = "bench."


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str, fn):
    """``fn`` inside the span ``name``."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return inner


MARK = PREFIX + "mark"


class Slice:
    """Profile from :meth:`start`; :meth:`end` closes the slice (a mark in
    the trace, and its length on the host's clock) while the profiler may
    run on; :meth:`stop` ends the profiler and reduces the events between
    the two marks."""

    def __init__(self) -> None:
        self.prof = None
        self._t0 = 0.0
        self.window_s = 0.0
        self.summary: Optional[dict] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        with torch.profiler.record_function(MARK):
            self._t0 = time.perf_counter()

    def end(self) -> None:
        with torch.profiler.record_function(MARK):
            self.window_s = time.perf_counter() - self._t0

    def stop(self) -> None:
        if not self.window_s:
            self.end()
        self.prof.__exit__(None, None, None)
        self.summary = reduce(self.prof.events(), self.window_s,
                              rename={"fwd_bwd": "backward"})
        self.prof = None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, window_s: float, rename: Dict[str, str]) -> dict:
    """busy_s, window_s, kernel seconds by name, idle seconds by span."""
    cuda_t = torch.autograd.DeviceType.CUDA
    spans, kernels, marks = [], [], []
    for e in events:
        tr = e.time_range
        if e.name == MARK:
            if e.device_type != cuda_t:
                marks.append(tr.start)
        elif e.name.startswith(PREFIX):
            # a span; its copy on the device's timeline is no operation
            if e.device_type != cuda_t:
                spans.append((e.name[len(PREFIX):], tr.start, tr.end))
        elif e.device_type == cuda_t:
            kernels.append((e.name, tr.start, tr.end))
    if len(marks) < 2:
        raise RuntimeError("profiler: the slice's marks are missing")
    s0, s1 = min(marks), max(marks)
    by_name: Dict[str, float] = {}
    ivs = []
    for name, a, b in kernels:
        a, b = max(a, s0), min(b, s1)
        if b <= a:
            continue
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        ivs.append((a, b))
    busy = _union(ivs)
    idle: Dict[str, float] = {}
    t = s0
    spans.sort(key=lambda x: x[1])
    for a, b in busy + [[s1, s1]]:
        if a > t:
            idle_name = _open_span(spans, t, rename)
            idle[idle_name] = idle.get(idle_name, 0.0) + (a - t) / 1e6
        t = max(t, b)
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": window_s,
        "kernel_s": by_name,
        "idle_s": idle,
        "n_kernels": len(ivs),
    }


def _open_span(spans, t, rename) -> str:
    """The innermost (latest-opened) span open at ``t``."""
    best = None
    for name, a, b in spans:
        if a > t:
            break
        if b >= t:
            best = name
    if best is None:
        return "host"
    return rename.get(best, best)


def breakdown(summary: dict) -> dict:
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def kernel_seconds(summary: dict, names) -> float:
    """Device seconds of the kernels whose name holds one of ``names``."""
    return sum(s for n, s in summary["kernel_s"].items()
               if any(k in n for k in names))


@contextlib.contextmanager
def patched(obj, attr: str, name: str):
    """``obj.attr`` inside the span ``name`` while inside."""
    fn = getattr(obj, attr)
    setattr(obj, attr, spanned(name, fn))
    try:
        yield
    finally:
        setattr(obj, attr, fn)
