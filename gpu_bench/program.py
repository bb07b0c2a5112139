"""The port's own spans and counters (``repro_torch.obs``) in a run of the
benchmark: the tracer switched on, the profiled slice reduced by the span
open in the port, and the arithmetic that the readers of the tracer's
records (``metrics/<name>.py``) share.

A run that traces the port holds, beside what ``serve.py`` and
``train.py`` record, ``spans`` (the tracer's spans, on
``time.perf_counter_ns``), ``window_open_s`` (the window's opening on
``time.perf_counter``), ``profiled_ns`` (the profiled slice on the
tracer's clock) and ``trace["program"]`` (:func:`reduce_program`).  A
record without them is a run of a tree whose port has no tracer: every
reader here returns ``None`` on it.

The profiler keeps its own clock.  Each of the slice's two marks
(``trace.MARK``) wraps a ``perf_counter`` read, of the slice's start and
of its end; the mark's midpoint less that read is one offset between the
two clocks, and the two offsets lie within ``CLOCK_TOLERANCE_US`` of each
other or the reduction says so.
"""

from __future__ import annotations

import bisect
import contextlib
import math
from typing import Dict, List, Optional

from . import trace as tr

#: the profiler's names of the port's spans begin so (``obs.PREFIX``)
PREFIX = "repro_torch."
#: the widest gap allowed between the clock offsets of the two marks, µs
CLOCK_TOLERANCE_US = 50.0
#: the host's operations listed, those with the most self time first
HOST_OPS = 12
#: the scheduler's passes in a tick
SCHEDULER = ("engine.policy", "engine.demote", "engine.tiers")
#: the MoE block's work around its expert products
MOE_DISPATCH = ("moe.route", "moe.dispatch", "moe.combine")


@contextlib.contextmanager
def program_spans(out: dict):
    """The port's tracer on while inside, its records (``spans``,
    ``counters``, ``dropped``) put in ``out`` on leaving.  Where the port
    has no tracer (an older tree) nothing is traced and ``out`` stays as
    it was."""
    try:
        from repro_torch import obs
    except ImportError:
        yield out
        return
    obs.enable()
    try:
        yield out
    finally:
        obs.disable()
        out.update(obs.collect())


def device_events(events) -> list:
    """``events`` without the device's copies of the port's spans (user
    annotations, no operation), as ``trace.reduce`` takes them."""
    import torch

    cuda_t = torch.autograd.DeviceType.CUDA
    return [e for e in events
            if not (e.device_type == cuda_t and e.name.startswith(PREFIX))]


def _device_us(e) -> float:
    us = getattr(e, "device_time_total", None)  # cuda_time_total before
    return float(e.cuda_time_total if us is None else us)


def _paths(spans) -> Dict[int, str]:
    """Each span's path, its outer spans' names on its own thread, the
    outermost first, joined by ``/``; by the span's index."""
    out: Dict[int, str] = {}
    by_thread: Dict[int, list] = {}
    for i, (name, a, b, th) in enumerate(spans):
        by_thread.setdefault(th, []).append((a, -b, i))
    for items in by_thread.values():
        stack: List[int] = []
        for a, _, i in sorted(items):
            while stack and spans[stack[-1]][2] < a:
                stack.pop()
            name = spans[i][0]
            out[i] = f"{out[stack[-1]]}/{name}" if stack else name
            stack.append(i)
    return out


def reduce_program(events, t0_s: float, window_s: float) -> dict:
    """The profiled slice by the port's spans: ``idle_s``, the device's
    idle seconds by the path of the innermost span open in the port
    through them (on any thread, the latest opened; ``host`` where none
    was: a gap the host spends in several spans goes to each for its
    stretch), ``device_s``, each span's device seconds by name (the kernels
    launched inside it, from ``device_time_total``), the offset of the
    profiler's clock from ``perf_counter`` (the mean of the two marks')
    and how far apart the two marks' offsets lie, in µs, and
    ``host_ops``, the host's operations with the most self time
    (name, calls, ms).
    ``t0_s`` and ``window_s`` are the slice's start on ``perf_counter``
    and its length, read inside the two marks."""
    import torch

    cuda_t = torch.autograd.DeviceType.CUDA
    marks, spans, kernels, dev_us, ops = [], [], [], {}, []
    for e in events:
        r = e.time_range
        if e.name == tr.MARK:
            if e.device_type != cuda_t:
                marks.append((r.start, r.end))
        elif e.name.startswith(PREFIX):
            if e.device_type != cuda_t:
                spans.append((e.name[len(PREFIX):], r.start, r.end,
                              e.thread, _device_us(e)))
        elif e.name.startswith(tr.PREFIX):
            continue
        elif e.device_type == cuda_t:
            kernels.append((r.start, r.end))
        else:
            ops.append((e.name, r.start, e.self_cpu_time_total))
    if len(marks) < 2:
        raise RuntimeError("profiler: the slice's marks are missing")
    marks.sort()
    s0, s1 = marks[0][0], marks[-1][0]
    # each mark's midpoint less the perf_counter read inside it
    off0, off1 = [(a + b) / 2 - 1e6 * t for (a, b), t in
                  zip((marks[0], marks[-1]), (t0_s, t0_s + window_s))]
    gap = abs(off1 - off0)
    for name, a, _, _, us in spans:
        if s0 <= a <= s1:
            dev_us[name] = dev_us.get(name, 0.0) + us
    host: Dict[str, list] = {}
    for name, a, us in ops:
        if s0 <= a <= s1:
            h = host.setdefault(name, [0, 0.0])
            h[0] += 1
            h[1] += us / 1e3
    busy = tr._union([(max(a, s0), min(b, s1)) for a, b in kernels
                      if min(b, s1) > max(a, s0)])
    spans = sorted(spans, key=lambda s: s[1])
    paths = _paths([(n, a, b, th) for n, a, b, th, _ in spans])
    edges = sorted({x for _, a, b, _, _ in spans for x in (a, b)})
    idle: Dict[str, float] = {}
    open_: List[int] = []  # spans begun by the time looked at, latest last
    nxt = 0
    gaps, t = [], s0
    for a, b in busy + [[s1, s1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    for g0, g1 in gaps:
        # the gap in stretches between the spans' edges, each to the
        # innermost span open through it
        cuts = edges[bisect.bisect_right(edges, g0):
                     bisect.bisect_left(edges, g1)]
        for a, b in zip([g0] + cuts, cuts + [g1]):
            mid = (a + b) / 2
            while nxt < len(spans) and spans[nxt][1] <= mid:
                open_.append(nxt)
                nxt += 1
            open_ = [i for i in open_ if spans[i][2] > mid]
            path = paths[open_[-1]] if open_ else "host"
            idle[path] = idle.get(path, 0.0) + (b - a) / 1e6
    return {"idle_s": idle,
            "device_s": {k: v / 1e6 for k, v in dev_us.items()},
            "clock_offset_us": (off0 + off1) / 2,
            "clock_offset_gap_us": gap,
            "clock_agrees": gap <= CLOCK_TOLERANCE_US,
            "host_ops": sorted(([k, n, ms] for k, (n, ms) in host.items()),
                               key=lambda x: -x[2])[:HOST_OPS]}


# ---------------------------------------------------------------- readers
def window_spans(rec) -> Optional[list]:
    """The tracer's spans that began inside the window, outside the
    profiled slice; None where the run has no tracer's records."""
    spans = rec.get("spans")
    if not spans:
        return None
    a = 1e9 * rec["window_open_s"]
    b = a + 1e9 * rec["seconds"]
    p0, p1 = rec.get("profiled_ns") or (math.inf, math.inf)
    return [s for s in spans
            if a <= s.t0_ns < b and not (s.t0_ns < p1 and s.t1_ns > p0)]


def per_top(rec, top: str, names) -> Optional[float]:
    """Milliseconds of the spans named in ``names`` per ``top`` span of
    the window (a tick, a step), on every thread."""
    spans = window_spans(rec)
    if spans is None:
        return None
    n = sum(s.name == top for s in spans)
    if not n:
        return None
    ns = sum(s.t1_ns - s.t0_ns for s in spans if s.name in names)
    return ns / n / 1e6


def _left_out(name: str) -> bool:
    """A span whose time is not the engine's own bookkeeping: the model,
    a wait on the device, the scheduler."""
    return (name.startswith("model.") or name.endswith(".sync")
            or name in SCHEDULER)


def bookkeeping_ms(rec) -> Optional[float]:
    """Each window tick's ``engine.step`` less its model, sync and
    scheduler spans (the outermost of each), mean in ms."""
    spans = window_spans(rec)
    if spans is None:
        return None
    kids: Dict[int, list] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    steps = [s for s in spans if s.name == "engine.step"]
    if not steps:
        return None
    total = 0
    for st in steps:
        total += st.t1_ns - st.t0_ns
        todo = list(kids.get(st.id, ()))
        while todo:
            s = todo.pop()
            if _left_out(s.name):
                total -= s.t1_ns - s.t0_ns
            else:
                todo += kids.get(s.id, ())
    return total / len(steps) / 1e6


def program(rec) -> Optional[dict]:
    t = rec.get("trace")
    return t.get("program") if t else None


def idle_share(rec, prefixes) -> Optional[float]:
    """Share of the profiled slice (%) the device was idle while a span
    whose name begins with one of ``prefixes`` was open in the port."""
    p = program(rec)
    if p is None or rec["trace"]["window_s"] <= 0:
        return None
    s = sum(v for path, v in p["idle_s"].items()
            if any(part.startswith(prefixes) for part in path.split("/")))
    return 100.0 * s / rec["trace"]["window_s"]


def idle_ms(rec, names) -> Optional[float]:
    """Milliseconds of the profiled slice in which the device was idle
    while a span named in ``names`` was open in the port (anywhere in the
    path of the innermost span open then)."""
    p = program(rec)
    if p is None:
        return None
    return 1e3 * sum(v for path, v in p["idle_s"].items()
                     if any(part in names for part in path.split("/")))


def self_idle_share(rec, top: str) -> Optional[float]:
    """Of the idle time inside the spans ``top`` (every idle gap while one
    was open, on any thread: all but ``host``), the share (%) left in
    ``top``'s own time, under none of its children."""
    p = program(rec)
    if p is None:
        return None
    inside = sum(v for k, v in p["idle_s"].items() if k != "host")
    return 100.0 * p["idle_s"].get(top, 0.0) / inside if inside else None
