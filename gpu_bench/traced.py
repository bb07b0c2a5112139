#!/usr/bin/env python3
"""One traced run of a cell of ``BENCHMARK.json`` with the port's own
tracer (``repro_torch.obs``) on, and the readings of its records.

    python3 gpu_bench/traced.py --workload <cell> --seed <n> \\
        --seconds <s> [--tracer 0|1]

from the root of a checkout, on a machine with a card.  The run is
``run.py --trace 1``'s, with the tracer on from the window's opening to
the profiled slice's end (``--tracer 0`` leaves it off: the same run,
for the cost of tracing).  The last line of standard output is
``run.py``'s line with ``program`` added:

- ``metrics``: the readers of the port's spans and counters
  (``metrics/<name>.py``, :data:`METRICS`) in the cells they read;
- ``tokens_per_s`` (serving: the window's, with the tracer on) or
  ``step_s`` (training: the window's steps before the profiled one, with
  the tracer on, and after it, with the tracer off), and ``tick_ms``;
- ``trace``: :func:`program.reduce_program` of the slice;
- ``self_idle_share``: of the idle time inside a tick (a step), the
  share left in ``engine.step``'s (``train.step``'s) own time;
- serving: ``modeled``, the ticks' host time beside the engine's
  modeled cost (``last_tick_cost``), and ``slowest_ticks``, the window's
  five slowest ticks with the spans inside them.

The harness's own run of a cell does not trace the port.  This command
makes one run do so by wrapping, while it lasts: ``port.launches``
(whose first call opens the window: the tracer goes on; :func:`opened`
checks that no tick of the window ran before it), ``trace.Slice`` (its
end turns the tracer off; its ``stop`` reduces the events without the
device's copies of the port's spans and adds the program's reduction),
``port.engine_counters`` (with the tiers' byte counters),
``port.engine`` (each tick's start and modeled cost) and ``serve.run``
and ``train.run`` (the tracer's records into the run's record).

This file stands in for edits to the harness's own files (``port.py``,
``serve.py``, ``train.py``, ``trace.py``) that turn the tracer on in
every ``--trace 1`` run; the change that makes those edits deletes it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: the readers of the port's own spans and counters, and their cells
METRICS = {
    "sched_ms.serve": ("serve-internlm2-murs", "serve-internlm2-chat"),
    "bookkeeping_ms.serve": ("serve-internlm2-murs", "serve-internlm2-chat"),
    "idle_in_model.serve": ("serve-internlm2-murs", "serve-internlm2-chat"),
    "gather_share.serve": ("serve-internlm2-murs", "serve-internlm2-chat"),
    "tier_copy_bytes_per_s.serve": ("serve-internlm2-murs",),
    "moe_dispatch_ms.train": ("train-granite-s2k",),
    "idle_in_model.train": ("train-granite-s2k", "train-internlm2-s2k"),
}
#: the engine's counters of the tiers' bytes
TIER_COUNTERS = ("tier_d2h_bytes", "tier_h2d_bytes")
#: how far before the window's opening the tracer may go on, s
OPENING_S = 5e-3


def opened(on_s: float, window_open_s: float, tick_starts) -> None:
    """Raise unless the tracer went on at the window's opening: at most
    ``OPENING_S`` before it, and, where ticks are known (serving, whose
    loop reads the counters at its first turn past the opening), before
    any tick that began in the window; in training, at most ``OPENING_S``
    after it."""
    late = [t for t in tick_starts if window_open_s <= t < on_s]
    if (on_s < window_open_s - OPENING_S or late
            or (not tick_starts and on_s > window_open_s + OPENING_S)):
        raise RuntimeError(
            f"the tracer went on at {on_s:.6f} s, the window opened at "
            f"{window_open_s:.6f} s, {len(late)} window ticks before it")


@contextlib.contextmanager
def traced(tracer: bool, held: dict):
    """The harness wrapped as the module's docstring says while inside;
    the run's record ends up under ``held["rec"]``."""
    from gpu_bench import port, program, serve, train
    from gpu_bench import trace as tr

    real = {"launches": port.launches, "counters": port.engine_counters,
            "engine": port.engine, "Slice": tr.Slice,
            "serve": serve.run, "train": train.run}
    state = {"cm": None, "on_s": None}
    held["costs"], held["tick_starts"] = [], []

    def launches():
        if tracer and state["on_s"] is None:
            state["cm"] = program.program_spans(held)
            state["cm"].__enter__()
            state["on_s"] = time.perf_counter()
        return real["launches"]()

    def engine_counters(eng):
        out = real["counters"](eng)
        out.update({k: int(getattr(eng, k)) for k in TIER_COUNTERS
                    if hasattr(eng, k)})
        return out

    def engine(*args, **kwargs):
        eng = real["engine"](*args, **kwargs)
        step, costs, starts = eng.step, held["costs"], held["tick_starts"]

        def stepped():
            starts.append(time.perf_counter())
            step()
            costs.append(eng.last_tick_cost)

        eng.step = stepped
        return eng

    def tracer_off():
        if state["cm"] is not None:
            state["cm"].__exit__(None, None, None)
            state["cm"] = None

    class Slice(real["Slice"]):
        def end(self):
            super().end()
            held["profiled_ns"] = (int(1e9 * self._t0),
                                   int(1e9 * (self._t0 + self.window_s)))
            tracer_off()

        def stop(self):
            # the harness's own stop, on the events without the device's
            # copies of the port's spans, then the program's reduction
            events, kept = self.prof.events, []

            def device_events():
                kept[:] = program.device_events(events())
                return kept

            self.prof.events = device_events
            super().stop()
            self.summary["program"] = program.reduce_program(
                kept, self._t0, self.window_s)

    def recorded(run):
        def inner(ctx):
            rec = run(ctx)
            tracer_off()  # a run too short to reach its slice
            if state["on_s"] is not None:
                opened(state["on_s"], ctx.window_open, held["tick_starts"])
            rec.update(spans=held.get("spans"),
                       window_open_s=ctx.window_open,
                       profiled_ns=held.get("profiled_ns"),
                       obs_dropped=held.get("dropped"))
            held["rec"] = rec
            return rec
        return inner

    port.launches, port.engine_counters, port.engine = (
        launches, engine_counters, engine)
    tr.Slice = Slice
    serve.run, train.run = recorded(real["serve"]), recorded(real["train"])
    try:
        yield held
    finally:
        tracer_off()
        port.launches, port.engine_counters, port.engine = (
            real["launches"], real["counters"], real["engine"])
        tr.Slice = real["Slice"]
        serve.run, train.run = real["serve"], real["train"]


def _median(xs):
    return statistics.median(xs) if xs else None


def _ms(ns) -> float:
    return round(ns / 1e6, 3)


def _ticks(rec, costs) -> dict:
    """The window's ticks' host time beside their modeled cost, and the
    five slowest with the spans inside them (ms by name)."""
    from gpu_bench import program

    spans = program.window_spans(rec) or []
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    steps = [s for s in spans if s.name == "engine.step"]
    if not steps:
        return {}
    pairs = [((s.t1_ns - s.t0_ns) / 1e9, costs[s.attrs["tick"]])
             for s in steps if s.attrs["tick"] < len(costs)]
    slowest = []
    for st in sorted(steps, key=lambda s: s.t0_ns - s.t1_ns)[:5]:
        inside, todo = {}, [(s, ()) for s in kids.get(st.id, ())]
        prefill = []
        while todo:
            s, outer = todo.pop()
            if s.name not in outer:  # a span inside its namesake: once
                inside[s.name] = inside.get(s.name, 0) + s.t1_ns - s.t0_ns
            if s.name == "engine.prefill.request":
                prefill.append([s.attrs["path"], s.attrs["tokens"],
                                _ms(s.t1_ns - s.t0_ns)])
            todo += [(k, outer + (s.name,)) for k in kids.get(s.id, ())]
        slowest.append({"tick": st.attrs["tick"],
                        "ms": _ms(st.t1_ns - st.t0_ns),
                        "modeled_ms": (round(1e3 * costs[st.attrs["tick"]], 3)
                                       if st.attrs["tick"] < len(costs)
                                       else None),
                        "inside_ms": {k: _ms(v) for k, v in sorted(
                            inside.items(), key=lambda kv: -kv[1])},
                        "prefills": prefill})
    return {
        "modeled": {
            "ticks": len(pairs),
            "host_ms_median": round(1e3 * statistics.median(
                h for h, _ in pairs), 3),
            "modeled_ms_median": round(1e3 * statistics.median(
                c for _, c in pairs), 3),
            "ratio_median": round(statistics.median(
                h / c for h, c in pairs if c > 0), 2),
        } if pairs else None,
        "slowest_ticks": slowest,
    }


def readings(rec, workload: str, job: dict, costs) -> dict:
    from gpu_bench import program, readers, run

    out = {"metrics": {}}
    for name, cells in METRICS.items():
        if workload in cells:
            out["metrics"][name] = run.reader(ROOT, name).read(rec)
    p = program.program(rec)
    if rec["kind"] == "serve":
        out["tokens_per_s"] = run.reader(ROOT, "serve_tokens_per_s").read(
            rec)
        out["tick_ms"] = readers.tick_ms(rec)
        out["self_idle_share"] = program.self_idle_share(rec, "engine.step")
        out.update(_ticks(rec, costs))
    else:
        k = job["slice_step"]
        before, after = (rec["untraced_step_s"][:k],
                         rec["untraced_step_s"][k:])
        out["step_s"] = {"tracer_on": before, "tracer_off": after,
                         "median_on": _median(before),
                         "median_off": _median(after)}
        out["self_idle_share"] = program.self_idle_share(rec, "train.step")
    if p is not None:
        out["trace"] = dict(p, device_s=dict(sorted(
            p["device_s"].items(), key=lambda kv: -kv[1])))
    out["spans"] = len(rec.get("spans") or ())
    out["dropped"] = rec.get("obs_dropped")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "gpu_bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from gpu_bench import run

    if not torch.cuda.is_available():
        print("traced.py needs a CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    held: dict = {}
    with traced(bool(args.tracer), held):
        out, _ = run.execute(ROOT, args.workload, args.seed, args.seconds,
                             True, "cuda")
    job = run.load(ROOT, "traffic", cell["traffic"])
    out["program"] = readings(held["rec"], args.workload, job,
                              held["costs"])
    out["program"]["tracer"] = bool(args.tracer)
    bad = run.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
