"""The port's own spans in the benchmark (``program.py``, ``traced.py``):
the slice reduced by the span open in the port on synthetic profiler
events, the readers of the tracer's records on synthetic records, and a
tiny cell of each kind traced end to end on the CPU."""

import json
import sys
from types import SimpleNamespace

import pytest
import torch
from conftest import REPO

from gpu_bench import program, run, traced
from gpu_bench import trace as tr
from repro_torch.obs import Span

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
#: the slice starts at 5.0 s on perf_counter, at 1,000 µs on the
#: profiler's clock: an offset of 1,000 - 5e6 µs
T0_S, OFFSET_US = 5.0, 1000.0 - 5e6


def ev(name, start, end, dev=CPU, thread=1, device_us=0.0, self_us=0.0):
    return SimpleNamespace(name=name, device_type=dev, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           device_time_total=device_us,
                           self_cpu_time_total=self_us)


def events(second_mark_shift=0.0):
    """A 1,000-µs slice (1,000 to 2,000 on the profiler's clock).  Main
    thread: engine.step over 1,100-1,900 holding model.forward over
    1,200-1,600 (a model.layer at 1,250-1,550) and engine.decode.sync at
    1,650-1,800.  A second thread's model.layer over 1,300-1,400 (opened
    later than the main thread's layer).  Kernels at 1,000-1,150,
    1,260-1,300, 1,420-1,450, 1,480-1,700 and 1,850-2,000; a bench span
    around it all, the device's copies of two of the port's spans, and
    host operations: two launches and a copy in the slice, one launch
    after it."""
    P = program.PREFIX
    end = 2000.0 + second_mark_shift
    return [
        ev(tr.MARK, 1000.0, 1000.0),
        ev(tr.MARK, end, end),
        ev(tr.PREFIX + "step", 1050, 1950),
        ev(P + "engine.step", 1100, 1900, device_us=500.0),
        ev(P + "model.forward", 1200, 1600, device_us=320.0),
        ev(P + "model.layer", 1250, 1550, device_us=320.0),
        ev(P + "engine.decode.sync", 1650, 1800),
        ev(P + "model.layer", 1300, 1400, thread=2, device_us=40.0),
        ev(P + "model.forward", 1200, 1600, dev=CUDA),
        ev(P + "model.layer", 1250, 1550, dev=CUDA),
        ev(tr.PREFIX + "step", 1050, 1950, dev=CUDA),
        ev("kernel_a", 1000, 1150, dev=CUDA),
        ev("kernel_b", 1260, 1300, dev=CUDA),
        ev("kernel_c", 1420, 1450, dev=CUDA),
        ev("kernel_c", 1480, 1700, dev=CUDA),
        ev("kernel_d", 1850, 2000, dev=CUDA),
        ev("cudaLaunchKernel", 1255, 1260, self_us=5.0),
        ev("cudaLaunchKernel", 1415, 1420, self_us=4.0),
        ev("aten::copy_", 1640, 1660, self_us=20.0),
        ev("cudaLaunchKernel", 2100, 2110, self_us=10.0),
    ]


def test_the_ports_device_copies_leave_busy_and_idle_as_they_were():
    evs = events()
    plain = [e for e in evs if not (e.name.startswith(program.PREFIX))]
    want = tr.reduce(plain, 1e-3, rename={})
    got = tr.reduce(program.device_events(evs), 1e-3, rename={})
    assert got == want
    assert got["busy_s"] == pytest.approx(590e-6)
    assert got["idle_s"] == {"step": pytest.approx(410e-6)}
    assert got["n_kernels"] == 5
    # kept in, the device's copies would have filled the gaps
    assert tr.reduce(evs, 1e-3, rename={})["busy_s"] > want["busy_s"]


def test_idle_goes_to_the_innermost_span_opened_last_on_any_thread():
    p = program.reduce_program(events(), T0_S, 1e-3)
    idle = {k: v * 1e6 for k, v in p["idle_s"].items()}
    assert idle == pytest.approx({
        # 1,150-1,200 and 1,800-1,850
        "engine.step": 100.0,
        "engine.step/model.forward": 50.0,  # 1,200-1,250
        # 1,250-1,260, 1,400-1,420 and 1,450-1,480
        "engine.step/model.forward/model.layer": 60.0,
        "model.layer": 100.0,  # 1,300-1,400: thread 2's, opened last
        "engine.step/engine.decode.sync": 100.0,  # 1,700-1,800
    })
    assert p["device_s"] == pytest.approx({
        "engine.step": 500e-6, "model.forward": 320e-6,
        "model.layer": 360e-6, "engine.decode.sync": 0.0})
    assert p["host_ops"] == [["aten::copy_", 1, pytest.approx(0.02)],
                             ["cudaLaunchKernel", 2, pytest.approx(0.009)]]
    assert p["clock_offset_us"] == pytest.approx(OFFSET_US)
    assert p["clock_offset_gap_us"] == pytest.approx(0.0, abs=1e-6)
    assert p["clock_agrees"]


def test_the_two_marks_must_give_one_offset():
    p = program.reduce_program(events(second_mark_shift=60.0), T0_S, 1e-3)
    assert p["clock_offset_gap_us"] == pytest.approx(60.0)
    assert not p["clock_agrees"]
    with pytest.raises(RuntimeError):
        program.reduce_program(events()[1:], T0_S, 1e-3)


# ---------------------------------------------------------------- readers
def _span(i, name, t0_ms, t1_ms, parent=None, thread=1, **attrs):
    return Span(i, name, int(1e6 * t0_ms), int(1e6 * t1_ms), parent,
                thread, attrs)


def serve_record():
    """Window [1,000, 1,010) s on perf_counter.  Two ticks of 100 ms in
    it, one before: each holds a 10-ms policy pass (the first only), a
    5-ms demote pass, a decode of 80 ms whose model.forward takes 60 (a
    layer of 50 inside) and whose sync takes 10."""
    spans, i = [], 0
    for k, start in enumerate((999_000.0, 1_000_100.0, 1_000_300.0)):
        base = i
        spans.append(_span(base, "engine.step", start, start + 100, tick=k))
        spans.append(_span(base + 1, "engine.decode", start + 10,
                           start + 90, base))
        spans.append(_span(base + 2, "model.forward", start + 15,
                           start + 75, base + 1))
        spans.append(_span(base + 3, "model.layer", start + 20,
                           start + 70, base + 2, index=0))
        spans.append(_span(base + 4, "engine.decode.sync", start + 76,
                           start + 86, base + 1))
        spans.append(_span(base + 5, "engine.demote", start + 91,
                           start + 96, base))
        i = base + 6
        if k == 1:
            spans.append(_span(i, "engine.policy", start + 1, start + 9,
                               base))
            i += 1
    counters = {"tier_d2h_bytes": 1_000_000, "tier_h2d_bytes": 0}
    later = {"tier_d2h_bytes": 21_000_000, "tier_h2d_bytes": 4_000_000}
    return {"kind": "serve", "seconds": 10, "window_open_s": 1000.0,
            "spans": spans, "counters": (counters, later),
            "trace": {"window_s": 2.0, "busy_s": 1.5, "program": {
                "idle_s": {"host": 0.1,
                           "engine.step": 0.01,
                           "engine.step/engine.decode/model.forward": 0.2,
                           "engine.step/engine.decode/engine.decode.sync":
                           0.19},
                "device_s": {"model.pool_gather": 0.9}}}}


def train_record():
    """Window [100, 200) s: two steps of 1 s before the profiled one, MoE
    spans on both threads; the training readers read the profiled step's
    ``trace.program``."""
    s = [_span(0, "train.step", 100_000, 101_000),
         _span(1, "moe.route", 100_100, 100_110),
         _span(2, "moe.dispatch", 100_110, 100_150),
         _span(3, "moe.experts", 100_150, 100_160),
         _span(4, "moe.combine", 100_160, 100_200),
         _span(5, "moe.dispatch", 100_500, 100_540, thread=2,
               recompute=True),
         _span(6, "train.step", 101_000, 102_000),
         _span(7, "moe.dispatch", 101_100, 101_120),
         _span(8, "train.step", 102_000, 104_000),  # profiled
         _span(9, "moe.dispatch", 102_100, 103_100)]
    return {"kind": "train", "seconds": 100, "window_open_s": 100.0,
            "spans": s, "profiled_ns": (int(102e9), int(104e9)),
            "trace": {"window_s": 2.0, "busy_s": 1.0, "program": {
                "idle_s": {"host": 0.01, "train.step": 0.02,
                           "model.layer": 0.5,
                           "train.step/train.microbatch/train.forward/"
                           "model.layer/moe.dispatch": 0.28},
                "device_s": {}}}}


def metric(name, rec):
    return run.reader(REPO, name).read(rec)


def test_the_serving_readers_read_the_ports_spans():
    rec = serve_record()
    assert metric("sched_ms.serve", rec) == pytest.approx((8 + 5 + 5) / 2)
    # 100 less the model (60), the sync (10) and the scheduler's passes
    assert metric("bookkeeping_ms.serve", rec) == pytest.approx(
        ((100 - 60 - 10 - 8 - 5) + (100 - 60 - 10 - 5)) / 2)
    assert metric("idle_in_model.serve", rec) == pytest.approx(10.0)
    assert metric("gather_share.serve", rec) == pytest.approx(60.0)
    assert metric("tier_copy_bytes_per_s.serve", rec) == pytest.approx(2.4)
    assert program.self_idle_share(rec, "engine.step") == pytest.approx(2.5)


def test_the_training_readers_read_the_ports_spans():
    rec = train_record()
    # the traced step's idle under a moe.dispatch, not the host's time
    assert metric("moe_dispatch_ms.train", rec) == pytest.approx(280.0)
    assert metric("idle_in_model.train", rec) == pytest.approx(39.0)
    assert program.self_idle_share(rec, "train.step") == pytest.approx(2.5)


NEW = ("sched_ms.serve", "bookkeeping_ms.serve", "idle_in_model.serve",
       "gather_share.serve", "tier_copy_bytes_per_s.serve",
       "moe_dispatch_ms.train", "idle_in_model.train")


@pytest.mark.parametrize("name", NEW)
def test_a_record_without_the_ports_records_reads_none(name):
    for rec in (serve_record(), train_record()):
        rec.pop("spans")
        rec["trace"].pop("program")
        rec["counters"] = ({"suspensions": 0}, {"suspensions": 1})
        assert metric(name, rec) is None
    assert set(traced.METRICS) == set(NEW)


def test_a_port_without_a_tracer_is_traced_by_nothing(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    out = {"kept": 1}
    with program.program_spans(out) as held:
        assert held is out
    assert out == {"kept": 1}


@pytest.mark.parametrize("on_s,starts,fine", [
    (99.999, [], True),            # training: just before the opening
    (100.004, [], True),
    (100.2, [], False),            # training: a step may have run untraced
    (99.9, [], False),             # on well before the window
    (100.3, [99.8, 100.4], True),  # serving: before the window's first tick
    (100.3, [99.8, 100.1, 100.4], False),  # a window tick ran untraced
])
def test_the_tracer_goes_on_at_the_windows_opening(on_s, starts, fine):
    if fine:
        traced.opened(on_s, 100.0, starts)
    else:
        with pytest.raises(RuntimeError):
            traced.opened(on_s, 100.0, starts)


# --------------------------------------------------------- a tiny run each
@pytest.mark.parametrize("cell,seconds", [("tiny-murs", 2),
                                          ("tiny-moe-train", 1)])
def test_a_tiny_cell_traced_reads_its_metrics(tiny_root, cell, seconds,
                                              monkeypatch):
    real = run.load

    def load(root, kind, name):
        mix = real(root, kind, name)
        if mix.get("kind") == "train":
            mix["slice_step"] = 0  # the window's first step, however slow
        return mix

    monkeypatch.setattr(run, "load", load)
    held = {}
    with traced.traced(True, held):
        out, _ = run.execute(tiny_root, cell, 2**31 + 11, seconds, True,
                             "cpu")
    assert out["correct"]
    rec = held["rec"]
    assert rec["spans"] and rec["obs_dropped"] == 0
    program_rec = rec["trace"]["program"]
    assert program_rec["clock_agrees"]
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    mix = next(w["traffic"] for w in spec["workloads"] if w["name"] == cell)
    full = {"tiny-murs": "serve-internlm2-murs",
            "tiny-moe-train": "train-granite-s2k"}[cell]
    got = traced.readings(rec, full, run.load(tiny_root, "traffic", mix),
                          held["costs"])
    if cell == "tiny-murs":
        for name in ("sched_ms.serve", "bookkeeping_ms.serve",
                     "tier_copy_bytes_per_s.serve"):
            assert got["metrics"][name] is not None, name
        assert got["metrics"]["bookkeeping_ms.serve"] > 0
        assert got["modeled"]["ticks"] > 0 and got["slowest_ticks"]
    else:
        # no kernel on the CPU: the whole slice is one gap, each stretch
        # of it under the span open through it, the model's among them
        assert 0.0 < got["metrics"]["moe_dispatch_ms.train"]
        assert 0.0 < got["metrics"]["idle_in_model.train"] <= 100.0
        assert {s.name for s in rec["spans"]} >= {
            "train.step", "train.backward", "moe.dispatch", "model.layer"}
    # the harness is as it was after the run
    from gpu_bench import port, serve

    assert serve.run.__module__ == "gpu_bench.serve"
    assert port.launches.__module__ == "gpu_bench.port"
