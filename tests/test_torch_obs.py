"""The port's tracer (``repro_torch.obs``) and the spans the engine, the
model and the train step open: nesting, self time, parents per thread,
the bounded buffer, the off path, and a tiny engine run and train step
traced end to end.  Port only, on the CPU; a few seconds in all."""

from __future__ import annotations

import collections
import threading

import pytest
import torch

from repro_torch import obs
from repro_torch import sched as tsched
from repro_torch import serve as tserve
from repro_torch.configs import get_arch
from repro_torch.models import init_model
from repro_torch.optim import adamw
from repro_torch.serve.kv_cache import kv_bytes_per_token
from repro_torch.train import train_step as tstep


@pytest.fixture(autouse=True)
def _tracer_off():
    obs.disable()
    obs.collect()
    yield
    obs.disable()
    obs.collect()


def _by_id(spans):
    return {s.id: s for s in spans}


def _self_ns(span, spans):
    """The span's duration less that of its children."""
    kids = [s for s in spans if s.parent == span.id]
    return (span.t1_ns - span.t0_ns) - sum(k.t1_ns - k.t0_ns for k in kids)


def test_spans_nest_and_carry_their_attributes():
    obs.enable()
    with obs.span("outer", tick=3):
        with obs.span("inner.a"):
            pass
        with obs.span("inner.b", rid="r1"):
            with obs.span("leaf"):
                pass
    obs.count("bytes", 5)
    obs.count("bytes", 7)
    rec = obs.collect()
    spans = rec["spans"]
    assert [s.name for s in spans] == ["inner.a", "leaf", "inner.b",
                                       "outer"]  # in the order they close
    by = {s.name: s for s in spans}
    assert by["outer"].parent is None and by["outer"].attrs == {"tick": 3}
    assert by["inner.a"].parent == by["inner.b"].parent == by["outer"].id
    assert by["leaf"].parent == by["inner.b"].id
    assert by["inner.b"].attrs == {"rid": "r1"}
    for s in spans:
        assert s.t0_ns <= s.t1_ns
    outer = by["outer"]
    assert outer.t0_ns <= by["inner.a"].t0_ns <= by["inner.b"].t1_ns \
        <= outer.t1_ns
    assert 0 <= _self_ns(outer, spans) <= outer.t1_ns - outer.t0_ns
    assert rec["counters"] == {"bytes": 12} and rec["dropped"] == 0
    assert obs.collect()["spans"] == []  # collect empties the buffer


def test_each_thread_keeps_its_own_parents():
    obs.enable()
    seen = {}

    def worker():
        with obs.span("worker"):
            with obs.span("worker.child"):
                pass
        seen["thread"] = threading.get_ident()

    with obs.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    by = {s.name: s for s in obs.collect()["spans"]}
    assert by["worker"].parent is None  # not the main thread's span
    assert by["worker.child"].parent == by["worker"].id
    assert by["worker"].thread == seen["thread"] != by["main"].thread


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(obs, "LIMIT", 3)
    obs.enable()
    for _ in range(5):
        with obs.span("s"):
            pass
    rec = obs.collect()
    assert len(rec["spans"]) == 3 and rec["dropped"] == 2
    with obs.span("s"):
        pass
    assert len(obs.collect()["spans"]) == 1


def test_the_off_path_records_nothing_and_shares_one_object():
    a, b = obs.span("x", tick=1), obs.span("y")
    assert a is b
    with a:
        obs.count("n", 3)
    obs.enable()
    rec = obs.collect()
    assert rec == {"spans": [], "counters": {}, "dropped": 0}


def test_a_span_lies_on_the_profiler_timeline_while_one_runs():
    from torch.profiler import ProfilerActivity, profile

    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            torch.ones(4).add_(1)
    names = [e.name for e in prof.events()]
    assert "repro_torch.outer" in names
    with obs.span("after"):  # no profiler: no record_function
        pass
    assert [s.name for s in obs.collect()["spans"]] == ["outer", "after"]


# ------------------------------------------------------------- engine run
CFG = get_arch("internlm2-1.8b").smoke()


@pytest.fixture(scope="module")
def params():
    return init_model(CFG, 0, device="cpu")


def _engine_run(params, traced: bool):
    """The pressure trace of tests/test_torch_serve.py on a 6-page pool:
    MURS suspends, and three requests share a prefix."""
    R = tserve.Request
    reqs = [R(f"A{i}", "A", list(range(10, 18)), 24) for i in range(2)]
    reqs += [R(f"B{i}", "B", list(range(30, 34)), 6) for i in range(3)]
    reqs += [R(f"C{i}", "C", list(range(50, 66)) + [90 + i], 8)
             for i in range(3)]
    eng = tserve.ServingEngine(CFG, params, tserve.EngineConfig(
        n_slots=3, max_seq=64,
        hbm_capacity_bytes=kv_bytes_per_token(CFG) * 16 * 6,
        policy=tsched.MursPolicy(tsched.MursConfig.for_serving(period=1.0)),
        device="cpu"))
    for r in reqs:
        eng.submit(r)
    if traced:
        obs.enable()
    eng.run(max_ticks=600)
    obs.disable()
    return eng, obs.collect()


@pytest.fixture(scope="module")
def runs(params):
    """The run untraced, then traced."""
    plain, _ = _engine_run(params, traced=False)
    return (plain,) + _engine_run(params, traced=True)


def test_an_engine_tick_is_one_step_span_with_its_passes(runs):
    plain, eng, rec = runs
    assert {k: r.generated for k, r in eng.requests.items()} == {
        k: r.generated for k, r in plain.requests.items()}
    assert eng.tick == plain.tick and eng.suspensions == plain.suspensions > 0
    spans = rec["spans"]
    by_id = _by_id(spans)
    steps = [s for s in spans if s.name == "engine.step"]
    assert [s.attrs["tick"] for s in steps] == list(range(eng.tick))
    assert all(s.parent is None for s in steps)
    step_ids = {s.id for s in steps}
    children = collections.Counter(
        s.name for s in spans if s.parent in step_ids)
    for name in ("engine.admit", "engine.prefill", "engine.decode",
                 "engine.demote", "engine.tiers", "engine.reclaim"):
        assert children[name] == eng.tick, name
    assert children["engine.policy"] > 0

    def parent_name(s):
        return by_id[s.parent].name

    named = collections.defaultdict(list)
    for s in spans:
        named[s.name].append(s)
    paths = {s.attrs["path"] for s in named["engine.prefill.request"]}
    assert {"full", "cached", "continuation"} <= paths
    assert all(parent_name(s) == "engine.prefill"
               for s in named["engine.prefill.request"])
    for name in ("engine.decode.plan", "engine.decode.sync",
                 "engine.decode.bookkeeping"):
        assert named[name] and all(
            parent_name(s) == "engine.decode" for s in named[name]), name
    gathers = named["model.pool_gather"]
    assert len(gathers) == eng.paged_decode_ticks * CFG.n_layers
    assert all(parent_name(s) == "model.layer" for s in gathers)
    assert {by_id[s.parent].attrs["index"] for s in gathers} == set(
        range(CFG.n_layers))
    caps = named["engine.payload_capture"]
    assert len(caps) == eng.suspensions
    assert all(parent_name(s) == "engine.policy" for s in caps)
    assert eng.tier_d2h_bytes > 0 and plain.tier_d2h_bytes == \
        eng.tier_d2h_bytes
    # every step's children lie inside it
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns


def test_tick_costs_track_the_load(runs):
    eng = runs[0]
    stats = eng.tick_cost_stats()
    assert stats["ticks"] == eng.tick
    assert 0.0 < stats["min_s"] < stats["max_s"]
    assert "distinct" not in stats


# ------------------------------------------------------------- train step
def test_a_train_step_is_spanned_down_to_the_recomputed_experts():
    cfg = get_arch("granite-moe-3b-a800m").smoke()
    params = init_model(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (4, 16),
                        generator=torch.Generator().manual_seed(0))
    step = tstep.make_train_step(cfg, adamw.AdamWConfig(), microbatches=2,
                                 remat=True)
    obs.enable()
    step(params, adamw.init(params), {"tokens": tok, "labels": tok})
    spans = obs.collect()["spans"]
    count = collections.Counter(
        (s.name, s.attrs.get("recompute", False)) for s in spans)
    L = cfg.n_layers
    assert count[("train.step", False)] == 1
    assert count[("train.optimizer", False)] == 1
    for name in ("train.microbatch", "train.forward", "train.backward"):
        assert count[(name, False)] == 2, name
    for name in ("model.layer", "moe.route", "moe.dispatch", "moe.experts",
                 "moe.combine"):
        # the forward, then the backward's recompute of every layer
        assert count[(name, False)] == count[(name, True)] == 2 * L, name
    by_id = _by_id(spans)
    top = next(s for s in spans if s.name == "train.step")
    for s in spans:
        if s.name in ("train.microbatch", "train.optimizer"):
            assert s.parent == top.id
        if s.name in ("train.forward", "train.backward"):
            assert by_id[s.parent].name == "train.microbatch"
    recomputed = [s for s in spans
                  if s.name == "model.layer" and s.attrs.get("recompute")]
    backward = [s for s in spans if s.name == "train.backward"]
    for s in recomputed:  # inside some backward, whatever the thread
        assert any(b.t0_ns <= s.t0_ns <= s.t1_ns <= b.t1_ns
                   for b in backward)
