"""The port's serving layer against the JAX package's.

* The same random alloc / share / COW / freeze / demote / promote / evict
  stream (the shape of ``tests/test_ledger.py``) drives both copies of
  ``kv_cache`` / ``ledger`` / ``tiers``: ledger recounts, page tables,
  ``gather_plan`` output and the int8 codes of demoted pages must be
  equal after every op.
* ``quantize`` gives the JAX package's codes byte for byte.
* The ``_pressure_requests`` trace of ``tests/test_paged_serving.py``
  runs through the JAX engine and the port's CPU engine on the same bf16
  parameters: scheduling outcomes must be equal exactly, and so must the
  generated tokens — except where bf16 rounding flips a near-tie, which
  the test then shows: every earlier token agrees and the JAX top-2 logit
  margin at the first differing step is below ``LOGIT_ATOL``, the
  tolerance ``test_torch_model.py`` states for the logits.
* The port's paged and dense decode paths give identical tokens.
* A request migrates between two port engines (slot cache, or frozen
  page payloads when suspended) and completes.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.dist.compression import quantize as jquantize  # noqa: E402
from repro.models import init_model, prefill  # noqa: E402
from repro.sched import MursConfig, MursPolicy  # noqa: E402
from repro.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro.serve import PagedKVManager, TierConfig  # noqa: E402
from repro.serve.kv_cache import kv_bytes_per_token  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.dist.compression import quantize as tquantize  # noqa: E402
from repro_torch.kernels import ops, paged_decode  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

#: the logit tolerance stated (and measured) in test_torch_model.py
LOGIT_ATOL = 0.1

CFG = ARCHS["internlm2-1.8b"].smoke()
TCFG = TARCHS["internlm2-1.8b"].smoke()


# ------------------------------------------------------- bookkeeping stream
def _mgr(cls, tier_cls, cfg):
    mgr = cls(
        capacity_bytes=0.0,
        page_tokens=16,
        enable_prefix_cache=True,
        tier_config=tier_cls(host_capacity_bytes=1e12),
    )
    mgr.capacity_bytes = mgr.page_bytes_for(cfg) * 24
    return mgr


def _recount(mgr):
    return {
        (tenant, cls.value, tier): round(v, 6)
        for (tenant, cls, tier), v in mgr.ledger.recount().items()
    }


def _tier_codes(mgr):
    out = {}
    for key, block in mgr.tiers._blocks.items():
        out[key] = (
            None if block.codes is None else np.asarray(block.codes),
            block.scale,
        )
    return out


def _assert_same(jm, tm, live):
    assert _recount(jm) == _recount(tm)
    for rid in live:
        assert jm.page_table(rid) == tm.page_table(rid)
    resident = [r for r in live if all(p >= 0 for p in jm.page_table(r))]
    if resident:
        jp = jm.gather_plan(resident, list(range(len(resident))))
        tp = tm.gather_plan(resident, list(range(len(resident))))
        for a, b in zip(jp[:3], tp[:3]):
            np.testing.assert_array_equal(a, b)
        assert jp[3] == tp[3]
    jc, tc = _tier_codes(jm), _tier_codes(tm)
    assert jc.keys() == tc.keys()
    for key in jc:
        if jc[key][0] is None:
            assert tc[key][0] is None
        else:
            np.testing.assert_array_equal(jc[key][0], tc[key][0])
            assert np.float32(jc[key][1]) == np.float32(tc[key][1])


OPS = ["register", "grow", "match", "insert", "cow", "freeze", "thaw",
       "demote", "demote_cold", "promote", "tick", "evict_cache", "release"]


@pytest.mark.parametrize("seed", range(6))
def test_bookkeeping_streams_agree(seed):
    rng = random.Random(seed)
    prng = np.random.default_rng(seed)
    jm = _mgr(PagedKVManager, TierConfig, CFG)
    tm = _mgr(tserve.PagedKVManager, tserve.TierConfig, TCFG)
    streams = [[(seed + i * 131 + j) % 997 for j in range(24 * 16)]
               for i in range(4)]
    live, tokens, frozen = [], {}, set()
    now, counter = 0.0, 0
    for _ in range(80):
        op = rng.choice(OPS)
        pick, amount = rng.randrange(8), rng.randrange(1, 97)
        now += 1.0
        both = (jm, tm)
        if op == "register":
            rid = f"r{counter}"
            counter += 1
            for m, cfg in ((jm, CFG), (tm, TCFG)):
                m.register(rid, cfg, tenant=f"t{pick % 3}")
            tokens[rid] = streams[pick % 4]
            live.append(rid)
        elif op == "grow" and live:
            rid = live[pick % len(live)]
            for m in both:
                m.grow_to(rid, min(amount * 4, len(tokens[rid])))
        elif op == "match" and live:
            rid = live[pick % len(live)]
            if jm._alloc is not None and jm._alloc.pages_held(rid) == 0:
                assert jm.match_prefix(rid, tokens[rid], now) == \
                    tm.match_prefix(rid, tokens[rid], now)
        elif op == "insert" and live:
            rid = live[pick % len(live)]
            held = jm._alloc.pages_held(rid) if jm._alloc else 0
            if held > 0:
                for m in both:
                    m.insert_prefix(rid, tokens[rid][: held * 16], "g",
                                    (pick % 4,), now)
        elif op == "cow" and live:
            rid = live[pick % len(live)]
            held = jm._alloc.pages_held(rid) if jm._alloc else 0
            if held > 0:
                for m in both:
                    m.make_private(rid, pick % held)
        elif op == "freeze" and live:
            rid = live[pick % len(live)]
            for m in both:
                m.set_frozen(rid, True)
            frozen.add(rid)
        elif op == "thaw" and frozen:
            rid = rng.choice(sorted(frozen))
            if rid in live:
                for m in both:
                    m.set_frozen(rid, False)
            frozen.discard(rid)
        elif op == "demote" and live:
            rid = live[pick % len(live)]
            idxs = jm.demotable_indices(rid)
            assert idxs == tm.demotable_indices(rid)
            if idxs:
                payload = prng.standard_normal(64).astype(np.float32)
                payload[0] = 2.5 * (pick + 1)  # ties at .5 after scaling
                for m in both:
                    m.demote_page(rid, idxs[pick % len(idxs)],
                                  payload.copy(), now)
        elif op == "demote_cold":
            assert jm.demote_cold_page(now) == tm.demote_cold_page(now)
        elif op == "promote" and live:
            rid = live[pick % len(live)]
            for m in both:
                m.promote_request(rid, 2, now)
        elif op == "tick":
            jt, tt = jm.tick_tiers(now), tm.tick_tiers(now)
            assert [(r, i) for r, i, _ in jt] == [(r, i) for r, i, _ in tt]
            for (_, _, a), (_, _, b) in zip(jt, tt):
                if a is None:
                    assert b is None
                else:
                    np.testing.assert_array_equal(np.asarray(a), b)
        elif op == "evict_cache":
            assert jm.evict_cache(1 + pick % 3) == tm.evict_cache(1 + pick % 3)
        elif op == "release" and live:
            rid = live.pop(pick % len(live))
            frozen.discard(rid)
            tokens.pop(rid, None)
            for m in both:
                m.release(rid)
        _assert_same(jm, tm, live)
        assert tm.ledger.matches_recount()


def test_quantize_codes_match_byte_for_byte():
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-3, 300.0):
        x = (rng.standard_normal(257) * scale).astype(np.float32)
        x[:4] = [0.5, -1.5, 2.5, 0.0]  # half-way values: round to even
        jq, js = jquantize(jnp.asarray(x))
        tq, ts = tquantize(x)
        assert np.asarray(jq).tobytes() == tq.tobytes()
        assert np.float32(js) == ts
    zq, zs = tquantize(np.zeros(8, np.float32))
    jzq, jzs = jquantize(jnp.zeros(8, jnp.float32))
    assert np.asarray(jzq).tobytes() == zq.tobytes()
    assert np.float32(jzs) == zs


# ------------------------------------------------------------ engine trace
def _pressure_requests(request_cls):
    """tests/test_paged_serving.py's trace: two heavy A requests, three
    light B requests and three C requests sharing a 16-token prefix."""
    reqs = [request_cls(f"A{i}", "A", list(range(10, 18)), 24)
            for i in range(2)]
    reqs += [request_cls(f"B{i}", "B", list(range(30, 34)), 6)
             for i in range(3)]
    shared = list(range(50, 66))
    reqs += [request_cls(f"C{i}", "C", shared + [90 + i], 8)
             for i in range(3)]
    return reqs


CAPACITY = kv_bytes_per_token(CFG) * 16 * 6  # 6-page pool: forces suspends


@pytest.fixture(scope="module")
def params():
    p = init_model(CFG, jax.random.PRNGKey(0))
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def jax_engine(params):
    eng = ServingEngine(
        CFG, params[0],
        EngineConfig(n_slots=3, max_seq=64, hbm_capacity_bytes=CAPACITY,
                     policy=MursPolicy(MursConfig.for_serving(period=1.0))),
    )
    for r in _pressure_requests(Request):
        eng.submit(r)
    eng.run(max_ticks=600)
    return eng


def _port_engine(params, **kw):
    eng = tserve.ServingEngine(
        TCFG, params[1],
        tserve.EngineConfig(
            n_slots=3, max_seq=64, hbm_capacity_bytes=CAPACITY,
            policy=tsched.MursPolicy(tsched.MursConfig.for_serving(period=1.0)),
            device="cpu", **kw,
        ),
    )
    for r in _pressure_requests(tserve.Request):
        eng.submit(r)
    eng.run(max_ticks=600)
    return eng


@pytest.fixture(scope="module")
def port_engine(params):
    ops.reset_launch_counts()
    return _port_engine(params)


def _rows(report):
    return [
        (o.request_id, o.tenant, o.outcome, o.submit_tick, o.finish_tick,
         o.first_token_tick, o.tokens, o.model)
        for o in report.outcomes
    ]


def test_scheduling_outcomes_equal(jax_engine, port_engine):
    j, t = jax_engine, port_engine
    assert sorted(t.completed) == sorted(j.completed)
    assert len(t.completed) == 8 and not t.failed
    assert t.suspensions == j.suspensions > 0
    assert t.prefix_hits == j.prefix_hits > 0
    assert t.paged_decode_ticks == j.paged_decode_ticks > 0
    assert t.tick == j.tick
    assert _rows(t.report()) == _rows(j.report())


def _margin(params, tokens):
    """JAX top-2 margin of the next-token logits after ``tokens``."""
    logits, _ = prefill(CFG, params, jnp.asarray([tokens], jnp.int32))
    top = np.sort(np.asarray(logits[0, -1]))[::-1]
    return float(top[0] - top[1])


def test_generated_tokens_equal_or_near_tie(params, jax_engine, port_engine):
    flips = []
    for rid in jax_engine.completed:
        jr, tr = jax_engine.requests[rid], port_engine.requests[rid]
        if jr.generated == tr.generated:
            continue
        k = next(i for i, (a, b) in enumerate(zip(jr.generated, tr.generated))
                 if a != b)
        margin = _margin(params[0], jr.prompt + jr.generated[:k])
        assert margin < LOGIT_ATOL, (rid, k, margin)
        flips.append((rid, k, margin))
    # at most a near-tie or two on this trace; the rest are bit-identical
    assert len(flips) <= 2, flips


def test_port_paged_and_dense_tokens_identical(params, port_engine):
    dense = _port_engine(params, paged_decode=False)
    assert dense.paged_decode_ticks == 0
    assert sorted(dense.completed) == sorted(port_engine.completed)
    for rid in dense.completed:
        assert port_engine.requests[rid].generated == \
            dense.requests[rid].generated, rid


def test_int8_path_completes_every_request(params):
    eng = _port_engine(params, paged_decode_int8=True)
    assert len(eng.completed) == 8 and not eng.failed
    assert eng.paged_int8_ticks == eng.paged_decode_ticks > 0


def test_cpu_engine_launches_no_kernel(port_engine):
    assert port_engine.paged_decode_ticks > 0
    assert paged_decode.paged_decode_attention.launches == 0
    assert paged_decode.paged_decode_attention_int8.launches == 0


# --------------------------------------------------------------- migration
def _single_request_engine(params, capacity_tokens=200, n_slots=2):
    return tserve.ServingEngine(
        TCFG, params[1],
        tserve.EngineConfig(
            n_slots=n_slots, max_seq=64,
            hbm_capacity_bytes=kv_bytes_per_token(CFG) * capacity_tokens,
            policy=tsched.MursPolicy(tsched.MursConfig.for_serving()),
            device="cpu",
        ),
    )


def test_mid_decode_migration_keeps_tokens(params):
    """export_request → import_request between two port engines carries
    the slot cache across bit for bit: the request finishes on the target
    with the tokens an unmigrated run gives (the JAX package's
    tests/test_cluster.py invariant, engine to engine)."""
    ref = _single_request_engine(params)
    ref.submit(tserve.Request("r", "T", list(range(10, 18)), 16))
    ref.run(max_ticks=200)
    src = _single_request_engine(params)
    src.submit(tserve.Request("r", "T", list(range(10, 18)), 16))
    for _ in range(6):
        src.step()
    src_bytes = src.kv.request_bytes("r")
    ticket = src.export_request("r")
    assert ticket.slot_cache is not None and src_bytes > 0
    assert ticket.raw_bytes == pytest.approx(src_bytes)
    assert "r" not in src.requests and src.kv.request_bytes("r") == 0.0
    dst = _single_request_engine(params)
    dst.import_request(ticket)
    dst.run(max_ticks=200)
    assert dst.requests["r"].state == "done"
    assert dst.requests["r"].generated == ref.requests["r"].generated


def test_suspended_request_migrates_with_page_payloads(params):
    """A slotless (suspended) request ships its frozen page payloads; the
    target installs them page by page and completes it."""
    src = _single_request_engine(params, capacity_tokens=60)
    for i in range(3):
        src.submit(tserve.Request(f"A{i}", "A", list(range(10, 18)), 24))
    victim = None
    for _ in range(60):
        src.step()
        victim = next((r for r in src._live.values()
                       if r.state == "suspended"), None)
        if victim is not None:
            break
    assert victim is not None, "pressure never suspended anyone"
    ticket = src.export_request(victim.request_id)
    assert ticket.slot_cache is None and ticket.page_payloads
    dst = _single_request_engine(params)
    dst.import_request(ticket)
    dst.run(max_ticks=300)
    assert dst.requests[victim.request_id].state == "done"
    assert len(dst.requests[victim.request_id].generated) == 24
