"""mamba2-2.7b and zamba2-1.2b, the SSM and hybrid families, on the port
against the JAX package.

``mamba2-2.7b.smoke()`` — 2 Mamba-2 layers, d 64, d_inner 128, 8 heads of
16, ds 16, chunk 32, vocab 512 — and ``zamba2-1.2b.smoke()`` — (mamba
×5, shared_attn) ×2 + mamba ×2 = 14 layers, the shared attention body 4
heads of 16 — on the same parameters, made by the JAX package's
``init_model`` and carried across by ``params_from_numpy``.

* The parameter trees: same keys, shapes and dtypes (the f32 leaves
  ``A_log``, ``D``, ``dt_bias`` stay f32; zamba2's ``shared_body``
  crosses).
* ``prefill`` and ``decode_step`` logits and caches.  In f32 within
  ``F32_ATOL`` = 1e-4 (summation order only; measured at most 6e-6).  In
  bf16 the logits within ``BF16_LOGIT_ATOL``: 0.1 for mamba2, the
  tolerance ``tests/test_torch_model.py`` states, and 0.15 for zamba2.
  Both frameworks round the same f32 sums to bf16, but bf16 GEMMs
  accumulate in another order, so a Mamba block's output differs in a
  few elements by one ulp on equal inputs, and the recurrence carries
  that forward: the logits of a pure Mamba-2 stack differ by 0.023 at 2
  layers, 0.075 at 7 and 0.12 at 14 (measured on a CPU); zamba2 smoke,
  12 Mamba layers, by up to 0.090 in the cases below, mamba2 smoke by
  up to 0.031.  bf16 caches within ``BF16_CACHE_ATOL`` = 0.25: measured
  at most 0.17 on zamba2 (a deep shared-attention K/V of magnitude
  about 2, eleven bf16 ulps there) and 0.02 on mamba2.
* Engine parity for both models: MURS, 3 slots, a pool of a few
  requests' constant state (it queues and suspends), chunked prefill:
  scheduling outcomes equal to the JAX engine's exactly; tokens equal,
  or the first differing token is a near-tie, its top-2 margin in the
  JAX engine's own logits (recorded as it runs) below the model's bf16
  logit tolerance.
* The constant-state tests of the JAX package, mirrored: a zero-capacity
  pool serves mamba2 (``tests/test_tiers.py``), and an unpaged arch keeps
  the dense path under ``paged_decode=True``
  (``tests/test_paged_serving.py``).
* Two faults of the reference, matched (ROADMAP Queue 3): zamba2's
  partial prefix hit installs the snapshot's whole-prompt Mamba state,
  so the hit request's tokens differ with and without the prefix cache
  in the JAX engine, and the port gives the JAX engine's cached tokens;
  a one-token prompt's conv tail repeats the token, and a two-token one
  cannot be installed.
"""

import contextlib
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.sched import MursConfig, MursPolicy  # noqa: E402
from repro.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

F32_ATOL = 1e-4
BF16_LOGIT_ATOL = {"mamba2-2.7b": 0.1, "zamba2-1.2b": 0.15}
#: bf16 caches (conv tails, attention K/V) and the f32 SSD state after
#: the drift above (see the module docstring)
BF16_CACHE_ATOL = 0.25
NAMES = ("mamba2-2.7b", "zamba2-1.2b")


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _cfgs(name):
    return ARCHS[name].smoke(), TARCHS[name].smoke()


@pytest.fixture(scope="module", params=[(n, d) for n in NAMES
                                        for d in ("bfloat16", "float32")],
                ids=lambda nd: f"{nd[0]}-{nd[1]}")
def model(request):
    """(name, JAX params, port params, logit atol, cache atol)."""
    name, dtype = request.param
    cfg, _ = _cfgs(name)
    p = jm.init_model(cfg, jax.random.PRNGKey(0), dtype=jnp.dtype(dtype))
    if dtype == "bfloat16":
        return name, p, _port(p), BF16_LOGIT_ATOL[name], BF16_CACHE_ATOL
    return name, p, _port(p), F32_ATOL, F32_ATOL


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, atol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _close_caches(tc, jc, atol):
    jl = jax.tree_util.tree_leaves(jc)
    tl = jax.tree_util.tree_leaves(tc)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        _close(t, j, atol)


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_matches(name):
    cfg, tcfg = _cfgs(name)
    j = _port(jm.init_model(cfg, jax.random.PRNGKey(0)))
    t = tm.init_model(tcfg, 0, device="cpu")
    jl, js = jax.tree_util.tree_flatten(j)
    tl, ts = jax.tree_util.tree_flatten(t)
    assert js == ts
    assert [(x.shape, x.dtype) for x in tl] == [(x.shape, x.dtype) for x in jl]
    for tree in (j, t):
        m = tree["layers"]["b0"]["mamba"]
        assert all(m[k].dtype == torch.float32
                   for k in ("A_log", "D", "dt_bias"))
        assert m["w_x"].dtype == torch.bfloat16
        assert ("shared_body" in tree) == (name == "zamba2-1.2b")


@pytest.mark.parametrize("s,max_seq", [(45, 64), (64, 64), (20, 48)])
def test_prefill(model, s, max_seq):
    """Ragged, whole-chunk and sub-chunk prompts: last-position logits and
    every cache leaf (conv tails, SSD states, shared-attention K/V padded
    to ``max_seq``)."""
    name, p, tp, atol, cache_atol = model
    cfg, tcfg = _cfgs(name)
    toks = _tokens(s, (2, s))
    jl, jc = jm.prefill(cfg, p, jnp.asarray(toks), max_seq=max_seq)
    tl, tc = tm.prefill(tcfg, tp, torch.from_numpy(toks), max_seq=max_seq)
    _close(tl, jl, atol)
    _close_caches(tc, jc, cache_atol)


def test_decode_step(model):
    """Four decode steps from a prefill, the caches written in place."""
    name, p, tp, atol, cache_atol = model
    cfg, tcfg = _cfgs(name)
    toks = _tokens(1, (2, 37))
    _, jc = jm.prefill(cfg, p, jnp.asarray(toks), max_seq=48)
    _, tc = tm.prefill(tcfg, tp, torch.from_numpy(toks), max_seq=48)
    # one compile for the four steps (each eager call traces its scan)
    j_decode = jax.jit(lambda p, t, c, pos: jm.decode_step(cfg, p, t, c, pos))
    for step in range(4):
        nxt = _tokens(10 + step, (2, 1))
        jl, jc = j_decode(p, jnp.asarray(nxt), jc, jnp.int32(37 + step))
        tl, out = tm.decode_step(tcfg, tp, torch.from_numpy(nxt), tc,
                                 37 + step)
        assert out is tc
        _close(tl, jl, atol)
    _close_caches(tc, jc, cache_atol)


def test_unpaged_arch_keeps_the_dense_path():
    """tests/test_paged_serving.py on the port: both SSM models decode on
    the dense path even when the flag asks for the paged kernel."""
    for name in NAMES:
        _, tcfg = _cfgs(name)
        assert not tm.paged_decode_supported(tcfg)
        eng = tserve.ServingEngine(
            tcfg, tm.init_model(tcfg, 0, device="cpu"),
            tserve.EngineConfig(n_slots=2, max_seq=32,
                                hbm_capacity_bytes=1e9, paged_decode=True,
                                device="cpu"),
        )
        eng.submit(tserve.Request("r0", "A", list(range(5, 10)), 4))
        eng.run(max_ticks=60)
        assert eng.completed == ["r0"]
        assert eng.paged_decode_ticks == 0


def test_zero_capacity_engine_serves_constant_state():
    """tests/test_tiers.py on the port: a mamba engine with a zero-byte
    KV pool admits and completes requests, and its pool reads empty."""
    _, tcfg = _cfgs("mamba2-2.7b")
    eng = tserve.ServingEngine(
        tcfg, tm.init_model(tcfg, 0, device="cpu"),
        tserve.EngineConfig(n_slots=2, max_seq=32, hbm_capacity_bytes=0.0,
                            device="cpu"),
    )
    eng.submit(tserve.Request("r0", "T", list(range(6)), 4))
    eng.submit(tserve.Request("r1", "U", list(range(8)), 4))
    out = eng.run(max_ticks=200).extras
    assert out["failed"] == 0 and out["completed"] == 2
    assert eng.kv.used_fraction == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_launcher_serves(name, monkeypatch):
    """``python -m repro_torch.launch.serve --arch <name> --device cpu``."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", name,
                                      "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.main()
    assert "[MURS] completed 7/7  failed 0" in out.getvalue()


# ------------------------------------------------------------ engine trace
def _requests(cls):
    """Two A requests (8-token prompts, 12 new), three B requests (4, 6)
    and three C requests sharing a 16-token prefix plus one token of
    their own (C1 and C2 hit C0's prefix), all at tick 0."""
    rng = np.random.default_rng(0)
    reqs = [cls(f"A{i}", "A", rng.integers(0, 512, 8).tolist(), 12)
            for i in range(2)]
    reqs += [cls(f"B{i}", "B", rng.integers(0, 512, 4).tolist(), 6)
             for i in range(3)]
    shared = rng.integers(0, 512, 16).tolist()
    reqs += [cls(f"C{i}", "C", shared + [90 + i], 8) for i in range(3)]
    return reqs


#: HBM budget in requests' worth of constant state, plus 64 tokens of
#: shared-attention KV for zamba2: both queue and suspend at 3 slots
POOL_STATES = {"mamba2-2.7b": 1.5, "zamba2-1.2b": 3.5}


#: jitted model calls by (model, slots, max_seq): see _jax_engine
_COMPILED = {}


def _jax_engine(cfg, params, ecfg):
    """A JAX engine that takes the jitted model calls of the first engine
    of the same model, slot count and max_seq: they close over the
    config and max_seq alone, so they are the same functions, and the
    JAX package compiles zamba2 smoke's prefill in about 15 s on a CPU."""
    eng = ServingEngine(cfg, params, ecfg)
    fns = _COMPILED.setdefault(
        (cfg.name, ecfg.n_slots, ecfg.max_seq),
        (eng._prefill, eng._decode_all, eng._chunk_scan),
    )
    eng._prefill, eng._decode_all, eng._chunk_scan = fns
    return eng


def _margin(logits):
    top = np.sort(np.asarray(logits, np.float32).reshape(-1))[::-1]
    return float(top[0] - top[1])


def _record_margins(eng):
    """Wrap the JAX engine's dense decode and its prefill finish so that
    the top-2 margin of the logits behind every sampled token is kept:
    {(request id, token index): margin}."""
    margins, last = {}, {}
    decode_all = eng._decode_all

    def recording_decode_all(*args):
        logits, caches = decode_all(*args)
        last["logits"] = np.asarray(logits[:, 0], np.float32)
        return logits, caches

    dense = eng._decode_dense_batch

    def recording_dense(active):
        nxt = dense(active)
        for i, req in active:
            margins[(req.request_id, len(req.generated))] = _margin(
                last["logits"][i])
        return nxt

    finish = eng._finish_prefill

    def recording_finish(req, last_logits):
        if not req.generated:
            margins[(req.request_id, 0)] = _margin(last_logits)
        return finish(req, last_logits)

    eng._decode_all = recording_decode_all
    eng._decode_dense_batch = recording_dense
    eng._finish_prefill = recording_finish
    return margins


@pytest.fixture(scope="module", params=NAMES)
def engines(request):
    name = request.param
    cfg, tcfg = _cfgs(name)
    p = jm.init_model(cfg, jax.random.PRNGKey(0))
    engine = dict(n_slots=3, max_seq=128, hbm_capacity_bytes=(
        POOL_STATES[name] * cfg.constant_state_bytes()
        + 64 * cfg.kv_bytes_per_token()))
    j = _jax_engine(cfg, p, EngineConfig(
        policy=MursPolicy(MursConfig.for_serving(period=1.0)), **engine))
    margins = _record_margins(j)
    t = tserve.ServingEngine(tcfg, _port(p), tserve.EngineConfig(
        policy=tsched.MursPolicy(tsched.MursConfig.for_serving(period=1.0)),
        device="cpu", **engine))
    for eng, cls in ((j, Request), (t, tserve.Request)):
        for r in _requests(cls):
            eng.submit(r)
        eng.run(max_ticks=600)
    return name, j, t, margins


def _rows(report):
    return [
        (o.request_id, o.tenant, o.outcome, o.submit_tick, o.finish_tick,
         o.first_token_tick, o.tokens, o.model)
        for o in report.outcomes
    ]


def test_engine_scheduling_outcomes_equal(engines):
    name, j, t, _ = engines
    assert sorted(t.completed) == sorted(j.completed)
    assert len(t.completed) == 8 and not t.failed
    assert t.suspensions == j.suspensions > 0
    assert t.prefix_hits == j.prefix_hits
    # mamba2 keeps no pages, so it publishes no prefix; zamba2 does
    assert (t.prefix_hits > 0) == (name == "zamba2-1.2b")
    assert t.chunked_prefill_ticks == j.chunked_prefill_ticks
    assert t.paged_decode_ticks == j.paged_decode_ticks == 0
    assert t.tick == j.tick
    assert _rows(t.report()) == _rows(j.report())


def test_engine_tokens_equal_or_near_tie(engines):
    """Where a request's tokens differ, every earlier token agrees and
    the JAX engine's top-2 margin at the first differing token is below
    the model's bf16 logit tolerance: bf16 rounding flipped a near-tie."""
    name, j, t, margins = engines
    for rid in j.completed:
        jr, tr = j.requests[rid], t.requests[rid]
        assert len(tr.generated) == len(jr.generated)
        if jr.generated == tr.generated:
            continue
        k = next(i for i, (a, b) in enumerate(zip(jr.generated, tr.generated))
                 if a != b)
        assert margins[(rid, k)] < BF16_LOGIT_ATOL[name], (rid, k)


# ----------------------------------------------------------- reference faults
def _fault_run(port, cfg, params, prefix_cache):
    """zamba2 smoke, 3 slots: c0 is a 16-token prompt (one page) plus
    token 300; c1 the same 16 tokens plus token 301, submitted at tick 12
    (after c0 published its prefix).  Returns (c1's tokens, prefix
    hits)."""
    prompt = _tokens(16, 16).tolist()
    if port:
        eng = tserve.ServingEngine(cfg, params, tserve.EngineConfig(
            n_slots=3, max_seq=128, hbm_capacity_bytes=1e9,
            policy=tsched.MursPolicy(tsched.MursConfig.for_serving(
                period=1.0)),
            prefix_cache=prefix_cache, device="cpu"))
    else:
        eng = _jax_engine(cfg, params, EngineConfig(
            n_slots=3, max_seq=128, hbm_capacity_bytes=1e9,
            policy=MursPolicy(MursConfig.for_serving(period=1.0)),
            prefix_cache=prefix_cache))
    cls = tserve.Request if port else Request
    eng.submit(cls("c0", "A", prompt + [300], 6))
    while eng.tick < 12:
        eng.step()
    eng.submit(cls("c1", "B", prompt + [301], 6))
    eng.run(max_ticks=200)
    assert sorted(eng.completed) == ["c0", "c1"]
    return eng.requests["c1"].generated, eng.prefix_hits


def test_zamba2_partial_prefix_hit_matches_the_reference_fault():
    """The JAX engine installs c0's whole slot snapshot for c1's partial
    hit — Mamba conv tails and SSD state after token 300, which cannot be
    rewound to position 16 as KV pages can — then feeds token 301 on top:
    c1's tokens differ from the run without the prefix cache (the right
    ones).  The port gives the JAX engine's cached tokens."""
    cfg, tcfg = _cfgs("zamba2-1.2b")
    p = jm.init_model(cfg, jax.random.PRNGKey(0))
    cached, hits = _fault_run(False, cfg, p, True)
    uncached, no_hits = _fault_run(False, cfg, p, False)
    assert hits == 1 and no_hits == 0
    assert cached != uncached
    port, port_hits = _fault_run(True, tcfg, _port(p), True)
    assert port_hits == 1
    assert port == cached


def _short_prompt(cls, engine_cls, cfg_cls, cfg, params, n, **kw):
    eng = engine_cls(cfg, params, cfg_cls(n_slots=2, max_seq=40,
                                          hbm_capacity_bytes=1e9, **kw))
    eng.submit(cls("r", "A", list(range(5, 5 + n)), 4))
    eng.run(max_ticks=50)
    return eng.requests["r"].generated


def test_short_prompts_match_the_reference():
    """A one-token prompt's single conv-tail row fills all d_conv - 1 rows
    of the slot's tail in the JAX engine (its ``.at[].set`` broadcasts),
    where the recurrence would have zeros before the token; the port's
    ``copy_`` broadcasts the same and gives the same tokens.  A two-token
    prompt cannot be installed: JAX raises on the shapes, the port with a
    message."""
    cfg, tcfg = _cfgs("mamba2-2.7b")
    p = jm.init_model(cfg, jax.random.PRNGKey(0))
    jax_run = (Request, ServingEngine, EngineConfig, cfg, p)
    port_run = (tserve.Request, tserve.ServingEngine, tserve.EngineConfig,
                tcfg, _port(p))
    assert (_short_prompt(*port_run, 1, device="cpu")
            == _short_prompt(*jax_run, 1))
    with pytest.raises(ValueError, match="broadcast"):
        _short_prompt(*jax_run, 2)
    with pytest.raises(ValueError, match="d_conv - 1"):
        _short_prompt(*port_run, 2, device="cpu")
