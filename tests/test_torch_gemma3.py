"""gemma3-1b, the sliding-window family, on the port against the JAX package.

``gemma3-1b.smoke()`` — (local ×5, global) ×2 + local ×2 = 14 layers,
window 16, one KV head (G = 4), tied embeddings — on the same bf16
parameters, made by the JAX package's ``init_model`` and carried across
by ``params_from_numpy``.  Local layers keep an O(window) ring cache;
prefill folds their K/V into it, decode writes at ``pos % window``.

* ``prefill`` and ``decode_step``, in two parameter dtypes.  In f32 the
  two sides differ only in the order of f32 sums: logits and caches
  within ``F32_ATOL`` = 1e-4 (measured at most 7e-6 on a CPU), which
  holds the ring layout and the window masks to the JAX package's.  In
  bf16, logits within ``LOGIT_ATOL`` = 0.1, the tolerance
  ``tests/test_torch_model.py`` states (measured at most 0.012 here).
  The bf16 caches drift further than that file's two-layer
  ``CACHE_ATOL``: each of the 14 layers adds a bf16 step or two of
  rounding (bf16 GEMMs accumulate in another order in the two
  frameworks) to the residual stream its K/V project, so the first
  layer's caches are equal and the deepest differ by up to 0.098;
  ``BF16_CACHE_ATOL`` = 0.125 on values of order 1.
* The ring wrap of ``tests/test_arch_smoke.py`` (window 4, a 10-token
  prompt, 8 decode steps that wrap the ring twice): each step's logits
  against the JAX decode chain and against the JAX full forward.
* One engine run (MURS, 3 slots, chunked prefill, a pool that forces
  suspensions): scheduling outcomes equal to the JAX engine's exactly,
  generated tokens equal except a bf16 near-tie, shown as in
  ``tests/test_torch_serve.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.models.transformer import forward  # noqa: E402
from repro.sched import MursConfig, MursPolicy  # noqa: E402
from repro.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

#: the logit tolerance stated and measured in tests/test_torch_model.py
LOGIT_ATOL = 0.1
BF16_CACHE_ATOL = 0.125  # 14 bf16 layers of drift (see above)
F32_ATOL = 1e-4  # f32 parameters: summation order only

CFG = ARCHS["gemma3-1b"].smoke()
TCFG = TARCHS["gemma3-1b"].smoke()


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def params():
    p = jm.init_model(CFG, jax.random.PRNGKey(0))
    return p, _port(p)


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def model(request, params):
    """(JAX params, port params, logit atol, cache atol) in one dtype."""
    if request.param == "bfloat16":
        return (*params, LOGIT_ATOL, BF16_CACHE_ATOL)
    p = jm.init_model(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return p, _port(p), F32_ATOL, F32_ATOL


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _t_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _t_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _t_leaves(t)]
    return [tree.float().numpy()]


def _close_logits(t_logits, j_logits, atol=LOGIT_ATOL):
    got, want = t_logits.numpy(), np.asarray(j_logits)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _close_caches(t_caches, j_caches, atol):
    got, want = _t_leaves(t_caches), _leaves_np(j_caches)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _tokens(seed, shape, vocab=CFG.vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, np.int32)


def test_param_tree_matches_and_ties_embeddings(params):
    """The port's own init gives the JAX tree: the same keys and shapes,
    and no ``lm_head`` (the embedding is tied)."""
    p, tp = params
    own = tm.init_model(TCFG, 0, device="cpu")
    assert "lm_head" not in own and "lm_head" not in tp
    flat, _ = jax.tree_util.tree_flatten_with_path(p)
    assert [tuple(x.shape) for _, x in flat] == \
        [tuple(t.shape) for t in _t_leaves(own)]


@pytest.mark.parametrize("s,max_seq", [(11, 24), (21, 32)])
def test_prefill(model, s, max_seq):
    """A prompt inside the window (ring padded) and one past it (ring
    folded: slot j holds the last position p with p % 16 == j)."""
    p, tp, logit_atol, cache_atol = model
    toks = _tokens(s, (2, s))
    jl, jc = jm.prefill(CFG, p, jnp.asarray(toks), max_seq=max_seq)
    tl, tc = tm.prefill(TCFG, tp, torch.from_numpy(toks), max_seq=max_seq)
    assert tc["unit"]["b0"][0].shape[3] == CFG.sliding_window
    assert tc["unit"]["b5"][0].shape[3] == max_seq
    _close_logits(tl, jl, logit_atol)
    _close_caches(tc, jc, cache_atol)


def test_decode_step(model):
    """A decode step after a prompt that wrapped the local rings, on
    caches the JAX prefill made."""
    p, tp, logit_atol, cache_atol = model
    toks = _tokens(1, (2, 20))
    _, jc = jm.prefill(CFG, p, jnp.asarray(toks), max_seq=32)
    tc = _port(jc)
    nxt = _tokens(2, (2, 1))
    jl, jc2 = jm.decode_step(CFG, p, jnp.asarray(nxt), jc, jnp.int32(20))
    tl, tc2 = tm.decode_step(TCFG, tp, torch.from_numpy(nxt), tc, 20)
    _close_logits(tl, jl, logit_atol)
    _close_caches(tc2, jc2, cache_atol)


def test_ring_buffer_wrap():
    """tests/test_arch_smoke.py's wrap case on the port: window 4, a
    10-token prompt, 8 decode steps (the ring wraps twice).  Each step's
    logits agree with the JAX decode chain and with the JAX full-sequence
    forward at that position."""
    cfg = dataclasses.replace(CFG, sliding_window=4)
    tcfg = dataclasses.replace(TCFG, sliding_window=4)
    key = jax.random.PRNGKey(0)
    p = jm.init_model(cfg, key)
    tp = _port(p)
    S, B, GEN = 10, 2, 8
    tokens = np.array(jax.random.randint(key, (B, S + GEN), 0, cfg.vocab),
                      np.int32)
    full = np.asarray(forward(cfg, p, jnp.asarray(tokens), remat=False))
    jl, jc = jm.prefill(cfg, p, jnp.asarray(tokens[:, :S]), max_seq=S + GEN,
                        remat=False)
    jdecode = jax.jit(lambda tok, caches, pos: jm.decode_step(
        cfg, p, tok, caches, pos))
    tl, tc = tm.prefill(tcfg, tp, torch.tensor(tokens[:, :S]),
                        max_seq=S + GEN)
    _close_logits(tl, jl)
    np.testing.assert_allclose(tl[:, -1].numpy(), full[:, S - 1],
                               atol=LOGIT_ATOL)
    for t in range(GEN):
        step = tokens[:, S + t:S + t + 1]
        jl, jc = jdecode(jnp.asarray(step), jc, jnp.int32(S + t))
        tl, tc = tm.decode_step(tcfg, tp, torch.from_numpy(step), tc, S + t)
        _close_logits(tl, jl)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, S + t],
                                   atol=LOGIT_ATOL)


def test_paged_path_refuses_sliding_windows():
    """Ring caches are not pool pages: gemma3 decodes on the dense path."""
    assert not tm.paged_decode_supported(TCFG)
    with pytest.raises(NotImplementedError, match="full-attention"):
        tm.decode_step_paged(TCFG, None, None, None, None, None, None, None,
                             None, None, page_tokens=16, n_pool=1)


# ------------------------------------------------------------ engine trace
def _requests(cls):
    """Two prompts past the window (40 tokens, chunked prefill at a
    32-token budget), three short ones, three on a shared 16-token
    prefix."""
    rng = np.random.default_rng(0)
    reqs = [cls(f"A{i}", "A", rng.integers(0, CFG.vocab, 40).tolist(), 12)
            for i in range(2)]
    reqs += [cls(f"B{i}", "B", rng.integers(0, CFG.vocab, 6).tolist(), 10)
             for i in range(3)]
    shared = rng.integers(0, CFG.vocab, 16).tolist()
    reqs += [cls(f"C{i}", "C", shared + [90 + i], 8) for i in range(3)]
    return reqs


#: 3.5 requests' worth of ring state: forces suspensions
CAPACITY = 3.5 * CFG.constant_state_bytes()
ENGINE = dict(n_slots=3, max_seq=64, hbm_capacity_bytes=CAPACITY,
              prefill_chunk_tokens=32)


@pytest.fixture(scope="module")
def engines(params):
    j = ServingEngine(
        CFG, params[0],
        EngineConfig(policy=MursPolicy(MursConfig.for_serving(period=1.0)),
                     **ENGINE),
    )
    t = tserve.ServingEngine(
        TCFG, params[1],
        tserve.EngineConfig(
            policy=tsched.MursPolicy(tsched.MursConfig.for_serving(period=1.0)),
            device="cpu", **ENGINE,
        ),
    )
    for eng, cls in ((j, Request), (t, tserve.Request)):
        for r in _requests(cls):
            eng.submit(r)
        eng.run(max_ticks=600)
    return j, t


def _rows(report):
    return [
        (o.request_id, o.tenant, o.outcome, o.submit_tick, o.finish_tick,
         o.first_token_tick, o.tokens, o.model)
        for o in report.outcomes
    ]


def test_engine_scheduling_outcomes_equal(engines):
    j, t = engines
    assert sorted(t.completed) == sorted(j.completed)
    assert len(t.completed) == 8 and not t.failed
    assert t.suspensions == j.suspensions > 0
    assert t.prefix_hits == j.prefix_hits > 0
    assert t.chunked_prefill_ticks == j.chunked_prefill_ticks > 0
    assert t.paged_decode_ticks == j.paged_decode_ticks == 0
    assert t.tick == j.tick
    assert _rows(t.report()) == _rows(j.report())


def test_engine_tokens_equal_or_near_tie(params, engines):
    """Where a request's tokens differ, every earlier token agrees and
    the JAX top-2 logit margin at the first differing step is below
    ``LOGIT_ATOL``: bf16 rounding flipped a near-tie."""
    j, t = engines
    flips = []
    for rid in j.completed:
        jr, tr = j.requests[rid], t.requests[rid]
        if jr.generated == tr.generated:
            continue
        k = next(i for i, (a, b) in enumerate(zip(jr.generated, tr.generated))
                 if a != b)
        logits, _ = jm.prefill(
            CFG, params[0], jnp.asarray([jr.prompt + jr.generated[:k]],
                                        jnp.int32))
        top = np.sort(np.asarray(logits[0, -1]))[::-1]
        margin = float(top[0] - top[1])
        assert margin < LOGIT_ATOL, (rid, k, margin)
        flips.append((rid, k, margin))
    assert len(flips) <= 2, flips
