"""granite-moe-3b-a800m, the MoE family, on the port against the JAX package.

``granite-moe-3b-a800m.smoke()`` — 2 attention layers, d 64, 8 experts
top-2, d_ff_expert 64, tied embeddings — on the same parameters, made by
the JAX package's ``init_model`` and carried across by
``params_from_numpy``.

* K5's plain version, ``ref.grouped_matmul_ref``, against the Pallas
  ``grouped_matmul`` in interpret mode and against the JAX package's
  ``grouped_matmul_ref``: f32 within ``F32_ATOL`` = 1e-5 (summation order
  only); bf16 within one bf16 ulp of max |y| (both round one f32 sum).
* ``moe_dispatch_row``: slot, token and keep exactly equal to JAX's,
  also where capacity drops entries; the renormalised top-k gates within
  ``GATE_ATOL`` = 1e-6 (XLA and torch compute ``exp`` differently: they
  differ by an f32 ulp or two, measured at most 3e-8), and the
  dispatched rows bit for bit.
* ``moe_forward`` with s == 1 (one batch-wide group, and one group per
  row) and s > 1, f32 within ``F32_ATOL``.  Eight near-identical decode
  rows make the batch-wide dispatch drop rows 4–7's experts (capacity 4,
  every row wants the same two experts), which the per-row dispatch of
  the JAX engine's dense path never does: both JAX behaviours, and the
  port matching each.
* ``prefill``, ``decode_step`` (both dispatches) and ``decode_step_paged``
  logits against JAX: f32 within 1e-4, bf16 within ``LOGIT_ATOL`` = 0.1
  as in ``tests/test_torch_gemma3.py``.
* One engine run per decode path (paged and dense), each against the JAX
  engine on the same path: scheduling outcomes equal exactly, generated
  tokens equal except a bf16 near-tie.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.roofline.analysis import tick_cost_model as j_tick_cost  # noqa: E402
from repro.sched import MursConfig, MursPolicy  # noqa: E402
from repro.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.kernels import grouped_matmul as tgmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.roofline.analysis import tick_cost_model  # noqa: E402
from repro_torch.serve.kv_cache import kv_bytes_per_token  # noqa: E402

LOGIT_ATOL = 0.1  # bf16 logits, as tests/test_torch_model.py states
F32_ATOL = 1e-5  # f32 against f32: summation order only
F32_LOGIT_ATOL = 1e-4  # f32 parameters through a whole model
GATE_ATOL = 1e-6  # the two frameworks' exp differ by an f32 ulp or two

NAME = "granite-moe-3b-a800m"
CFG = ARCHS[NAME].smoke()
TCFG = TARCHS[NAME].smoke()


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _bf16_ulp(y):
    return 2.0 ** (math.floor(math.log2(float(np.abs(y).max()))) - 7)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------- K5 plain
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", [
    (3, 5, 72, 40),  # ragged: no block multiple anywhere
    (8, 4, 64, 64),  # smoke decode: gate/up
    (8, 4, 64, 96),  # wider output
    (2, 16, 96, 24),  # a prefill's capacity
])
def test_grouped_matmul_ref_matches_jax(dtype, e, c, d, f):
    rng = np.random.default_rng(e * 100 + c)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / math.sqrt(d)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    pallas = np.asarray(jops.grouped_matmul(jx, jw, interpret=True),
                        np.float32)
    oracle = np.asarray(jref.grouped_matmul_ref(jx, jw), np.float32)
    got = ref.grouped_matmul_ref(_port(jx), _port(jw))
    assert got.dtype == getattr(torch, dtype) and got.shape == (e, c, f)
    atol = F32_ATOL if dtype == "float32" else _bf16_ulp(oracle)
    np.testing.assert_allclose(_np(got), pallas, atol=atol, rtol=0)
    np.testing.assert_allclose(_np(got), oracle, atol=atol, rtol=0)


#: K5's chunk of D (``kBK`` in ``csrc/grouped_matmul.cu``)
K5_CHUNK = 64


def _blocked_gmm(x, w):
    """K5's bf16 sum order in plain torch: each output element sums its
    64-deep chunks of D in order in f32 (each chunk's products summed
    inside the tensor cores), and the total rounds once to x's dtype."""
    d = x.shape[2]
    xf, wf = x.float(), w.float()
    acc = torch.zeros(x.shape[0], x.shape[1], w.shape[2])
    for k0 in range(0, d, K5_CHUNK):
        k = slice(k0, k0 + K5_CHUNK)
        acc = acc + torch.bmm(xf[:, :, k], wf[:, k])
    return acc.to(x.dtype)


# (E, C, D, F) at narrow widths: a decode capacity, a ragged C, C past
# one 64-row tile and C over two, with D no multiple of the chunk and F
# narrower than a 128-column tile (the Pallas kernel takes C, D up to its
# blocks or multiples of them)
BLOCKED_GMM = [
    (2, 4, 488, 40),
    (3, 37, 456, 24),
    (2, 100, 200, 48),
    (1, 256, 136, 8),
]


@pytest.mark.parametrize("e,c,d,f", BLOCKED_GMM)
def test_blocked_gmm_matches_ref_and_jax(e, c, d, f):
    rng = np.random.default_rng(e * 1000 + c + d)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / math.sqrt(d)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    pallas = np.asarray(jops.grouped_matmul(jx, jw, interpret=True),
                        np.float32)
    oracle = np.asarray(jref.grouped_matmul_ref(jx, jw), np.float32)
    tx, tw = _port(jx), _port(jw)
    got = _blocked_gmm(tx, tw)
    assert got.dtype == torch.bfloat16
    plain = ref.grouped_matmul_ref(tx, tw)
    atol = _bf16_ulp(oracle)
    np.testing.assert_allclose(_np(got), _np(plain), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(got), pallas, atol=atol, rtol=0)
    np.testing.assert_allclose(_np(got), oracle, atol=atol, rtol=0)


def test_grouped_matmul_ops_takes_the_plain_version_on_cpu():
    """On CPU tensors ``ops.grouped_matmul`` is the plain version and the
    kernel's launch count stays where it was."""
    before = tgmm.grouped_matmul.launches
    x = torch.randn(3, 5, 8)
    w = torch.randn(3, 8, 4)
    assert torch.equal(ops.grouped_matmul(x, w), ref.grouped_matmul_ref(x, w))
    assert tgmm.grouped_matmul.launches == before
    assert tgmm.grouped_matmul in ops.WRAPPERS
    with pytest.raises(ValueError, match="CUDA"):
        tgmm.grouped_matmul(x, w)


# ---------------------------------------------------------------- dispatch
def _gates(rng, shape):
    g = rng.standard_normal(shape).astype(np.float32)
    g = np.exp(g - g.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


def _near_identical_rows(rng, rows=8, d=64, noise=1e-3):
    base = rng.standard_normal((1, d)).astype(np.float32)
    return (base + noise * rng.standard_normal((rows, d))).astype(np.float32)


DISPATCH_CASES = {
    # (groups, tokens, capacity): a prefill-like group that fits, one
    # that overflows, the decode capacity of a batch of 8
    "fits": (3, 6, 8),
    "overflows": (2, 40, 8),
    "decode_batch": (1, 8, 4),
}


@pytest.mark.parametrize("case", [*DISPATCH_CASES, "near_identical_rows"])
def test_dispatch_matches_jax(case):
    rng = np.random.default_rng(7)
    e, k, d = CFG.moe.num_experts, CFG.moe.top_k, CFG.d_model
    if case == "near_identical_rows":
        # the forced overflow: 8 rows all choose the same two experts
        x = _near_identical_rows(rng)[None]
        router = rng.standard_normal((d, e)).astype(np.float32) / 8
        logits = x @ router
        g = np.exp(logits - logits.max(-1, keepdims=True))
        gates = (g / g.sum(-1, keepdims=True)).astype(np.float32)
        cap = 4
    else:
        groups, n, cap = DISPATCH_CASES[case]
        x = rng.standard_normal((groups, n, d)).astype(np.float32)
        gates = _gates(rng, (groups, n, e))
    want = jax.vmap(lambda xr, gr: jblocks.moe_dispatch_row(xr, gr, k, cap))(
        jnp.asarray(x), jnp.asarray(gates))
    xe, slot, tok, gate, keep = tblocks.moe_dispatch_row(
        torch.from_numpy(x), torch.from_numpy(gates), k, cap)
    for got, exp in ((slot, want[1]), (tok, want[2]), (keep, want[4])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    np.testing.assert_allclose(gate.numpy(), np.asarray(want[3]),
                               atol=GATE_ATOL, rtol=0)
    g = x.shape[0]
    per_group = xe.reshape(e, g, cap, d).permute(1, 0, 2, 3).reshape(
        g, e * cap, d)
    np.testing.assert_array_equal(per_group.numpy(), np.asarray(want[0]))
    if case == "near_identical_rows":
        # rows 0-3 fill both experts' 4 slots; rows 4-7 lose them
        dropped = np.unique(tok.numpy()[~keep.numpy()])
        assert dropped.tolist() == [4, 5, 6, 7]
    if case == "overflows":
        assert (~keep).any()


def test_top_k_ties_break_toward_the_lower_index():
    """``lax.top_k`` keeps the lower index among equal gates."""
    gates = np.full((1, 3, CFG.moe.num_experts), 0.125, np.float32)
    gates[0, 1, 5] = 0.5
    x = np.ones((1, 3, CFG.d_model), np.float32)
    want = jblocks.moe_dispatch_row(jnp.asarray(x[0]), jnp.asarray(gates[0]),
                                    2, 8)
    _, slot, tok, _, _ = tblocks.moe_dispatch_row(
        torch.from_numpy(x), torch.from_numpy(gates), 2, 8)
    np.testing.assert_array_equal(slot[0].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(tok[0].numpy(), np.asarray(want[2]))


# ------------------------------------------------------------- moe_forward
@pytest.fixture(scope="module")
def moe_f32():
    p = jblocks.init_moe(jax.random.PRNGKey(0), CFG, jnp.float32)
    return p, _port(p)


@pytest.mark.parametrize("shape", [(3, 1, 64), (8, 1, 64), (2, 9, 64),
                                   (1, 40, 64)])
def test_moe_forward_matches_jax(moe_f32, shape):
    p, tp = moe_f32
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    want = np.asarray(jblocks.moe_forward(p, CFG, jnp.asarray(x)))
    got = tblocks.moe_forward(tp, TCFG, torch.from_numpy(x))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_batch_wide_decode_drops_where_per_row_does_not(moe_f32):
    """The JAX package's two decode dispatches differ for MoE: the
    batch-wide ``decode_step`` (the paged engine path) drops rows 4-7's
    experts on 8 near-identical rows; the per-slot vmapped step (the
    dense engine path) drops nothing.  The port matches each."""
    p, tp = moe_f32
    x = _near_identical_rows(np.random.default_rng(1))[:, None]
    batch = np.asarray(jblocks.moe_forward(p, CFG, jnp.asarray(x)))
    per_row = np.concatenate([
        np.asarray(jblocks.moe_forward(p, CFG, jnp.asarray(x[i:i + 1])))
        for i in range(len(x))
    ])
    gap = np.abs(batch - per_row).max(axis=(1, 2))
    assert (gap[:4] <= F32_ATOL).all() and (gap[4:] > LOGIT_ATOL).all(), gap
    t_batch = tblocks.moe_forward(tp, TCFG, torch.from_numpy(x))
    t_rows = tblocks.moe_forward(tp, TCFG, torch.from_numpy(x), per_row=True)
    np.testing.assert_allclose(t_batch.numpy(), batch, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(t_rows.numpy(), per_row, atol=F32_ATOL, rtol=0)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def params():
    p = jm.init_model(CFG, jax.random.PRNGKey(0))
    return p, _port(p)


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def model(request, params):
    """(JAX params, port params, logit atol) in one dtype."""
    if request.param == "bfloat16":
        return (*params, LOGIT_ATOL)
    p = jm.init_model(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return p, _port(p), F32_LOGIT_ATOL


def _close(t_logits, j_logits, atol):
    got, want = t_logits.numpy(), np.asarray(j_logits)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab, shape, np.int32)


def _t_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _t_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _t_leaves(t)]
    return [tree]


def test_param_tree_crosses(params):
    """The port's own init and the carried-across JAX tree agree in keys,
    shapes and dtypes: the router stays f32, the experts are stacked
    [L, E, ·, ·] bf16."""
    p, tp = params
    own = tm.init_model(TCFG, 0, device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(p)
    assert [(tuple(x.shape), str(x.dtype)) for _, x in flat] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
         for t in _t_leaves(own)]
    moe = tp["layers"]["b0"]["moe"]
    L, E, d, f = 2, CFG.moe.num_experts, CFG.d_model, CFG.moe.d_ff_expert
    assert moe["router"].dtype == torch.float32
    assert moe["router"].shape == (L, d, E)
    for name, shape in (("gate", (L, E, d, f)), ("up", (L, E, d, f)),
                        ("down", (L, E, f, d))):
        assert moe[name].dtype == torch.bfloat16
        assert moe[name].shape == shape
        np.testing.assert_array_equal(
            _np(moe[name]), np.asarray(p["layers"]["b0"]["moe"][name],
                                       np.float32))


@pytest.mark.parametrize("s", [1, 11])
def test_prefill(model, s):
    """A one-token prompt takes the s == 1 dispatch, as in JAX."""
    p, tp, atol = model
    toks = _tokens(s, (2, s))
    jl, _ = jm.prefill(CFG, p, jnp.asarray(toks), max_seq=16)
    tl, _ = tm.prefill(TCFG, tp, torch.from_numpy(toks), max_seq=16)
    _close(tl, jl, atol)


def test_shared_expert_prefill_matches_jax():
    """A stack with a shared expert beside the routed ones (``shared_mlp``,
    added to the MoE output as in the JAX package), f32."""
    moe = dataclasses.replace(CFG.moe, num_shared_experts=1, d_ff_shared=32)
    cfg = dataclasses.replace(CFG, moe=moe)
    tcfg = dataclasses.replace(TCFG, moe=dataclasses.replace(
        TCFG.moe, num_shared_experts=1, d_ff_shared=32))
    p = jm.init_model(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    assert "shared_mlp" in p["layers"]["b0"]
    assert "shared_mlp" in tm.init_model(tcfg, 0, device="cpu")["layers"]["b0"]
    toks = _tokens(5, (2, 9))
    jl, _ = jm.prefill(cfg, p, jnp.asarray(toks), max_seq=16)
    tl, _ = tm.prefill(tcfg, _port(p), torch.from_numpy(toks), max_seq=16)
    _close(tl, jl, F32_LOGIT_ATOL)


def _prefilled(p, lens, max_seq):
    """Per-slot caches from JAX prefills, stacked on the slot axis."""
    slots = []
    for i, n in enumerate(lens):
        _, c = jm.prefill(CFG, p, jnp.asarray(_tokens(10 + i, (1, n))),
                          max_seq=max_seq)
        slots.append(c)
    return jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=1 if xs[0].ndim == 5 else 0),
        *slots,
    )


def _jax_per_row_decode(p, toks, jc, pos):
    """JAX's decode_step run one row at a time: the JAX engine's per-slot
    vmapped step, one dispatch group per row."""
    return np.concatenate([
        np.asarray(jm.decode_step(
            CFG, p, jnp.asarray(toks[i:i + 1]),
            jax.tree_util.tree_map(lambda x: x[:, i:i + 1], jc),
            jnp.int32(pos[i]),
        )[0])
        for i in range(len(toks))
    ])


def test_decode_step(model):
    """The port's decode_step dispatches each row as its own group, so it
    matches JAX's decode_step run one row at a time, at per-row positions
    and at one shared int position (the batch-wide dispatch is held to
    JAX by test_moe_forward_matches_jax and test_decode_step_paged)."""
    p, tp, atol = model
    lens = [7, 5, 9, 3]
    jc = _prefilled(p, lens, max_seq=16)
    toks = _tokens(1, (len(lens), 1))
    pos = np.asarray(lens, np.int32)
    jl = _jax_per_row_decode(p, toks, jc, pos)
    tl, _ = tm.decode_step(TCFG, tp, torch.from_numpy(toks), _port(jc),
                           torch.from_numpy(pos))
    _close(tl, jl, atol)
    jc = _prefilled(p, [6] * 4, max_seq=16)
    jl = _jax_per_row_decode(p, toks, jc, [6] * 4)
    tl, _ = tm.decode_step(TCFG, tp, torch.from_numpy(toks), _port(jc), 6)
    _close(tl, jl, atol)


def test_decode_step_paged(model):
    """Three rows and a pad row (token 0, last) in one capacity group."""
    p, tp, atol = model
    lens, page, n_slots = [13, 6, 9], 4, 3
    jc = _prefilled(p, lens, max_seq=20)
    tables, s_slot, s_idx, pid = [], [], [], 0
    for slot, n in enumerate(lens):
        need = n // page + 1
        tables.append(list(range(pid, pid + need)))
        s_slot += [slot] * need
        s_idx += list(range(need))
        pid += need
    n_pool = 1 << (pid - 1).bit_length()
    tab = np.zeros((4, 4), np.int32)
    for r, row in enumerate(tables):
        tab[r, :len(row)] = row
    pad = n_pool - pid
    args = (
        np.asarray(lens + [0], np.int32),  # poss
        np.asarray([0, 1, 2, n_slots], np.int32),  # row_slot
        tab,
        np.asarray([n + 1 for n in lens] + [0], np.int32),  # seq_lens
        np.asarray(s_slot + [0] * pad, np.int32),
        np.asarray(s_idx + [0] * pad, np.int32),
    )
    toks = _tokens(2, (4, 1))
    toks[3] = 0
    jl, _ = jm.decode_step_paged(
        CFG, p, jnp.asarray(toks), jc, *map(jnp.asarray, args),
        page_tokens=page, n_pool=n_pool, interpret=True,
    )
    tl, _ = tm.decode_step_paged(
        TCFG, tp, torch.from_numpy(toks), _port(jc),
        *map(torch.from_numpy, args), page_tokens=page, n_pool=n_pool,
    )
    _close(tl[:3], np.asarray(jl)[:3], atol)


def test_tick_cost_prices_active_params_as_jax():
    """The tick-cost model takes granite through ``active_param_count``
    with the JAX package's coefficients (only the card's constants
    differ)."""
    cfg, tcfg = ARCHS[NAME], TARCHS[NAME]
    a, b = j_tick_cost(cfg), tick_cost_model(tcfg)
    for field in ("weight_bytes", "active_params", "kv_write_bytes_per_token",
                  "act_bytes_per_token", "page_bytes"):
        assert getattr(a, field) == getattr(b, field), field
    assert b.active_params == tcfg.active_param_count() < \
        tcfg.param_count() / 3


# ------------------------------------------------------------ engine trace
def _requests(cls):
    """tests/test_paged_serving.py's pressure trace: two heavy A requests,
    three light B requests and three C requests sharing a 16-token
    prefix."""
    reqs = [cls(f"A{i}", "A", list(range(10, 18)), 24) for i in range(2)]
    reqs += [cls(f"B{i}", "B", list(range(30, 34)), 6) for i in range(3)]
    shared = list(range(50, 66))
    reqs += [cls(f"C{i}", "C", shared + [90 + i], 8) for i in range(3)]
    return reqs


CAPACITY = kv_bytes_per_token(TCFG) * 16 * 6  # 6-page pool: forces suspends
ENGINE = dict(n_slots=3, max_seq=64, hbm_capacity_bytes=CAPACITY)


@pytest.fixture(scope="module", params=["paged", "dense"])
def engines(request, params):
    paged = request.param == "paged"
    j = ServingEngine(
        CFG, params[0],
        EngineConfig(policy=MursPolicy(MursConfig.for_serving(period=1.0)),
                     paged_decode=paged, **ENGINE),
    )
    t = tserve.ServingEngine(
        TCFG, params[1],
        tserve.EngineConfig(
            policy=tsched.MursPolicy(tsched.MursConfig.for_serving(period=1.0)),
            paged_decode=paged, device="cpu", **ENGINE,
        ),
    )
    for eng, cls in ((j, Request), (t, tserve.Request)):
        for r in _requests(cls):
            eng.submit(r)
        eng.run(max_ticks=600)
    return paged, j, t


def _rows(report):
    return [
        (o.request_id, o.tenant, o.outcome, o.submit_tick, o.finish_tick,
         o.first_token_tick, o.tokens, o.model)
        for o in report.outcomes
    ]


def test_engine_scheduling_outcomes_equal(engines):
    paged, j, t = engines
    assert sorted(t.completed) == sorted(j.completed)
    assert len(t.completed) == 8 and not t.failed
    assert t.suspensions == j.suspensions > 0
    assert t.prefix_hits == j.prefix_hits > 0
    assert t.paged_decode_ticks == j.paged_decode_ticks
    assert (t.paged_decode_ticks > 0) == paged
    assert t.tick == j.tick
    assert _rows(t.report()) == _rows(j.report())


def test_engine_tokens_equal_or_near_tie(params, engines):
    """Where a request's tokens differ, every earlier token agrees and
    the JAX top-2 logit margin at the first differing step is below
    ``LOGIT_ATOL``: bf16 rounding flipped a near-tie.  Requests with one
    prompt (the three B requests) flip together: a flip is counted once
    per distinct context."""
    _, j, t = engines
    flips = {}
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
        flips.setdefault(tuple(jr.prompt + jr.generated[:k]), []).append(
            (rid, k, margin))
    assert len(flips) <= 2, flips


def test_unsupported_moe_neighbours_still_raise():
    """MoE is admitted, and so is an MoE stack with MLA attention
    (deepseek-v2's; ``tests/test_torch_zoo.py`` holds it to JAX): its
    blocks carry MLA weights and the MoE FFN.  An MoE stack of Mamba
    blocks without SSM dims still raises."""
    from repro_torch.configs import MLAConfig

    cfg = dataclasses.replace(TCFG, mla=MLAConfig())
    blk = tm.init_model(cfg, 0, device="cpu")["layers"]["b0"]
    assert {"wq_a", "wkv_a", "wkv_b", "wo"} <= set(blk["attn"])
    assert "moe" in blk
    with pytest.raises(ValueError, match="block program"):
        tm.init_model(dataclasses.replace(TCFG, block_pattern=("mamba",)), 0,
                      device="cpu")
