"""Logits of the port's three model entry points against the JAX package.

``prefill``, ``decode_step`` and ``decode_step_paged`` (f32 kernel and
int8 kernel) run on the same bf16 parameters — made by the JAX package's
``init_model`` and carried across by ``params_from_numpy`` — on the same
token and cache inputs.  Two configurations: ``internlm2-1.8b.smoke()``
(hd 16, G = 1) and one full-width layer (d 2048, hd 128, G = 2, vocab
512).  The JAX side's Pallas kernel runs in interpret mode.

Tolerance: the residual stream and every projection are bf16 on both
sides, rounded from f32 sums taken in different orders, so hidden states
differ by a bf16 step here and there and the f32 logits drift by a few
hundredths.  ``LOGIT_ATOL`` = 0.1 on logits of order 1; the largest gap
measured on a CPU was 0.029 (smoke) and 0.023 (full-width layer).  The
bf16 caches of the first layer agree to a bf16 step; a later layer's K/V
project a residual stream that has already drifted, so ``CACHE_ATOL`` =
0.05 on values of order 1 (measured at most 0.031, two steps at |x| ≥ 2).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro import models as jm  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

LOGIT_ATOL = 0.1
CACHE_ATOL = 0.05


def _cfgs(name):
    """(jax cfg, port cfg) — the same ArchConfig values on both sides."""
    base, tbase = ARCHS["internlm2-1.8b"], TARCHS["internlm2-1.8b"]
    if name == "smoke":
        return base.smoke(), tbase.smoke()
    kw = dict(name="internlm2-1.8b-1layer", n_layers=1, vocab=512)
    return dataclasses.replace(base, **kw), dataclasses.replace(tbase, **kw)


@pytest.fixture(scope="module", params=["smoke", "full_width_1layer"])
def model(request):
    cfg, tcfg = _cfgs(request.param)
    params = jm.init_model(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu"
    )
    return cfg, tcfg, params, tparams


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _t_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _t_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _t_leaves(t)]
    return [tree.float().numpy()]


def _close_logits(t_logits, j_logits):
    got = t_logits.numpy()
    want = np.asarray(j_logits)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def _close_caches(t_caches, j_caches):
    for got, want in zip(_t_leaves(t_caches), _leaves_np(j_caches)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=CACHE_ATOL, rtol=0)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, np.int32)


def test_prefill(model):
    cfg, tcfg, params, tparams = model
    toks = _tokens(0, (2, 11), cfg.vocab)
    jl, jc = jm.prefill(cfg, params, jnp.asarray(toks), max_seq=24)
    tl, tc = tm.prefill(tcfg, tparams, torch.from_numpy(toks), max_seq=24)
    _close_logits(tl, jl)
    _close_caches(tc, jc)


def _prefilled(model, lens, max_seq):
    """Per-slot caches from JAX prefills of ``lens`` tokens each, stacked
    on the slot axis, plus the same caches as torch tensors."""
    cfg, tcfg, params, _ = model
    slots = []
    for i, n in enumerate(lens):
        toks = _tokens(10 + i, (1, n), cfg.vocab)
        _, c = jm.prefill(cfg, params, jnp.asarray(toks), max_seq=max_seq)
        slots.append(c)
    jc = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=1 if xs[0].ndim == 5 else 0),
        *slots,
    )
    return jc, params_from_numpy(jax.tree_util.tree_map(np.asarray, jc), "cpu")


def test_decode_step(model):
    cfg, tcfg, params, tparams = model
    jc, tc = _prefilled(model, [7, 7], max_seq=16)
    toks = _tokens(1, (2, 1), cfg.vocab)
    jl, jc2 = jm.decode_step(cfg, params, jnp.asarray(toks), jc, jnp.int32(7))
    tl, tc2 = tm.decode_step(tcfg, tparams, torch.from_numpy(toks), tc, 7)
    _close_logits(tl, jl)
    _close_caches(tc2, jc2)


def _paged_inputs(lens, n_slots, page, pad_to):
    """An engine-shaped paged batch: rows = slots in order (longest
    first), each slot's logical pages mapped to fresh pool ids, padded to
    ``pad_to`` rows with pad rows at slot ``n_slots``."""
    rows = len(lens)
    tables, src_slot, src_idx = [], [], []
    pid = 0
    for slot, n in enumerate(lens):
        need = n // page + 1  # the page the new token lands in
        row = []
        for j in range(need):
            row.append(pid)
            src_slot.append(slot)
            src_idx.append(j)
            pid += 1
        tables.append(row)
    n_pool = 1 << max(pid - 1, 0).bit_length()
    w = 1 << max(max(len(r) for r in tables) - 1, 0).bit_length()
    tab = np.zeros((pad_to, w), np.int32)
    for r, row in enumerate(tables):
        tab[r, :len(row)] = row
    s_slot = np.zeros(n_pool, np.int32)
    s_idx = np.zeros(n_pool, np.int32)
    s_slot[:pid], s_idx[:pid] = src_slot, src_idx
    row_slot = np.full(pad_to, n_slots, np.int32)
    row_slot[:rows] = np.arange(rows)
    poss = np.zeros(pad_to, np.int32)
    poss[:rows] = lens
    seq = np.zeros(pad_to, np.int32)
    seq[:rows] = np.asarray(lens) + 1
    return row_slot, poss, tab, seq, s_slot, s_idx, n_pool


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_paged(model, int8):
    cfg, tcfg, params, tparams = model
    lens, page = [13, 6, 9], 4
    jc, tc = _prefilled(model, lens, max_seq=20)
    row_slot, poss, tab, seq, s_slot, s_idx, n_pool = _paged_inputs(
        lens, n_slots=3, page=page, pad_to=4
    )
    toks = _tokens(2, (4, 1), cfg.vocab)
    args = (toks, poss, row_slot, tab, seq, s_slot, s_idx)
    jl, jc2 = jm.decode_step_paged(
        cfg, params, jnp.asarray(toks), jc, *map(jnp.asarray, args[1:]),
        page_tokens=page, n_pool=n_pool, interpret=True, int8=int8,
    )
    tl, tc2 = tm.decode_step_paged(
        tcfg, tparams, torch.from_numpy(toks), tc,
        *map(torch.from_numpy, args[1:]),
        page_tokens=page, n_pool=n_pool, int8=int8,
    )
    rows = len(lens)
    _close_logits(tl[:rows], jl[:rows])
    _close_caches(tc2, jc2)


def test_quantize_pool_int8_matches():
    """The int8 pool quantizer gives the JAX package's codes and scales
    on the same bf16 pool (never-written zero pages included)."""
    from repro.models.transformer import _quantize_pool_int8 as jq
    from repro_torch.models.transformer import _quantize_pool_int8 as tq
    import ml_dtypes

    rng = np.random.default_rng(3)
    pool = rng.standard_normal((6, 4, 16), dtype=np.float32) * 3
    pool[2] = 0.0
    pool = pool.astype(ml_dtypes.bfloat16)
    jc, js = jq(jnp.asarray(pool))
    tc, ts = tq(params_from_numpy(pool, "cpu"))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_unsupported_arch_raises():
    cfg = dataclasses.replace(
        TARCHS["internlm2-1.8b"].smoke(), block_pattern=("local_attn",)
    )
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.init_model(cfg, 0, device="cpu")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_model(TARCHS["internlm2-1.8b"].smoke(), 0)
