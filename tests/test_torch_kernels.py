"""Paged-decode kernels of the port against the JAX package's.

The plain PyTorch versions of K1 (``paged_decode_attention``) and K2
(``paged_decode_attention_int8``) are held against the jnp oracles in
``repro.kernels.ref`` and against the Pallas kernels run in interpret mode
through ``repro.kernels.ops`` — the same inputs, made from a seed with
numpy, on both sides.  f32 throughout, atol 1e-5: the two sides differ
only in the order of f32 sums.  So is ``_split_merge_paged``, K1's own
arithmetic restated in plain torch (rows grouped by kv head, the page
sweep split, the splits merged in order), and ``decode_step_paged`` is
checked to fold its rows into the groups that arithmetic assumes.  The
CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.dist.compression import quantize as jquantize  # noqa: E402
from repro_torch.kernels import ops, paged_decode  # noqa: E402

ATOL = 1e-5  # f32 against f32: summation order only


def _case(seed, bh, max_pages, page, hd, zero_row=False):
    rng = np.random.default_rng(seed)
    n_pool = bh * max_pages + 3
    q = rng.standard_normal((bh, hd), dtype=np.float32)
    k = rng.standard_normal((n_pool, page, hd), dtype=np.float32)
    v = rng.standard_normal((n_pool, page, hd), dtype=np.float32)
    table = rng.permutation(n_pool)[: bh * max_pages].reshape(bh, max_pages)
    lens = rng.integers(1, max_pages * page + 1, size=bh)
    if zero_row:
        lens[-1] = 0  # an engine pad row: attends nothing
    return q, k, v, table.astype(np.int32), lens.astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# the sweep of tests/test_kernels.py (bh 1-4, pages 1-4, page 16|32,
# hd 32|64) at fixed seeds, one zero-length row, and the serving path's
# shapes (hd 128, page 16)
K1_CASES = [
    (0, 1, 1, 16, 32, False),
    (1, 4, 4, 32, 64, False),
    (2, 3, 2, 16, 64, False),
    (3, 2, 3, 32, 32, False),
    (4, 4, 1, 16, 32, False),
    (5, 3, 4, 16, 64, True),
    (6, 4, 4, 16, 128, False),
]


@pytest.mark.parametrize("seed,bh,max_pages,page,hd,zero_row", K1_CASES)
def test_paged_decode_plain_matches_jax(seed, bh, max_pages, page, hd,
                                        zero_row):
    q, k, v, table, lens = _case(seed, bh, max_pages, page, hd, zero_row)
    out = ops.paged_decode_attention(*_t(q, k, v, table, lens)).numpy()
    gold = np.asarray(jref.paged_decode_attention_ref(q, k, v, table, lens))
    pallas = np.asarray(
        jops.paged_decode_attention(q, k, v, table, lens, interpret=True)
    )
    np.testing.assert_allclose(out, gold, atol=ATOL)
    np.testing.assert_allclose(out, pallas, atol=ATOL)
    assert np.isfinite(out).all()


def test_zero_length_row_is_mean_of_v():
    """seq_len == 0 masks every token with the finite NEG_INF: the row
    averages V over all table pages instead of giving NaN."""
    q, k, v, table, lens = _case(7, 2, 2, 16, 32, zero_row=True)
    out = ops.paged_decode_attention(*_t(q, k, v, table, lens)).numpy()
    mean_v = v[table[-1]].reshape(-1, 32).mean(axis=0)
    np.testing.assert_allclose(out[-1], mean_v, atol=ATOL)


def _quantized_case(seed, bh, max_pages, hd=64, page=16, zero_row=False):
    q, kf, vf, table, lens = _case(seed, bh, max_pages, page, hd, zero_row)
    kq, ks = zip(*(jquantize(jnp.asarray(p)) for p in kf))
    vq, vs = zip(*(jquantize(jnp.asarray(p)) for p in vf))
    kq = np.stack([np.asarray(c) for c in kq])
    vq = np.stack([np.asarray(c) for c in vq])
    ks = np.asarray(ks, np.float32)
    vs = np.asarray(vs, np.float32)
    return q, kq, vq, ks, vs, table, lens


K2_CASES = [
    (0, 1, 1, 64, False),
    (1, 4, 3, 64, False),
    (2, 2, 2, 64, True),
    (3, 3, 2, 128, False),
]


@pytest.mark.parametrize("seed,bh,max_pages,hd,zero_row", K2_CASES)
def test_paged_decode_int8_plain_matches_jax(seed, bh, max_pages, hd,
                                             zero_row):
    args = _quantized_case(seed, bh, max_pages, hd=hd, zero_row=zero_row)
    out = ops.paged_decode_attention_int8(*_t(*args)).numpy()
    gold = np.asarray(jref.paged_decode_attention_int8_ref(*args))
    pallas = np.asarray(
        jops.paged_decode_attention_int8(*args, interpret=True)
    )
    np.testing.assert_allclose(out, gold, atol=ATOL)
    np.testing.assert_allclose(out, pallas, atol=ATOL)


def test_bf16_output_keeps_q_dtype():
    q, k, v, table, lens = _case(8, 2, 2, 16, 32)
    tq, tk, tv, tt, tl = _t(q, k, v, table, lens)
    out = ops.paged_decode_attention(
        tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), tt, tl
    )
    assert out.dtype == torch.bfloat16 and out.shape == (2, 32)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors ``ops`` runs the plain version: no kernel launch."""
    ops.reset_launch_counts()
    q, k, v, table, lens = _case(9, 2, 2, 16, 32)
    ops.paged_decode_attention(*_t(q, k, v, table, lens))
    ops.paged_decode_attention_int8(*_t(*_quantized_case(9, 2, 2)))
    assert paged_decode.paged_decode_attention.launches == 0
    assert paged_decode.paged_decode_attention_int8.launches == 0


def test_wrapper_refuses_cpu_tensors():
    """The kernel wrappers take CUDA tensors only — they never fall back
    to the plain version."""
    q, k, v, table, lens = _case(10, 1, 1, 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode.paged_decode_attention(*_t(q, k, v, table, lens))


# ------------------------------------------------ K1's split-and-merge
NEG_INF = -1e30


def _split_merge_paged(q, k_pool, v_pool, table, lens, gt, split_pages):
    """K1's arithmetic in plain torch: each group of ``gt`` rows reads the
    table and length of its first row; its sweep of ceil(len / P) pages
    (all W for a zero-length row) is cut into splits of ``split_pages``;
    each split keeps (m, l, acc) of its tokens (-1e30 past the length,
    l = 0 where the split lies past it), and the splits merge in split
    order, skipping those with l = 0."""
    bh, hd = q.shape
    page, w = k_pool.shape[1], table.shape[1]
    n_splits = -(-w // split_pages)
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(bh, hd)
    for r0 in range(0, bh, gt):
        seq = int(lens[r0])
        n_pages = min(-(-seq // page), w) if seq > 0 else w
        pids = table[r0].long().clamp(0, k_pool.shape[0] - 1)
        qg = q[r0:r0 + gt].float()
        parts = []
        for sp in range(n_splits):
            lo, hi = sp * split_pages, min(n_pages, (sp + 1) * split_pages)
            if lo >= hi:
                parts.append((torch.full((gt,), -math.inf), torch.zeros(gt),
                              torch.zeros(gt, hd)))
                continue
            kk = k_pool[pids[lo:hi]].reshape(-1, hd).float()
            vv = v_pool[pids[lo:hi]].reshape(-1, hd).float()
            tok = torch.arange(lo * page, hi * page)
            s = torch.where(tok[None, :] < seq, qg @ kk.T * scale, NEG_INF)
            m = s.amax(dim=-1)
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(dim=-1), p @ vv))
        m_all = torch.stack([torch.where(l > 0, m, -math.inf)
                             for m, l, _ in parts]).amax(dim=0)
        l_all, acc = torch.zeros(gt), torch.zeros(gt, hd)
        for m, l, a in parts:
            wgt = torch.where(l > 0, torch.exp(m - m_all), 0.0)
            l_all = l_all + l * wgt
            acc = acc + a * wgt[:, None]
        out[r0:r0 + gt] = acc / l_all[:, None]
    return out


def _grouped_case(seed, lens, g, kv, hd, page, w):
    """A folded batch as ``decode_step_paged`` builds it: request b's
    pages scattered over a pool, its table row repeated for its H = G·KV
    q-heads with the kv-head offset ``(h // G) · n_pool``, its length
    repeated H times."""
    rng = np.random.default_rng(seed)
    reqs, h = len(lens), g * kv
    n_pool = reqs * w + 2
    perm = rng.permutation(n_pool)[: reqs * w].reshape(reqs, w)
    table = (perm[:, None, :] + (np.arange(h) // g)[None, :, None]
             * n_pool).reshape(reqs * h, w)
    q = rng.standard_normal((reqs * h, hd), dtype=np.float32)
    k = rng.standard_normal((kv * n_pool, page, hd), dtype=np.float32)
    v = rng.standard_normal((kv * n_pool, page, hd), dtype=np.float32)
    return (q, k, v, table.astype(np.int32),
            np.repeat(np.asarray(lens, np.int32), h))


# (seed, per-request lengths, G, KV, hd, page, W, split_pages; None: the
# plan at 132 SMs): G 1-4, hd 64 and 128, pages of 8 and 16, lengths on
# page and split edges (64, 72, 24, 16, 48, 80), a single token,
# zero-length rows, and splits that lie past a row's length
SPLIT_PAGED = [
    (60, [96, 17], 1, 2, 64, 16, 6, 2),
    (61, [0, 64, 65], 2, 2, 128, 16, 8, 4),
    (62, [72, 24], 3, 1, 64, 8, 9, 3),
    (63, [1, 56], 4, 1, 128, 8, 7, 2),
    (64, [0, 33], 4, 2, 64, 16, 5, 1),
    (65, [40, 0, 95], 2, 1, 128, 8, 12, None),
    (66, [16, 48], 3, 2, 128, 16, 4, 4),
    (67, [80, 41], 1, 4, 64, 8, 10, 4),
]


def _plan(bh, w, g, split_pages):
    gt = paged_decode.group_rows(g)
    if split_pages is None:
        n, split_pages = paged_decode.split_plan(bh, w, gt, 132)
        assert n * split_pages >= w > (n - 1) * split_pages
        assert split_pages <= paged_decode.MAX_PAGES
    return gt, split_pages


@pytest.mark.parametrize("seed,lens,g,kv,hd,page,w,split_pages",
                         SPLIT_PAGED)
def test_paged_split_merge_matches_ref_and_jax(seed, lens, g, kv, hd, page,
                                               w, split_pages):
    q, k, v, table, seq = _grouped_case(seed, lens, g, kv, hd, page, w)
    gt, split_pages = _plan(len(seq), w, g, split_pages)
    out = _split_merge_paged(*_t(q, k, v, table, seq), gt, split_pages)
    gold = ops.paged_decode_attention(*_t(q, k, v, table, seq), q_per_kv=g)
    pallas = np.asarray(
        jops.paged_decode_attention(q, k, v, table, seq, interpret=True)
    )
    np.testing.assert_allclose(out.numpy(), gold.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL)


@pytest.mark.parametrize("seed,lens,g,kv,hd,page,w,split_pages",
                         SPLIT_PAGED[1:6])
def test_paged_int8_split_merge_matches_ref_and_jax(seed, lens, g, kv, hd,
                                                    page, w, split_pages):
    """K2 is K1's template with the page's scales applied to the codes'
    dot products and weights: the same split-and-merge on the dequantized
    pools."""
    q, kf, vf, table, seq = _grouped_case(seed, lens, g, kv, hd, page, w)
    kq, ks = zip(*(jquantize(jnp.asarray(p)) for p in kf))
    vq, vs = zip(*(jquantize(jnp.asarray(p)) for p in vf))
    kq = np.stack([np.asarray(c) for c in kq])
    vq = np.stack([np.asarray(c) for c in vq])
    ks, vs = np.asarray(ks, np.float32), np.asarray(vs, np.float32)
    gt, split_pages = _plan(len(seq), w, g, split_pages)
    kd = torch.from_numpy(kq).float() * torch.from_numpy(ks)[:, None, None]
    vd = torch.from_numpy(vq).float() * torch.from_numpy(vs)[:, None, None]
    tq, tt, tl = _t(q, table, seq)
    out = _split_merge_paged(tq, kd, vd, tt, tl, gt, split_pages)
    args = (q, kq, vq, ks, vs, table, seq)
    gold = ops.paged_decode_attention_int8(*_t(*args), q_per_kv=g)
    pallas = np.asarray(
        jops.paged_decode_attention_int8(*args, interpret=True)
    )
    np.testing.assert_allclose(out.numpy(), gold.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL)


@pytest.mark.parametrize("bh,w,gt", [(128, 64, 2), (192, 64, 3), (4, 4, 1),
                                     (8, 2000, 4), (2, 9, 1)])
@pytest.mark.parametrize("sms", [132, 114])
def test_paged_split_plan(bh, w, gt, sms):
    """Every split non-empty, the last reaching W, none longer than the
    kernel's page-id buffer, none shorter than MIN_PAGES unless W is; the
    plan fills the card where the pages allow."""
    n, length = paged_decode.split_plan(bh, w, gt, sms)
    assert n * length >= w > (n - 1) * length
    assert length <= paged_decode.MAX_PAGES
    assert length >= min(w, paged_decode.MIN_PAGES) or n > 1
    if w >= 2 * paged_decode.MIN_PAGES and bh // gt < sms:
        assert n > 1


def test_group_rows_divides_q_per_kv():
    assert [paged_decode.group_rows(g) for g in range(1, 9)] == [
        1, 2, 3, 4, 1, 3, 1, 4]


@pytest.mark.parametrize("bh,q_per_kv", [(3, 2), (8, 3), (4, 0)])
def test_kernel_wrapper_refuses_ragged_groups(bh, q_per_kv):
    """BH must be a whole number of q_per_kv groups: the check the
    wrappers make when they plan, before any launch.  Whole groups give
    the CTA's rows."""
    with pytest.raises(ValueError):
        paged_decode.cta_groups(bh, q_per_kv)
    assert paged_decode.cta_groups(bh * 6, 6) == 3


# ------------------------------------------------ the fold's groups
@pytest.mark.parametrize("name,heads,kv_heads", [
    ("internlm2-1.8b", 4, 2),  # G 2, as the full model's 16 / 8
    ("granite-moe-3b-a800m", 6, 2),  # G 3, as its 24 / 8
])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_paged_passes_groups(monkeypatch, name, heads, kv_heads,
                                         int8):
    """``decode_step_paged`` hands the kernel ``q_per_kv = H // KV`` and
    folds the rows so that each group of that many adjacent rows carries
    equal table and length rows: the grouping K1 rests on."""
    from repro_torch.configs import ARCHS as TARCHS
    from repro_torch.models import decode_step_paged, init_cache, init_model

    cfg = dataclasses.replace(TARCHS[name].smoke(), n_heads=heads,
                              n_kv_heads=kv_heads)
    g = heads // kv_heads
    seen = []
    which = ("paged_decode_attention_int8" if int8
             else "paged_decode_attention")
    plain = getattr(ops, which)

    def recording(*args, q_per_kv=1):
        seen.append((q_per_kv, args[-2], args[-1]))
        return plain(*args, q_per_kv=q_per_kv)

    monkeypatch.setattr(ops, which, recording)
    lens, page, slots = [13, 6, 9], 4, 4
    params = init_model(cfg, 0, device="cpu")
    caches = init_cache(cfg, slots, 20, device="cpu")
    tab = np.zeros((4, 4), np.int32)
    src_slot, src_idx, pid = [], [], 0
    for r, n in enumerate(lens):
        need = n // page + 1
        tab[r, :need] = range(pid, pid + need)
        src_slot += [r] * need
        src_idx += list(range(need))
        pid += need
    n_pool = 1 << (pid - 1).bit_length()
    i32 = dict(dtype=torch.int32)
    decode_step_paged(
        cfg, params, torch.tensor([[5], [7], [9], [0]], **i32), caches,
        torch.tensor(lens + [0], **i32), torch.tensor([0, 1, 2, slots], **i32),
        torch.from_numpy(tab),
        torch.tensor([n + 1 for n in lens] + [0], **i32),
        torch.tensor(src_slot + [0] * (n_pool - pid), **i32),
        torch.tensor(src_idx + [0] * (n_pool - pid), **i32),
        page_tokens=page, n_pool=n_pool, int8=int8,
    )
    assert len(seen) == cfg.n_layers
    for q_per_kv, table, seq in seen:
        assert q_per_kv == g
        assert table.shape[0] == 4 * heads and table.shape[0] % g == 0
        groups = table.reshape(-1, g, table.shape[1])
        assert torch.equal(groups, groups[:, :1].expand_as(groups))
        lens_g = seq.reshape(-1, g)
        assert torch.equal(lens_g, lens_g[:, :1].expand_as(lens_g))
