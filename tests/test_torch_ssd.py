"""K6's plain version and the Mamba-2 block on the port against the JAX
package.

* ``ref.ssd_scan_ref`` (the plain K6) on the same f32 inputs, made with
  numpy from a seed, as the JAX package's chunked scan
  ``blocks._ssd_scan`` (the function its model runs: the same order of
  operations, so within ``SCAN_ATOL`` = 2e-5 of max |y|, the two
  frameworks' ``exp`` and sums differing by f32 ulps), its sequential
  recurrence ``ref.ssd_scan_ref`` (within 1e-3, the JAX package's own
  tolerance for its kernel against it, ``tests/test_kernels.py``) and
  the Pallas ``ssd_scan`` in interpret mode where it takes the shape (S a
  multiple of the chunk, or S below one chunk), within 1e-3 too.  S a
  multiple of the chunk, S that is not, S below one chunk, and B > 1.
* ``_tiled_ssd``, K6's own order of work restated in plain torch (the
  score tiles C B^T computed once for all heads, each head's decay
  applied to them after, 64-row query tiles, and a scan of one chunk
  summing its ``seg`` inside the tile), against the same three within
  the same tolerances, at ``SCAN_CASES``, at S of 1, Q - 1, Q and Q + 1
  with two query tiles a chunk, at a chunk that is not a multiple of the
  tile, and at head counts of 1 and 5.
* The Mamba-2 block (``mamba2-2.7b.smoke()``: d 64, d_inner 128, 8 heads
  of 16, ds 16, chunk 32) on JAX's parameters: ``_causal_conv``,
  ``mamba_forward`` with and without its cache, ``_final_state`` and
  ``mamba_decode`` after a prefill, in f32 within ``F32_ATOL`` = 1e-5 of
  max |out| and in bf16 within two bf16 ulps of max |out| (the two
  frameworks round the same f32 sums to bf16, and a one-ulp difference
  in a bf16 intermediate can move an output by about one more).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SCAN_ATOL = 2e-5  # relative to max |y|: the same f32 algorithm
SEQ_TOL = 1e-3  # against the sequential recurrence, as the JAX package
F32_ATOL = 1e-5  # relative to max |out|: f32 block against f32 block

CFG = ARCHS["mamba2-2.7b"].smoke()
TCFG = TARCHS["mamba2-2.7b"].smoke()


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _scan_inputs(seed, b, s, nh, hd, ds):
    """Model-like f32 inputs: SiLU-range x, B and C, dt = softplus of a
    normal, and the model's A = -linspace(1, 16, nh)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    A = (-np.linspace(1.0, 16.0, nh)).astype(np.float32)
    Bm = rng.standard_normal((b, s, ds)).astype(np.float32)
    C = rng.standard_normal((b, s, ds)).astype(np.float32)
    return x, dt, A, Bm, C


# (b, s, nh, hd, ds, chunk): whole chunks, a ragged last chunk, S below
# one chunk, B > 1 with a ragged chunk, and the smoke model's widths
SCAN_CASES = {
    "whole_chunks": (1, 64, 3, 16, 8, 32),
    "ragged": (1, 45, 3, 16, 8, 32),
    "below_one_chunk": (1, 20, 2, 16, 8, 32),
    "batch_ragged": (3, 70, 2, 8, 16, 32),
    "smoke_model": (2, 96, 8, 16, 16, 32),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_ssd_scan_ref_matches_jax(case):
    b, s, nh, hd, ds, chunk = SCAN_CASES[case]
    args = _scan_inputs(sum(map(ord, case)), b, s, nh, hd, ds)
    got = ref.ssd_scan_ref(*map(torch.from_numpy, args), chunk).numpy()
    assert got.shape == (b, s, nh, hd) and got.dtype == np.float32
    jargs = [jnp.asarray(a) for a in args]
    chunked = np.asarray(jblocks._ssd_scan(*jargs, chunk))
    scale = float(np.abs(chunked).max())
    np.testing.assert_allclose(got, chunked, atol=SCAN_ATOL * scale, rtol=0)
    gold = np.asarray(jref.ssd_scan_ref(*jargs))
    np.testing.assert_allclose(got, gold, atol=SEQ_TOL, rtol=SEQ_TOL)
    if s % chunk == 0 or s < chunk:
        pallas = np.asarray(jops.ssd_scan(*jargs, chunk=chunk,
                                          interpret=True))
        np.testing.assert_allclose(got, pallas, atol=SEQ_TOL, rtol=SEQ_TOL)


TILE = 64  # the kernel's query and key tiles


def _in_order_seg(w):
    """Running sums of ``w`` [n, nh] along n, each sum rounded to f32 on
    its own: the kernel's one-thread sum of dt A."""
    out = torch.empty_like(w)
    v = torch.zeros(w.shape[1:])
    for t in range(w.shape[0]):
        v = v + w[t]
        out[t] = v
    return out


def _tiled_ssd(x, dt, A, Bm, C, chunk):
    """K6's order of work in plain torch, f32.  Past one chunk: pass 1
    gives each chunk's seg (in order), its outgoing state S_c [nh, ds, hd]
    and its causal 64 x 64 score tiles C_q B_k^T once for all heads;
    then, per 64-row query tile and head, the incoming state H_in summed
    over the earlier chunks in chunk order, C_q H_in scaled by
    exp(seg_i), and per key tile on or below the
    diagonal the head's M = scores exp(seg_i - seg_j) dt_j (masked before
    the exp) times x, where a tile wholly below the diagonal takes the
    decay as exp(seg_i - p) exp(p - seg_j) with p its last key's seg.
    One chunk: each query tile sums its own seg up to its last row,
    computes its own score tiles and takes every decay unfactored."""
    b, s, nh, hd = x.shape
    nc = -(-s // chunk)
    dA = dt * A  # the rounded products the sums take
    y = torch.empty(b, s, nh, hd)
    for bi in range(b):
        segs, states, scores = [], [], {}
        for c in range(nc):
            p0, n = c * chunk, min(chunk, s - c * chunk)
            seg = _in_order_seg(dA[bi, p0:p0 + n])  # [n, nh]
            segs.append(seg)
            if nc == 1:
                break
            if c < nc - 1:
                w = torch.exp(seg[-1] - seg) * dt[bi, p0:p0 + n]
                states.append(torch.einsum(
                    "td,th,thp->hdp", Bm[bi, p0:p0 + n], w, x[bi, p0:p0 + n]))
            for q0 in range(0, n, TILE):
                for k0 in range(0, q0 + 1, TILE):
                    scores[c, q0, k0] = (
                        C[bi, p0 + q0:p0 + min(n, q0 + TILE)]
                        @ Bm[bi, p0 + k0:p0 + min(n, k0 + TILE)].T)
        h_in, H = [None], torch.zeros(nh, Bm.shape[-1], hd)
        for c in range(nc - 1):
            H = torch.exp(segs[c][-1])[:, None, None] * H + states[c]
            h_in.append(H)
        for c in range(nc):
            p0, n = c * chunk, min(chunk, s - c * chunk)
            for q0 in range(0, n, TILE):
                rows = min(TILE, n - q0)
                cq = C[bi, p0 + q0:p0 + q0 + rows]
                if nc == 1:
                    seg = _in_order_seg(dA[bi, :q0 + rows])
                else:
                    seg = segs[c]
                segq = seg[q0:q0 + rows]  # [rows, nh]
                acc = torch.zeros(nh, rows, hd)
                if c > 0:
                    acc = (torch.einsum("id,hdp->hip", cq, h_in[c])
                           * torch.exp(segq).T[:, :, None])
                for k0 in range(0, q0 + 1, TILE):
                    keys = min(TILE, n - k0)
                    sc = (cq @ Bm[bi, k0:k0 + keys].T if nc == 1
                          else scores[c, q0, k0])
                    dtk = dt[bi, p0 + k0:p0 + k0 + keys][None]
                    if nc > 1 and k0 < q0:
                        p = seg[k0 + keys - 1]
                        m = (sc[:, :, None] * torch.exp(segq - p)[:, None]
                             * (torch.exp(p - seg[k0:k0 + keys]) * dtk))
                    else:
                        causal = (torch.arange(k0, k0 + keys)[None, :]
                                  <= torch.arange(q0, q0 + rows)[:, None])
                        rel = segq[:, None, :] - seg[None, k0:k0 + keys, :]
                        m = (sc[:, :, None]
                             * torch.exp(torch.where(causal[:, :, None], rel,
                                                     -math.inf))
                             * dtk)
                    acc = acc + torch.einsum(
                        "ijh,jhp->hip", m, x[bi, p0 + k0:p0 + k0 + keys])
                y[bi, p0 + q0:p0 + q0 + rows] = acc.permute(1, 0, 2)
    return y


# (b, s, nh, hd, ds, chunk): SCAN_CASES, then S of 1, Q - 1, Q and Q + 1
# with two query tiles a chunk, a chunk of 100 (a ragged second tile in
# every chunk), and one and five heads
TILED_CASES = {
    **SCAN_CASES,
    "s1": (1, 1, 3, 16, 8, 128),
    "s_q_minus_1": (1, 127, 3, 16, 8, 128),
    "s_q": (1, 128, 3, 16, 8, 128),
    "s_q_plus_1": (1, 129, 3, 16, 8, 128),
    "ragged_tiles": (2, 230, 2, 16, 8, 100),
    "one_head": (1, 200, 1, 16, 8, 128),
    "five_heads": (1, 140, 5, 8, 16, 64),
}


@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_tiled_order_of_work_matches(case):
    b, s, nh, hd, ds, chunk = TILED_CASES[case]
    args = _scan_inputs(sum(map(ord, case)) + 1, b, s, nh, hd, ds)
    got = _tiled_ssd(*map(torch.from_numpy, args), chunk).numpy()
    plain = ref.ssd_scan_ref(*map(torch.from_numpy, args), chunk).numpy()
    scale = float(np.abs(plain).max())
    np.testing.assert_allclose(got, plain, atol=SCAN_ATOL * scale, rtol=0)
    jargs = [jnp.asarray(a) for a in args]
    chunked = np.asarray(jblocks._ssd_scan(*jargs, chunk))
    np.testing.assert_allclose(got, chunked, atol=SCAN_ATOL * scale, rtol=0)
    gold = np.asarray(jref.ssd_scan_ref(*jargs))
    np.testing.assert_allclose(got, gold, atol=SEQ_TOL, rtol=SEQ_TOL)
    if s % chunk == 0 or s < chunk:
        pallas = np.asarray(jops.ssd_scan(*jargs, chunk=chunk,
                                          interpret=True))
        np.testing.assert_allclose(got, pallas, atol=SEQ_TOL, rtol=SEQ_TOL)


def test_tiled_seg_in_the_tile_is_the_chunk_seg():
    """A one-chunk tile's own sum of seg up to its last row gives the bits
    that pass 1's sum over the whole chunk gives at those rows."""
    x, dt, A, _, _ = map(torch.from_numpy, _scan_inputs(4, 1, 200, 3, 8, 8))
    dA = dt[0] * A
    whole = _in_order_seg(dA)
    for end in (1, 64, 128, 200):
        assert torch.equal(_in_order_seg(dA[:end]), whole[:end])


def test_pad_positions_neither_decay_nor_feed_the_state():
    """The first S rows of a scan do not depend on what follows them: a
    ragged scan equals the head of a longer one."""
    args = _scan_inputs(7, 1, 64, 2, 16, 8)
    full = ref.ssd_scan_ref(*map(torch.from_numpy, args), 32)
    head = [torch.from_numpy(a[:, :45]) if a.ndim > 1 else torch.from_numpy(a)
            for a in args]
    np.testing.assert_allclose(ref.ssd_scan_ref(*head, 32).numpy(),
                               full[:, :45].numpy(), atol=1e-5, rtol=0)


def test_ssd_ops_takes_the_plain_version_on_cpu():
    """On CPU tensors ``ops.ssd_scan`` is the plain version and the
    kernel's launch count stays where it was; the kernel's wrapper itself
    refuses CPU tensors."""
    args = [torch.from_numpy(a) for a in _scan_inputs(3, 1, 40, 2, 16, 8)]
    before = tssd.ssd_scan.launches
    assert torch.equal(ops.ssd_scan(*args, 32), ref.ssd_scan_ref(*args, 32))
    assert tssd.ssd_scan.launches == before
    assert tssd.ssd_scan in ops.WRAPPERS
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(*args, 32)


# ------------------------------------------------------------ the block
@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def mamba(request):
    """(JAX block params, port block params, dtype name)."""
    p = jblocks.init_mamba(jax.random.PRNGKey(0), CFG,
                           jnp.dtype(request.param))
    return p, _port(p), request.param


def _x(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _tol(want, dtype):
    """F32_ATOL of max |want| in f32; two bf16 ulps of it in bf16."""
    top = float(np.abs(np.asarray(want, np.float32)).max())
    if dtype == "float32":
        return F32_ATOL * top
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=_tol(want, dtype), rtol=0)


def test_causal_conv(mamba):
    p, tp, dtype = mamba
    jx, tx = _x(1, (2, 11, 128), dtype)
    want = jblocks._causal_conv(jx, p["conv_x"], 11)
    got = tblocks._causal_conv(tx, tp["conv_x"], 11)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("s", [45, 64, 2 * 32 + 1])
def test_mamba_forward(mamba, s):
    p, tp, dtype = mamba
    jx, tx = _x(s, (2, s, CFG.d_model), dtype)
    _close(tblocks.mamba_forward(tp, TCFG, tx),
           jblocks.mamba_forward(p, CFG, jx), dtype)
    want, jc = jblocks.mamba_forward(p, CFG, jx, return_cache=True)
    got, tc = tblocks.mamba_forward(tp, TCFG, tx, return_cache=True)
    _close(got, want, dtype)
    for g, w in zip(tc, jc):
        assert g.dtype == _port(w).dtype
        _close(g, w, dtype)


def test_final_state():
    """The f32 state from f32 inputs, on its own (the block test holds it
    after the bf16 projections too)."""
    x, dt, A, Bm, _ = _scan_inputs(5, 2, 37, 8, 16, 16)
    want = jblocks._final_state(*map(jnp.asarray, (x, dt, A, Bm)))
    got = tblocks._final_state(*map(torch.from_numpy, (x, dt, A, Bm)))
    _close(got, want, "float32")


def test_mamba_decode_after_prefill(mamba):
    """Four decode steps from a prefill's cache: every step's output and
    the cache after it; the port updates the cache in place."""
    p, tp, dtype = mamba
    jx, tx = _x(9, (2, 40, CFG.d_model), dtype)
    _, jc = jblocks.mamba_forward(p, CFG, jx, return_cache=True)
    _, tc = tblocks.mamba_forward(tp, TCFG, tx, return_cache=True)
    tc = tuple(t.clone() for t in tc)
    for step in range(4):
        jn, tn = _x(100 + step, (2, 1, CFG.d_model), dtype)
        want, jc = jblocks.mamba_decode(p, CFG, jn, jc, jnp.int32(40 + step))
        got, out_cache = tblocks.mamba_decode(tp, TCFG, tn, tc, 40 + step)
        assert all(a is b for a, b in zip(out_cache, tc))
        _close(got, want, dtype)
        for g, w in zip(tc, jc):
            _close(g, w, dtype)


def test_mamba_decode_keeps_the_other_rows(mamba):
    """With ``rows`` only those rows' conv tails and state move; the
    others keep theirs bit for bit (the JAX engine masks them)."""
    _, tp, dtype = mamba
    _, tx = _x(11, (3, 12, CFG.d_model), dtype)
    _, tc = tblocks.mamba_forward(tp, TCFG, tx, return_cache=True)
    tc = tuple(t.clone() for t in tc)
    before = tuple(t.clone() for t in tc)
    _, tn = _x(12, (3, 1, CFG.d_model), dtype)
    tblocks.mamba_decode(tp, TCFG, tn, tc, 12, rows=torch.tensor([1]))
    for old, new in zip(before, tc):
        assert torch.equal(old[[0, 2]], new[[0, 2]])
        assert not torch.equal(old[1], new[1])
