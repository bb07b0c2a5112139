"""K6's backward and the Mamba-2 block's gradients on the port against
the JAX package, on the CPU.

* ``ref.ssd_scan_bwd_ref`` (the plain twin of ``ssd_scan_bwd.cu``, its
  gradients written out as formulas) on f32 inputs made with numpy from a
  seed, against autograd of ``ref.ssd_scan_ref`` and ``jax.vjp`` of the
  JAX package's ``blocks._ssd_scan``, for all five gradients, at
  ``test_torch_ssd.SCAN_CASES`` (whole chunks, a ragged last chunk, S
  below one chunk, B > 1 ragged, the smoke model's widths) and a ragged
  scan with a 256-long chunk, the models' chunk.  Tolerances, of max
  |gold|:
  - against autograd (the same torch terms, summed in other orders): dx,
    ddt, dB and dC within ``GRAD_RTOL`` = 2e-6 (measured at most
    2.6e-7); dA within ``DA_RTOL`` = 1e-4 (measured 1.6e-5): its terms,
    the reverse running sums of dseg times dt over every position,
    cancel (the ± terms of dseg), and f32 loses about 1e-4 of the
    largest there at a chunk of 256 (autograd against an f64 autograd:
    1.8e-4);
  - against ``jax.vjp``, jitted: ``JAX_RTOL`` = 5e-5 (measured at most
    1.7e-5, dA, and 8.8e-6 for the others at a chunk of 32), but ddt at
    a chunk of 256 within ``JAX_DDT_Q256_RTOL`` = 5e-4 (measured
    1.1e-4): XLA's cumsum sums seg in another order than torch's
    sequential one (335 of 768 sums of order 10^3 differ, by up to
    3.7e-4), and exp(seg_i - seg_j) carries that difference.
* ``_tiled_ssd_bwd``, the order of work of ``ssd_scan_bwd.cu`` restated
  in plain torch (the scores once a tile pair, the heads' ds summed per
  head group of ``ssd_scan.HEAD_GROUP`` before the products over ds, the
  per-position terms and the dseg pass, dC and dB from the groups'
  partials), against ``ref.ssd_scan_bwd_ref`` at ``BWD_CASES`` and at
  head counts that are not a multiple of the group (21 and 5; 33 over
  three groups), within the same limits as autograd's.
* The Mamba-2 block in f32 (``mamba2-2.7b.smoke()``): every parameter's
  and the input's gradient against ``jax.vjp`` of the JAX block, whose
  ``bf16_grad`` at the five input projections returns a bf16 cotangent
  an f32 model cannot take; the test swaps the attribute the block reads
  at call time, ``repro.models.layers.bf16_grad``, for the rounding rule
  the port uses (no JAX file changes).  Within ``BLOCK_RTOL`` = 1e-5 of
  each leaf's norm (measured at most 1.3e-6): without the boundaries in
  the port's block the five projections' and x's gradients differ by
  1.5e-3 to 2.4e-3.  ``A_log`` and ``dt_bias``, whose gradients sum dA and
  ddt over every position, where the ± terms of dseg cancel, within
  ``DECAY_RTOL`` = 1e-3 (measured 1.3e-4 and 9.8e-6; the boundaries do
  not move them).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_ssd import SCAN_CASES, _scan_inputs  # noqa: E402

GRAD_RTOL = 2e-6
DA_RTOL = 1e-4
JAX_RTOL = 5e-5
JAX_DDT_Q256_RTOL = 5e-4
BLOCK_RTOL = 1e-5
DECAY_RTOL = 1e-3
NAMES = ("dx", "ddt", "dA", "dB", "dC")
AUTO_RTOLS = {**dict.fromkeys(NAMES, GRAD_RTOL), "dA": DA_RTOL}

CFG = ARCHS["mamba2-2.7b"].smoke()
TCFG = TARCHS["mamba2-2.7b"].smoke()

BWD_CASES = {**SCAN_CASES, "chunk_256_ragged": (1, 600, 3, 16, 16, 256)}
#: (B, S, nh, hd, ds, chunk) where the heads do not fill the kernel's head
#: groups: one group and 5 (two tiles a chunk, the last chunk ragged), a
#: ragged second tile in every chunk, three groups (16, 16, 1)
GROUP_CASES = {
    "group_and_5": (1, 300, 21, 8, 8, 128),
    "five_heads_chunk_100": (2, 230, 5, 16, 16, 100),
    "three_groups": (1, 140, 33, 8, 8, 64),
}
TILE = 64  # the kernel's query and key tiles


def _cotangent(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_grads(got, want, what, rtols):
    """Each gradient within ``rtols[name]`` of max |want|."""
    for name, g, w in zip(NAMES, got, want):
        g = np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape and np.isfinite(g).all(), (what, name)
        rtol = rtols[name]
        np.testing.assert_allclose(
            g, w, atol=rtol * float(np.abs(w).max()), rtol=0,
            err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_ssd_scan_bwd_ref_matches_autograd_and_jax(case):
    b, s, nh, hd, ds, chunk = BWD_CASES[case]
    args = _scan_inputs(sum(map(ord, case)) + 2, b, s, nh, hd, ds)
    dy = _cotangent(len(case), (b, s, nh, hd))
    got = ref.ssd_scan_bwd_ref(*map(torch.from_numpy, args),
                               torch.from_numpy(dy), chunk)
    assert [tuple(g.shape) for g in got] == [a.shape for a in args]
    assert all(g.dtype == torch.float32 for g in got)
    got = [g.numpy() for g in got]
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y = ref.ssd_scan_ref(*leaves, chunk)
    auto = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    _assert_grads(got, [a.numpy() for a in auto], "autograd", AUTO_RTOLS)
    jgrads = jax.jit(lambda g, *a: jax.vjp(
        lambda *b: jblocks._ssd_scan(*b, chunk), *a)[1](g))(
        jnp.asarray(dy), *map(jnp.asarray, args))
    rtols = dict.fromkeys(NAMES, JAX_RTOL)
    if chunk == 256:
        rtols["ddt"] = JAX_DDT_Q256_RTOL
    _assert_grads(got, jgrads, "jax.vjp", rtols)


def _tiled_ssd_bwd(x, dt, A, Bm, C, dy, chunk):
    """K6's backward in the kernel's order of work, plain torch, f32.
    Passes 1-2: each chunk's seg, the incoming state H_in and the
    outgoing state's gradient dS.  Per chunk: pass 3 the score tiles C_i
    B_j^T of every pair it >= jt, once; pass 4, per key tile jt and head
    group, per head in order and query tile it >= jt, dM = dy_i x_j^T, M,
    ds = dM L dt_j summed over the group's heads, dx_j += M^T dy_i, W's
    row sums per (jt, row) and its and P's column sums; pass 5, per row
    tile and group, the state terms: V = x_j dS, q_j = V_j . B_j, u_j V_j
    summed over the group, dx_j += u_j B_j dS^T; Cin = dy_i H_in, e_i C_i
    . Cin_i, e_i Cin_i summed over the group; pass 6 dseg from the terms,
    dtotal, the reverse running sum, ddt and each chunk's share of dA;
    pass 7 dC_i = sum_jt ds(i, jt) B_jt and dB_j = sum_it ds(it, j)^T C_it
    with ds summed over the groups in order, plus the groups' terms.  seg
    is the plain backward's cumsum, so that only the order of these
    passes differs (the kernel's in-order seg moves ddt by up to 1.1e-4
    of max |ddt| here, within the card tests' limit)."""
    b, s, nh, hd = x.shape
    ds_ = Bm.shape[-1]
    nc = -(-s // chunk)
    groups = [range(g, min(nh, g + tssd.HEAD_GROUP))
              for g in range(0, nh, tssd.HEAD_GROUP)]
    dx = torch.zeros_like(x)
    ddt = torch.zeros_like(dt)
    dB = torch.zeros_like(Bm)
    dC = torch.zeros_like(C)
    dA = torch.zeros(nh)
    for bi in range(b):
        spans = [(c * chunk, min(chunk, s - c * chunk)) for c in range(nc)]
        segs = [torch.cumsum(dt[bi, p0:p0 + n] * A, 0) for p0, n in spans]
        H, H_in = torch.zeros(nh, hd, ds_), []
        for c, (p0, n) in enumerate(spans):
            H_in.append(H)
            u = torch.exp(segs[c][-1] - segs[c]) * dt[bi, p0:p0 + n]
            H = torch.exp(segs[c][-1])[:, None, None] * H + torch.einsum(
                "th,thp,td->hpd", u, x[bi, p0:p0 + n], Bm[bi, p0:p0 + n])
        G, dS = torch.zeros(nh, hd, ds_), [None] * nc
        for c in reversed(range(nc)):
            p0, n = spans[c]
            dS[c] = G
            e = torch.exp(segs[c])
            G = torch.exp(segs[c][-1])[:, None, None] * G + torch.einsum(
                "th,thp,td->hpd", e, dy[bi, p0:p0 + n], C[bi, p0:p0 + n])
        for c, (p0, n) in enumerate(spans):
            sg, total = segs[c], segs[c][-1]
            tiles = [(t0, min(TILE, n - t0)) for t0 in range(0, n, TILE)]
            rows = [slice(p0 + t0, p0 + t0 + r) for t0, r in tiles]
            scores = {(it, jt): C[bi, rows[it]] @ Bm[bi, rows[jt]].T
                      for it in range(len(tiles)) for jt in range(it + 1)}
            terms = torch.zeros(nh, 9, n)
            dsc = {}
            cin = torch.zeros(len(groups), n, ds_)
            bout = torch.zeros(len(groups), n, ds_)
            for jt, (j0, rj) in enumerate(tiles):
                for gi, heads in enumerate(groups):
                    acc = {it: 0 for it in range(jt, len(tiles))}
                    for h in heads:
                        xj = x[bi, rows[jt], h]
                        dxa = torch.zeros(rj, hd)
                        col_w = torch.zeros(rj)
                        col_p = torch.zeros(rj)
                        for it in range(jt, len(tiles)):
                            i0, ri = tiles[it]
                            dyi = dy[bi, rows[it], h]
                            dm = dyi @ xj.T
                            ii = torch.arange(i0, i0 + ri)[:, None]
                            jj = torch.arange(j0, j0 + rj)[None]
                            keep = jj <= ii
                            rel = torch.where(keep, sg[ii, h] - sg[jj, h],
                                              torch.tensor(float("-inf")))
                            L = torch.exp(rel)
                            dtj = dt[bi, rows[jt], h][None]
                            sc = scores[it, jt]
                            m = sc * L * dtj
                            dl = dm * L
                            acc[it] = acc[it] + dl * dtj
                            w = dm * m
                            terms[h, jt, i0:i0 + ri] = w.sum(1)
                            col_w += w.sum(0)
                            col_p += (dl * sc).sum(0)
                            dxa += m.T @ dyi
                        terms[h, 4, j0:j0 + rj] = col_w
                        terms[h, 5, j0:j0 + rj] = col_p
                        dx[bi, rows[jt], h] = dxa
                    for it, a in acc.items():
                        dsc[gi, it, jt] = a
            for r, (r0, nr) in enumerate(tiles):
                for gi, heads in enumerate(groups):
                    for h in heads:
                        segr = sg[r0:r0 + nr, h]
                        if c < nc - 1:
                            v = x[bi, rows[r], h] @ dS[c][h]
                            q = (v * Bm[bi, rows[r]]).sum(1)
                            ex = torch.exp(total[h] - segr)
                            u = ex * dt[bi, rows[r], h]
                            terms[h, 7, r0:r0 + nr] = ex * q
                            terms[h, 8, r0:r0 + nr] = u * q
                            bout[gi, r0:r0 + nr] += u[:, None] * v
                            z = Bm[bi, rows[r]] @ dS[c][h].T
                            dx[bi, rows[r], h] += u[:, None] * z
                        if c > 0:
                            ci = dy[bi, rows[r], h] @ H_in[c][h]
                            e = torch.exp(segr)
                            terms[h, 6, r0:r0 + nr] = e * (
                                C[bi, rows[r]] * ci).sum(1)
                            cin[gi, r0:r0 + nr] += e[:, None] * ci
            for h in range(nh):
                row_w = torch.stack([
                    terms[h, :t // TILE + 1, t].sum() for t in range(n)])
                dseg = row_w - terms[h, 4] + terms[h, 6] - terms[h, 8]
                dtotal = terms[h, 8].sum()
                if 0 < c < nc - 1:
                    dtotal = dtotal + torch.exp(total[h]) * (
                        dS[c][h] * H_in[c][h]).sum()
                d_dtA = dtotal + torch.flip(torch.cumsum(
                    torch.flip(dseg, [0]), 0), [0])
                ddt[bi, p0:p0 + n, h] = (terms[h, 5] + terms[h, 7]
                                         + d_dtA * A[h])
                dA[h] += (d_dtA * dt[bi, p0:p0 + n, h]).sum()
            for r, (r0, nr) in enumerate(tiles):
                acc = torch.zeros(nr, ds_)
                for jt in range(r + 1):
                    acc += sum(dsc[g, r, jt] for g in range(len(groups))) @ \
                        Bm[bi, rows[jt]]
                dC[bi, rows[r]] = acc + cin[:, r0:r0 + nr].sum(0)
                acc = torch.zeros(nr, ds_)
                for it in range(r, len(tiles)):
                    acc += sum(dsc[g, it, r] for g in range(len(groups))).T \
                        @ C[bi, rows[it]]
                dB[bi, rows[r]] = acc + bout[:, r0:r0 + nr].sum(0)
    return dx, ddt, dA, dB, dC


@pytest.mark.parametrize("case", sorted({**BWD_CASES, **GROUP_CASES}))
def test_tiled_ssd_bwd_matches_the_plain_backward(case):
    """The kernel's order of work (``_tiled_ssd_bwd``) against
    ``ref.ssd_scan_bwd_ref`` and autograd of the plain scan: the same f32
    terms in other orders, within autograd's limits."""
    b, s, nh, hd, ds, chunk = {**BWD_CASES, **GROUP_CASES}[case]
    args = [torch.from_numpy(a) for a in
            _scan_inputs(sum(map(ord, case)) + 5, b, s, nh, hd, ds)]
    dy = torch.from_numpy(_cotangent(len(case) + 1, (b, s, nh, hd)))
    got = [g.numpy() for g in _tiled_ssd_bwd(*args, dy, chunk)]
    want = ref.ssd_scan_bwd_ref(*args, dy, chunk)
    _assert_grads(got, [w.numpy() for w in want], "ref", AUTO_RTOLS)
    leaves = [a.clone().requires_grad_() for a in args]
    auto = torch.autograd.grad(ref.ssd_scan_ref(*leaves, chunk), leaves, dy)
    _assert_grads(got, [a.numpy() for a in auto], "autograd", AUTO_RTOLS)


def test_ssd_ops_differentiates_the_plain_version_on_cpu():
    """On CPU tensors that need a gradient ``ops.ssd_scan`` is the plain
    version under autograd, and neither kernel's count moves; the
    backward's wrapper refuses CPU tensors and joins ``ops.WRAPPERS``."""
    args = [torch.from_numpy(a) for a in _scan_inputs(3, 1, 40, 2, 16, 8)]
    dy = torch.from_numpy(_cotangent(4, (1, 40, 2, 16)))
    leaves = [a.clone().requires_grad_() for a in args]
    before = (tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches)
    got = torch.autograd.grad(ops.ssd_scan(*leaves, 32), leaves, dy)
    want = ref.ssd_scan_bwd_ref(*args, dy, 32)
    _assert_grads([g.numpy() for g in got], [w.numpy() for w in want],
                  "ops", AUTO_RTOLS)
    assert (tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches) == before
    assert tssd.ssd_scan_bwd in ops.WRAPPERS
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_bwd(*args, dy, 32)


@jax.custom_vjp
def _bf16_round_grad(x):
    return x


_bf16_round_grad.defvjp(
    lambda x: (x, None),
    lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))


@pytest.mark.parametrize("s", [45, 70])
def test_mamba_block_f32_gradients_match_jax(monkeypatch, s):
    """Every f32 parameter's and the input's gradient of one Mamba-2
    block (S 45: two chunks of 32, the last ragged; 70: three) against
    the JAX block with its projections' boundary rounding the cotangent
    to bf16 and keeping f32, each within its limit of the leaf's norm
    (module docstring)."""
    monkeypatch.setattr(jlayers, "bf16_grad", _bf16_round_grad)
    p = jblocks.init_mamba(jax.random.PRNGKey(0), CFG, jnp.float32)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, CFG.d_model)).astype(np.float32)
    g = rng.standard_normal((2, s, CFG.d_model)).astype(np.float32)
    jp, jx = jax.jit(lambda pp, xx, gg: jax.vjp(
        lambda a, b: jblocks.mamba_forward(a, CFG, b), pp, xx)[1](gg))(
        p, jnp.asarray(x), jnp.asarray(g))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
    names = sorted(tp)
    leaves = [tp[k].requires_grad_() for k in names]
    tx = torch.from_numpy(x).requires_grad_()
    out = tblocks.mamba_forward(tp, TCFG, tx)
    grads = torch.autograd.grad(out, leaves + [tx], torch.from_numpy(g))
    want = [np.asarray(jp[k]) for k in names] + [np.asarray(jx)]
    for name, got, w in zip(names + ["x"], grads, want):
        assert got.shape == w.shape and torch.isfinite(got).all(), name
        err = float(np.linalg.norm(got.numpy() - w) / np.linalg.norm(w))
        assert err <= (DECAY_RTOL if name in ("A_log", "dt_bias")
                       else BLOCK_RTOL), (name, err)
