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
