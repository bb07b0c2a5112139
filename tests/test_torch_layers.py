"""The port's layer functions against their jnp twins.

Same inputs, made from a seed with numpy, through ``repro.models.layers``
and ``repro_torch.models.layers``.  In f32 the two agree to atol 1e-5
(summation order and transcendental rounding only).  In bf16 the output
is rounded to bf16 on both sides from f32 values that differ in their
last bits, so an element may land one bf16 step apart: at most 2^-7
relative (the bf16 spacing), plus the same absolute allowance near zero.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402

F32_ATOL = 1e-5
BF16_TOL = 2.0 ** -7  # one bf16 step, relative and absolute

DTYPES = ["float32", "bfloat16"]


def _np(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape, dtype=np.float32) * scale)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _both(a):
    return jnp.asarray(a), tensor_from_numpy(a, "cpu")


def _check(t_out, j_out, dtype):
    got = t_out.float().numpy()
    want = np.asarray(j_out, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _both(_np(rng, (2, 5, 64), dtype))
    jw, tw = _both(_np(rng, (64,), dtype, 0.1))
    _check(tl.rms_norm(tx, tw, 1e-5), jl.rms_norm(jx, jw, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _both(_np(rng, (2, 4, 7, 16), dtype))
    pos = np.arange(7, dtype=np.int32) + 3
    out = tl.apply_rope(tx, torch.from_numpy(pos)[None, None], 10_000.0)
    gold = jl.apply_rope(jx, jnp.asarray(pos)[None, None], 10_000.0)
    _check(out, gold, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 5, 0), (False, None, 0), (True, None, 4),
])
def test_chunked_attention(dtype, causal, window, q_offset):
    rng = np.random.default_rng(2)
    jq, tq = _both(_np(rng, (2, 4, 9, 16), dtype))
    jk, tk = _both(_np(rng, (2, 2, 9 + q_offset, 16), dtype))
    jv, tv = _both(_np(rng, (2, 2, 9 + q_offset, 16), dtype))
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=4)
    _check(
        tl.chunked_attention(tq, tk, tv, **kw),
        jl.chunked_attention(jq, jk, jv, **kw),
        dtype,
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention(dtype, window):
    rng = np.random.default_rng(3)
    jq, tq = _both(_np(rng, (2, 4, 1, 16), dtype))
    jk, tk = _both(_np(rng, (2, 2, 12, 16), dtype))
    jv, tv = _both(_np(rng, (2, 2, 12, 16), dtype))
    out = tl.decode_attention(tq, tk, tv, 6, window=window)
    gold = jl.decode_attention(jq, jk, jv, jnp.int32(6), window=window)
    _check(out, gold, dtype)


def test_decode_attention_per_row_positions():
    """A [B] position vector is the JAX scalar version applied row by row
    (what the JAX engine gets from vmapping over slots)."""
    rng = np.random.default_rng(4)
    q = _np(rng, (3, 4, 1, 16), "float32")
    k = _np(rng, (3, 2, 10, 16), "float32")
    v = _np(rng, (3, 2, 10, 16), "float32")
    pos = [2, 9, 5]
    out = tl.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.tensor(pos)
    ).numpy()
    for b, p in enumerate(pos):
        gold = jl.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   jnp.int32(p))
        np.testing.assert_allclose(out[b:b + 1], np.asarray(gold),
                                   atol=F32_ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mlp(dtype):
    rng = np.random.default_rng(5)
    jx, tx = _both(_np(rng, (2, 3, 64), dtype))
    params = {
        name: _np(rng, shape, dtype, 0.125)
        for name, shape in (("gate", (64, 128)), ("up", (64, 128)),
                            ("down", (128, 64)))
    }
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: tensor_from_numpy(v, "cpu") for k, v in params.items()}
    _check(tl.apply_mlp(tp, tx), jl.apply_mlp(jp, jx), dtype)
