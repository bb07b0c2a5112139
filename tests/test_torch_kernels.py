"""Paged-decode kernels of the port against the JAX package's.

The plain PyTorch versions of K1 (``paged_decode_attention``) and K2
(``paged_decode_attention_int8``) are held against the jnp oracles in
``repro.kernels.ref`` and against the Pallas kernels run in interpret mode
through ``repro.kernels.ops`` — the same inputs, made from a seed with
numpy, on both sides.  f32 throughout, atol 1e-5: the two sides differ
only in the order of f32 sums.  The CUDA kernels themselves run only on
the card: ``tests/test_torch_cuda.py``.
"""

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
    paged_decode.reset_launch_counts()
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
