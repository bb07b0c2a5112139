"""Prefill and decode attention of the port against the JAX package's.

The plain PyTorch versions of K3 (``flash_attention``) and K4
(``decode_attention``) — what ``repro_torch.kernels.ops`` runs on CPU
tensors, and what the CUDA kernels are held against on the card — are
compared with the jnp oracles in ``repro.kernels.ref``, with the Pallas
kernels run in interpret mode through ``repro.kernels.ops``, and with
the jnp twins in ``repro.models.layers``, on the same inputs made from a
seed with numpy.  The port takes grouped-query K/V ``[B, KV, S, hd]``;
the Pallas kernels take K/V repeated to the q heads and flattened to
``[B·H, S, hd]``, so their side gets ``np.repeat``.  f32 throughout,
atol 1e-5: the sides differ only in the order of f32 sums.

Shapes: the ``tests/test_kernels.py`` sweep (multiples of the Pallas
blocks), grouped-query heads, ragged lengths, ``q_offset``, sliding
windows, per-row decode positions, and a prefill row that keeps no key.
For that row the Pallas kernel and ``layers.chunked_attention`` return
the mean of V over all keys and ``repro.kernels.ref.flash_attention_ref``
returns 0 (ROADMAP Queue 3); the port follows the Pallas kernel.  The
CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import decode_attention as kdecode  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

ATOL = 1e-5  # f32 against f32: summation order only


def _qkv(seed, b, h, kv, sq, sk, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, hd), dtype=np.float32)
    k = rng.standard_normal((b, kv, sk, hd), dtype=np.float32)
    v = rng.standard_normal((b, kv, sk, hd), dtype=np.float32)
    return q, k, v


def _flat(x, heads):
    """[B, KV, S, hd] → the Pallas layout [B·H, S, hd] (KV repeated)."""
    b, kv, s, hd = x.shape
    return np.repeat(x, heads // kv, axis=1).reshape(b * heads, s, hd)


def _plain_flash(q, k, v, **kw):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return ops.flash_attention(*t, **kw).numpy()


# (seed, B, H, KV, Sq, Sk, hd, causal, window, q_offset)
PALLAS_FLASH = [
    # tests/test_kernels.py TestFlashAttention.test_modes
    (0, 1, 2, 2, 128, 128, 64, True, 0, 0),
    (1, 1, 2, 2, 128, 128, 64, True, 32, 0),
    (2, 1, 2, 2, 128, 128, 64, False, 0, 0),
    # its shape sweep: block multiples, q_offset 0 | 64
    (3, 1, 3, 3, 64, 128, 32, True, 0, 64),
    (4, 1, 1, 1, 192, 256, 128, True, 0, 64),
    # grouped-query heads (G = 2 and 4), a window with an offset
    (5, 2, 4, 2, 64, 128, 32, True, 0, 64),
    (6, 1, 4, 1, 128, 128, 16, True, 16, 0),
]


@pytest.mark.parametrize(
    "seed,b,h,kv,sq,sk,hd,causal,window,q_offset", PALLAS_FLASH
)
def test_flash_plain_matches_pallas_and_ref(seed, b, h, kv, sq, sk, hd,
                                            causal, window, q_offset):
    q, k, v = _qkv(seed, b, h, kv, sq, sk, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = _plain_flash(q, k, v, **kw).reshape(b * h, sq, hd)
    qf, kf, vf = q.reshape(b * h, sq, hd), _flat(k, h), _flat(v, h)
    pallas = jops.flash_attention(qf, kf, vf, block_q=64, block_k=64,
                                  interpret=True, **kw)
    gold = jref.flash_attention_ref(qf, kf, vf, **kw)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(gold), atol=ATOL)


# ragged lengths the Pallas kernel rejects: against the jnp twin
RAGGED_FLASH = [
    (10, 1, 4, 2, 37, 37, 16, True, 0, 0),
    (11, 2, 4, 1, 5, 12, 16, True, 0, 7),
    (12, 1, 4, 2, 37, 45, 16, True, 5, 8),
    (13, 1, 2, 1, 65, 65, 24, True, 0, 0),
    (14, 2, 2, 2, 9, 30, 8, False, 0, 0),
]


@pytest.mark.parametrize(
    "seed,b,h,kv,sq,sk,hd,causal,window,q_offset", RAGGED_FLASH
)
def test_flash_plain_ragged_matches_chunked_attention(seed, b, h, kv, sq, sk,
                                                      hd, causal, window,
                                                      q_offset):
    q, k, v = _qkv(seed, b, h, kv, sq, sk, hd)
    out = _plain_flash(q, k, v, causal=causal, window=window,
                       q_offset=q_offset)
    gold = jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window or None, q_offset=q_offset,
    )
    np.testing.assert_allclose(out, np.asarray(gold), atol=ATOL)


def test_flash_row_without_a_key_is_mean_of_v():
    """q_offset 32, window 8, Sk 64: rows at positions >= 71 keep no key.
    The Pallas kernel (finite NEG_INF) returns the mean of V over all 64
    keys there and the port's plain version does the same; the jnp
    oracle ``repro.kernels.ref.flash_attention_ref`` returns 0 (see
    ROADMAP Queue 3)."""
    b, h, sq, sk, hd = 1, 2, 64, 64, 16
    q, k, v = _qkv(20, b, h, h, sq, sk, hd)
    kw = dict(causal=True, window=8, q_offset=32)
    out = _plain_flash(q, k, v, **kw).reshape(b * h, sq, hd)
    qf, kf, vf = q.reshape(b * h, sq, hd), _flat(k, h), _flat(v, h)
    pallas = np.asarray(jops.flash_attention(
        qf, kf, vf, block_q=64, block_k=64, interpret=True, **kw))
    np.testing.assert_allclose(out, pallas, atol=ATOL)
    empty = slice(71 - 32, sq)
    mean_v = vf.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(out[:, empty], np.broadcast_to(
        mean_v, out[:, empty].shape), atol=ATOL)
    oracle = np.asarray(jref.flash_attention_ref(qf, kf, vf, **kw))
    assert np.abs(oracle[:, empty]).max() == 0.0
    assert np.abs(out[:, empty]).max() > 0.0


def _cache(seed, b, h, kv, s, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, kv, s, hd), dtype=np.float32)
    v = rng.standard_normal((b, kv, s, hd), dtype=np.float32)
    return q, k, v


def _plain_decode(q, k, v, pos, window):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return ops.decode_attention(
        *t, torch.tensor(pos, dtype=torch.int32), window=window
    ).numpy()


# (seed, B, H, KV, S, hd, per-row positions, window, Pallas block_k)
DECODE = [
    # tests/test_kernels.py TestDecodeAttention: positions and window
    (0, 1, 4, 4, 256, 64, [0], 0, 64),
    (1, 1, 4, 4, 256, 64, [63], 0, 64),
    (2, 1, 4, 4, 256, 64, [100], 0, 64),
    (3, 1, 4, 4, 256, 64, [255], 0, 64),
    (4, 1, 2, 2, 128, 32, [100], 16, 32),
    # grouped-query heads with a position per row, with and without window
    (5, 3, 4, 2, 96, 16, [5, 90, 47], 0, 32),
    (6, 2, 4, 1, 64, 256, [63, 17], 8, 64),
    (7, 2, 16, 8, 128, 128, [0, 127], 0, 128),
]


@pytest.mark.parametrize("seed,b,h,kv,s,hd,pos,window,block_k", DECODE)
def test_decode_plain_matches_pallas_and_ref(seed, b, h, kv, s, hd, pos,
                                             window, block_k):
    """The Pallas kernel and the oracle take one position for all rows:
    each row is compared with its own call."""
    q, k, v = _cache(seed, b, h, kv, s, hd)
    out = _plain_decode(q, k, v, pos, window)
    for r, p in enumerate(pos):
        qf = q[r]
        kf, vf = _flat(k[r:r + 1], h), _flat(v[r:r + 1], h)
        pallas = jops.decode_attention(qf, kf, vf, p, window=window,
                                       block_k=block_k, interpret=True)
        gold = jref.decode_attention_ref(qf, kf, vf, p, window=window)
        np.testing.assert_allclose(out[r], np.asarray(pallas), atol=ATOL)
        np.testing.assert_allclose(out[r], np.asarray(gold), atol=ATOL)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_layer_matches_jnp_twin(window):
    """``layers.decode_attention`` ([B, H, 1, hd], per-row positions)
    against the jnp twin, row by row."""
    q, k, v = _cache(30, 3, 4, 2, 24, 16)
    pos = [23, 0, 11]
    out = tlayers.decode_attention(
        torch.from_numpy(q[:, :, None]), torch.from_numpy(k),
        torch.from_numpy(v), torch.tensor(pos), window=window,
    ).numpy()
    for r, p in enumerate(pos):
        gold = jlayers.decode_attention(
            q[r:r + 1, :, None], k[r:r + 1], v[r:r + 1], jnp.int32(p),
            window=window,
        )
        np.testing.assert_allclose(out[r:r + 1], np.asarray(gold),
                                   atol=ATOL)


@pytest.mark.parametrize("pos", [[3, 21], [7, 8], [0, 40]])
def test_decode_ring_matches_jnp_twin(pos):
    """The ring-buffer decode of sliding-window layers (plain torch on
    every device) against ``layers.decode_attention_ring``, row by row:
    before the ring fills, at the wrap, and twice around."""
    window = 8
    q, k, v = _cache(31, 2, 4, 1, window, 16)
    out = tlayers.decode_attention_ring(
        torch.from_numpy(q[:, :, None]), torch.from_numpy(k),
        torch.from_numpy(v), torch.tensor(pos), window,
    ).numpy()
    for r, p in enumerate(pos):
        gold = jlayers.decode_attention_ring(
            q[r:r + 1, :, None], k[r:r + 1], v[r:r + 1], jnp.int32(p),
            window,
        )
        np.testing.assert_allclose(out[r:r + 1], np.asarray(gold),
                                   atol=ATOL)


def test_strided_operands_take_the_same_path():
    """The model hands K3 transposed views of its projections; the plain
    version reads them as it reads contiguous tensors."""
    q, k, v = _qkv(40, 2, 4, 2, 9, 9, 16)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in t]
    assert not views[0].is_contiguous()
    a = ops.flash_attention(*t, causal=True)
    b = ops.flash_attention(*views, causal=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpu_tensors_launch_no_kernel():
    ops.reset_launch_counts()
    q, k, v = _qkv(41, 1, 2, 1, 8, 8, 16)
    _plain_flash(q, k, v, causal=True)
    qd, kd, vd = _cache(42, 1, 2, 1, 8, 16)
    _plain_decode(qd, kd, vd, [5], 0)
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)


def test_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only — they never fall back
    to the plain version."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(43, 1, 2, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        kdecode.decode_attention(q[:, :, 0], k, v,
                                 torch.zeros(1, dtype=torch.int32))


def test_plain_switch_is_scoped():
    """``plain_on_card`` holds only inside its block, and restores the
    previous state when the block raises."""
    assert not ops._PLAIN.get()
    with ops.plain_on_card():
        assert ops._PLAIN.get()
    with pytest.raises(RuntimeError):
        with ops.plain_on_card():
            raise RuntimeError("inside")
    assert not ops._PLAIN.get()


def test_plain_versions_keep_q_dtype():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(44, 1, 2, 1, 8, 8, 16))
    assert ref.flash_attention_ref(q, k, v).dtype == torch.bfloat16
    out = ref.decode_attention_ref(q[:, :, 0], k, v,
                                   torch.tensor([3], dtype=torch.int32))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 16)
