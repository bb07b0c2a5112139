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

Two tests check on the CPU the arithmetic the CUDA kernels reorder:
K4's split of the key axis (its ``split_plan``, each split's softmax
and the merge) against ``decode_attention_ref`` in f32 within 1e-5, and
K3's weights rounded to bf16 before P.V (a plain tiled flash attention
that rounds them as the tensor-core kernel does) against
``flash_attention_ref`` within one bf16 ulp of the largest |output|, the
tolerance ``chip_smoke.py`` holds the kernel to, at its K3 shapes.
For that row the Pallas kernel and ``layers.chunked_attention`` return
the mean of V over all keys and ``repro.kernels.ref.flash_attention_ref``
returns 0 (ROADMAP Queue 3); the port follows the Pallas kernel.  The
CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import decode_attention as kdecode  # noqa: E402
from repro_torch.kernels import splits  # noqa: E402
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


def _split_merge_decode(q, k, v, cur_pos, window, n_splits, split_len):
    """K4's arithmetic in plain torch: each split of the key axis keeps
    (m, l, acc) of its kept keys (m = -inf, l = 0 where it keeps none),
    and the splits merge in order; a row that keeps no key scores 0 on
    every key (the mean of V)."""
    b, h, hd = q.shape
    kr = ref.repeat_kv(k, h // k.shape[1]).float()
    vr = ref.repeat_kv(v, h // k.shape[1]).float()
    s = kr.shape[2]
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), kr) / math.sqrt(hd)
    k_pos = torch.arange(s)
    cur = cur_pos.long()[:, None]
    keep = k_pos[None, :] <= cur
    if window:
        keep &= k_pos[None, :] > cur - window
    uniform = ~keep.any(dim=1)
    keep[uniform] = True
    logits = torch.where(uniform[:, None, None], 0.0, logits)
    parts = []
    for sp in range(n_splits):
        cols = slice(sp * split_len, min(s, (sp + 1) * split_len))
        x = torch.where(keep[:, None, cols], logits[..., cols], -math.inf)
        m = x.amax(dim=-1)
        p = torch.exp(x - torch.where(torch.isinf(m), 0.0, m)[..., None])
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bhk,bhkd->bhd", p, vr[:, :, cols])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros(b, h, hd)
    for m, l, a in parts:
        w = torch.where(l > 0, torch.exp(m - m_all), 0.0)
        l_all = l_all + l * w
        acc = acc + a * w[..., None]
    return acc / l_all[..., None]


# (seed, B, H, KV, S, hd, window, positions): the chip_smoke.py K4 shapes
# with positions at split edges, empty splits, windowed rows and rows
# that keep no key (cur_pos -1)
SPLIT_DECODE = [
    (50, 1, 16, 8, 1024, 128, 0, [199]),
    (51, 1, 16, 8, 1024, 128, 0, [63]),
    (52, 1, 16, 8, 1024, 128, 0, [64]),
    (53, 1, 16, 8, 1024, 128, 0, [-1]),
    (54, 8, 4, 1, 1024, 256, 0, [0, 1023, 63, 64, 65, 511, 512, -1]),
    (55, 8, 16, 8, 1024, 128, 512, [386, 935, 511, 779, 652, 545, -1, 0]),
    (56, 8, 24, 8, 1024, 64, 0, [331, 910, 380, 469, 456, 30, 92, 875]),
    (57, 3, 6, 2, 300, 64, 7, [-1, 150, 299]),
]


@pytest.mark.parametrize("sms", [132, 114])  # an H100 SXM's SMs, PCIe's
@pytest.mark.parametrize("seed,b,h,kv,s,hd,window,positions", SPLIT_DECODE)
def test_decode_split_merge_matches_ref(seed, b, h, kv, s, hd, window,
                                        positions, sms):
    n_splits, split_len = kdecode.split_plan(b, h, kv, s, sms)
    assert n_splits * split_len >= s > (n_splits - 1) * split_len
    assert split_len >= min(s, kdecode.MIN_SPLIT)
    if s >= 2 * kdecode.MIN_SPLIT:
        assert n_splits > 1
    q, k, v = (torch.from_numpy(a) for a in _cache(seed, b, h, kv, s, hd))
    pos = torch.tensor(positions, dtype=torch.int32)
    out = _split_merge_decode(q, k, v, pos, window, n_splits, split_len)
    gold = ref.decode_attention_ref(q, k, v, pos, window=window)
    np.testing.assert_allclose(out.numpy(), gold.numpy(), atol=ATOL)


def test_decode_workspace_is_kept_per_stream():
    """K4's split workspace: one per (device, stream), reused while it is
    large enough and replaced by a larger one when a call needs more."""
    dev = torch.device("cpu")
    try:
        a = splits.workspace(dev, -1, 64)
        assert a.dtype == torch.float32 and a.numel() == 64
        assert splits.workspace(dev, -1, 32) is a
        b = splits.workspace(dev, -1, 128)
        assert b is not a and b.numel() == 128
        assert splits.workspace(dev, -1, 64) is b
        assert splits.workspace(dev, -2, 32) is not b
    finally:
        splits._workspaces.pop((dev, -1), None)
        splits._workspaces.pop((dev, -2), None)


def _flash_bf16_p(q, k, v, causal, window, q_offset, tile, parts):
    """K3's tensor-core arithmetic in plain torch: f32 scores of the
    inputs in log2 units, an online softmax over key tiles of ``tile``,
    the weights as the P.V products take them — ``parts`` 1: P rounded to
    bf16 (and summed so); 2: P_hi + P_lo, two bf16 parts (the shipped
    kernel; the row sum in f32) — and one rounding of the output to q's
    dtype.  A row that keeps no key scores 0 on every key."""
    b, h, sq, hd = q.shape
    kr = ref.repeat_kv(k, h // k.shape[1]).float()
    vr = ref.repeat_kv(v, h // k.shape[1]).float()
    sk = kr.shape[2]
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    keep = (kp <= qp) if causal else torch.ones(sq, sk, dtype=torch.bool)
    if window:
        keep &= qp - kp < window
    empty = ~keep.any(dim=1)
    keep[empty] = True
    sl2 = math.log2(math.e) / math.sqrt(hd)
    m = torch.full((b, h, sq), ref.NEG_INF)
    l = torch.zeros(b, h, sq)
    o = torch.zeros(b, h, sq, hd)
    for k0 in range(0, sk, tile):
        cols = slice(k0, k0 + tile)
        x = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr[:, :, cols]) * sl2
        x = torch.where(empty[:, None], 0.0, x)
        x = torch.where(keep[:, cols], x, -math.inf)
        mx = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx[..., None])
        p_hi = p.bfloat16().float()
        w = p_hi if parts == 1 else p_hi + (p - p_hi).bfloat16().float()
        l = l * alpha + (w if parts == 1 else p).sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", w,
                                                vr[:, :, cols])
        m = mx
    return (o / l[..., None]).to(q.dtype)


# chip_smoke.py's FLASH_CASES: (B, H, KV, Sq, Sk, hd, causal, window,
# q_offset), with the kernel's key tile (32 keys at hd 256, else 64)
BF16_P_FLASH = [
    (1, 16, 8, 64, 64, 128, True, 0, 0),
    (1, 16, 8, 1024, 1024, 128, True, 0, 0),
    (1, 4, 1, 1024, 1024, 256, True, 512, 0),
    (1, 32, 32, 1024, 1024, 64, True, 0, 0),
    (1, 4, 2, 37, 37, 16, True, 4, 5),
]


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window,q_offset",
                         BF16_P_FLASH)
def test_flash_bf16_weights_stay_within_one_ulp(b, h, kv, sq, sk, hd, causal,
                                                window, q_offset, parts):
    """The softmax weights in bf16 (one part, or hi + lo as K3 ships)
    keep K3 within the bf16 tolerance of its plain version: one ulp at
    the largest |output|.  Before the output's own rounding the two
    differ by less than half that ulp with one part, so the one rounding
    of each cannot put them two ulps apart; with two parts by less than
    a 256th of it (the weights keep about 16 bits)."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(sq + hd, b, h, kv, sq, sk, hd))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tile = 32 if hd > 128 else 64
    out = _flash_bf16_p(q, k, v, tile=tile, parts=parts, **kw)
    gold = ref.flash_attention_ref(q, k, v, **kw)
    ulp = 2.0 ** (math.floor(math.log2(gold.float().abs().max().item())) - 7)
    err = (out.float() - gold.float()).abs().max().item()
    assert torch.isfinite(out.float()).all()
    assert err <= ulp, (err, ulp)
    # the same bf16 values in f32: no rounding of the output on either side
    qf, kf, vf = q.float(), k.float(), v.float()
    unrounded = _flash_bf16_p(qf, kf, vf, tile=tile, parts=parts, **kw)
    exact = ref.flash_attention_ref(qf, kf, vf, **kw)
    diff = (unrounded - exact).abs().max().item()
    assert diff < (ulp / 2 if parts == 1 else ulp / 256), (diff, ulp)


def test_flash_backward_routes():
    """K3's backward takes the wgmma kernels in bf16 at hd 64 and 128, the
    mma.sync kernels at every other bf16 width (MLA's 192, gemma3's 256,
    the narrow smoke widths), the CUDA-core kernels in f32; the card tests
    run each route (``test_torch_cuda.BWD_SHAPES``)."""
    from repro_torch.kernels.flash_attention import (
        WGMMA_HEAD_DIMS, bwd_route,
    )
    assert WGMMA_HEAD_DIMS == (64, 128)
    assert [bwd_route(torch.bfloat16, hd) for hd in (16, 32, 64, 128, 192,
                                                      256)] == [
        "mma", "mma", "wgmma", "wgmma", "mma", "mma"]
    assert {bwd_route(torch.float32, hd) for hd in (16, 64, 128, 256)} == {
        "f32"}
