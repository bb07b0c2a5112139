"""The port on the card: CUDA kernels against their plain versions, and
the engine's paths through them.

Tolerances: in f32 the kernels and the plain versions differ only in the
order of f32 sums (1e-5); the SSD scan (K6) within ``SSD_RTOL`` = 1e-3
of its largest |output|, the JAX package's own tolerance for its scan
kernel against the sequential recurrence (both sum the running decay in
one order; their contractions' f32 sums differ in order, and
exp(seg_i - seg_j) of two decay sums of order 10^3 would amplify any
difference in those).  In bf16 both compute in f32 from the same
bf16 inputs and round the output once, so they differ by at most one
bf16 ulp (8 significant bits) at the largest |output| — the limit
``chip_smoke.py`` states too.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips with a
reason elsewhere.  The file imports no JAX, so it runs on a machine that
has only PyTorch:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops, paged_decode, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, split_plan,
)
from repro_torch.kernels.splits import sm_count  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd,
)
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul, grouped_matmul_bwd,
)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_scan, ssd_scan_bwd,
)
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.transformer import _quantize_pool_int8  # noqa: E402
from repro_torch.sched import MursConfig, MursPolicy  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda

F32_ATOL = 1e-5  # f32 against f32: summation order only


def _atol(plain):
    """F32_ATOL in f32; in bf16 one bf16 ulp at the largest |plain|."""
    if plain.dtype == torch.float32:
        return F32_ATOL
    return 2.0 ** (math.floor(math.log2(plain.float().abs().max().item()))
                   - 7)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch has no CUDA device here")
    return torch.device("cuda")


def _case(dev, dtype, *, seed, bh, width, page, hd, zero_row=True):
    rng = np.random.default_rng(seed)
    n_pool = bh * width + 3
    table = rng.permutation(n_pool)[: bh * width].reshape(bh, width)
    lens = rng.integers(1, width * page + 1, size=bh)
    if zero_row:
        lens[-1] = 0
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(bh, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(n_pool, page, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(n_pool, page, hd, generator=g, device=dev).to(dtype)
    return (q, k, v, torch.as_tensor(table, dtype=torch.int32, device=dev),
            torch.as_tensor(lens, dtype=torch.int32, device=dev))


SHAPES = [  # (bh, width, page, hd): smoke, odd widths, the serving path
    (4, 3, 16, 16), (5, 2, 8, 24), (7, 4, 32, 64), (128, 64, 16, 128),
    (3, 2, 16, 256),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,width,page,hd", SHAPES)
def test_kernel_matches_plain(dev, dtype, bh, width, page, hd):
    dt = getattr(torch, dtype)
    args = _case(dev, dt, seed=hd + bh, bh=bh, width=width, page=page, hd=hd)
    out = paged_decode.paged_decode_attention(*args)
    plain = ref.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert out.dtype == dt and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,width,page,hd", SHAPES)
def test_int8_kernel_matches_plain(dev, dtype, bh, width, page, hd):
    dt = getattr(torch, dtype)
    q, k, v, table, lens = _case(dev, dt, seed=hd + bh + 1, bh=bh,
                                 width=width, page=page, hd=hd)
    kc, ks = _quantize_pool_int8(k)
    vc, vs = _quantize_pool_int8(v)
    args = (q, kc, vc, ks, vs, table, lens)
    out = paged_decode.paged_decode_attention_int8(*args)
    plain = ref.paged_decode_attention_int8_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)


def test_wrapper_rejects_what_the_kernel_cannot_take(dev):
    q, k, v, table, lens = _case(dev, torch.float32, seed=1, bh=2, width=2,
                                 page=16, hd=16)
    with pytest.raises(TypeError):
        paged_decode.paged_decode_attention(q, k, v, table.long(), lens)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_decode.paged_decode_attention(q[:, :12].contiguous(),
                                            k[..., :12].contiguous(),
                                            v[..., :12].contiguous(),
                                            table, lens)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode.paged_decode_attention(q, k, v, table.t(), lens)


def _grouped(dev, dtype, *, seed, lens, g, kv, hd, page, width,
             bad_pid=False):
    """A folded batch as the model builds it: request b's table row
    repeated for its G·KV q-heads with the kv-head offset (h // G) ·
    n_pool, its length repeated; with ``bad_pid`` the first entry names a
    page past the pool (the kernel clamps it)."""
    rng = np.random.default_rng(seed)
    reqs, h = len(lens), g * kv
    n_pool = reqs * width + 3
    perm = rng.permutation(n_pool)[: reqs * width].reshape(reqs, width)
    table = (perm[:, None, :] + (np.arange(h) // g)[None, :, None]
             * n_pool).reshape(reqs * h, width)
    if bad_pid:
        table[:g, 0] = 10**6  # every row of the first group
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(reqs * h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(kv * n_pool, page, hd, generator=gen,
                    device=dev).to(dtype)
    v = torch.randn(kv * n_pool, page, hd, generator=gen,
                    device=dev).to(dtype)
    return (q, k, v, torch.as_tensor(table, dtype=torch.int32, device=dev),
            torch.as_tensor(np.repeat(lens, h), dtype=torch.int32,
                            device=dev))


# (lens per request, G, KV, hd, page, W): G 1-4; hd 64, 128 and 256;
# pages of 8, 16 and 32; zero-length rows; lengths on page and split
# edges of the card's own plan (64 pages of 16 split in 8s: 128, 129,
# 127); a table wider than one split may sweep (130 pages)
GROUPED = [
    ([0, 128, 129, 127, 1, 1024, 500, 16], 2, 8, 128, 16, 64),
    ([700, 0, 33, 257, 64, 1023, 1, 512], 3, 8, 64, 16, 64),
    ([40, 0, 95], 4, 2, 128, 8, 12),
    ([9, 100], 1, 4, 64, 32, 130),
    ([250, 0, 31], 4, 1, 256, 16, 16),
    ([17, 300], 3, 2, 256, 8, 40),
    ([16, 48, 0], 2, 1, 64, 16, 4),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens,g,kv,hd,page,width", GROUPED)
def test_grouped_kernel_matches_plain(dev, int8, dtype, lens, g, kv, hd,
                                      page, width):
    dt = getattr(torch, dtype)
    q, k, v, table, seq = _grouped(dev, dt, seed=hd + g + width, lens=lens,
                                   g=g, kv=kv, hd=hd, page=page, width=width)
    if int8:
        kc, ks = _quantize_pool_int8(k)
        vc, vs = _quantize_pool_int8(v)
        args = (q, kc, vc, ks, vs, table, seq)
        out = paged_decode.paged_decode_attention_int8(*args, q_per_kv=g)
        plain = ref.paged_decode_attention_int8_ref(*args)
    else:
        args = (q, k, v, table, seq)
        out = paged_decode.paged_decode_attention(*args, q_per_kv=g)
        plain = ref.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert out.dtype == dt and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_grouped_kernel_clamps_page_ids(dev, int8):
    """A table entry past the pool reads the pool's last page, as the JAX
    gather clamps; the plain version takes the clamped table."""
    q, k, v, table, seq = _grouped(dev, torch.bfloat16, seed=5,
                                   lens=[40, 30], g=2, kv=2, hd=64, page=16,
                                   width=4, bad_pid=True)
    clamped = table.clamp(0, k.shape[0] - 1)
    if int8:
        kc, ks = _quantize_pool_int8(k)
        vc, vs = _quantize_pool_int8(v)
        out = paged_decode.paged_decode_attention_int8(
            q, kc, vc, ks, vs, table, seq, q_per_kv=2)
        plain = ref.paged_decode_attention_int8_ref(
            q, kc, vc, ks, vs, clamped, seq)
    else:
        out = paged_decode.paged_decode_attention(q, k, v, table, seq,
                                                  q_per_kv=2)
        plain = ref.paged_decode_attention_ref(q, k, v, clamped, seq)
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)


def test_grouped_wrapper_refuses_ragged_groups(dev):
    q, k, v, table, seq = _grouped(dev, torch.float32, seed=6, lens=[5, 9],
                                   g=2, kv=1, hd=16, page=16, width=2)
    with pytest.raises(ValueError, match="q_per_kv"):
        paged_decode.paged_decode_attention(q, k, v, table, seq, q_per_kv=3)


def test_paged_and_gmm_kernels_are_deterministic(dev):
    """Two launches on the same inputs give the same bits: K1 and K2 merge
    their splits in split order whichever CTA arrives last, K5 sums D in
    one order, and K5's backward sums F (dx) and C (dw) whole in one CTA
    each, in one order."""
    q, k, v, table, seq = _grouped(dev, torch.bfloat16, seed=7,
                                   lens=[0, 128, 129, 1000, 77, 513, 1, 64],
                                   g=2, kv=8, hd=128, page=16, width=64)
    kc, ks = _quantize_pool_int8(k)
    vc, vs = _quantize_pool_int8(v)
    outs = []
    for _ in range(2):
        outs.append((
            paged_decode.paged_decode_attention(q, k, v, table, seq,
                                                q_per_kv=2),
            paged_decode.paged_decode_attention_int8(
                q, kc, vc, ks, vs, table, seq, q_per_kv=2),
        ))
    gen = torch.Generator(device=dev).manual_seed(8)
    x = _rand(gen, dev, torch.bfloat16, 40, 256, 1536)
    w = _rand(gen, dev, torch.bfloat16, 40, 1536, 512)
    xd = _rand(gen, dev, torch.bfloat16, 40, 4, 1536)
    dy = _rand(gen, dev, torch.bfloat16, 40, 256, 512)
    gm = [(grouped_matmul(x, w), grouped_matmul(xd, w),
           *grouped_matmul_bwd(x, w, dy)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(outs[0] + gm[0], outs[1] + gm[1]):
        assert torch.equal(a, b)


def _rand(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


# (B, H, KV, Sq, Sk, hd, causal, window, q_offset): chip_smoke.py's K3
# shapes — internlm2's first chunk and full prompt, a gemma3 local layer,
# a zamba2 prompt, the smoke shape (hd 16, ragged, two rows that keep no
# key) — odd widths, the hd 64 and hd 32 templates, an Sk that is not a
# multiple of the 64-key tile, window edges inside a key tile (64 keys,
# 32 at hd 256), and grids large enough (B H blocks >= 2 x 132 SMs) for
# one warp group a CTA, ragged, windowed and with rows that keep no key
FLASH_SHAPES = [
    (1, 16, 8, 64, 64, 128, True, 0, 0),
    (1, 16, 8, 1024, 1024, 128, True, 0, 0),
    (1, 4, 1, 1024, 1024, 256, True, 512, 0),
    (1, 32, 32, 1024, 1024, 64, True, 0, 0),
    (1, 4, 2, 37, 37, 16, True, 4, 5),
    (2, 6, 3, 65, 100, 24, False, 0, 0),
    (1, 2, 1, 33, 97, 256, True, 16, 64),
    (2, 24, 8, 200, 200, 64, True, 0, 0),
    (2, 4, 4, 130, 130, 32, True, 0, 0),
    (1, 4, 2, 50, 157, 128, True, 0, 107),
    (1, 4, 2, 96, 157, 128, False, 0, 0),
    (1, 4, 2, 192, 192, 128, True, 40, 0),
    (1, 4, 1, 256, 256, 256, True, 100, 0),
    (2, 16, 8, 600, 600, 128, True, 100, 0),
    (6, 8, 1, 512, 512, 256, True, 300, 0),
    (2, 140, 70, 37, 37, 16, True, 4, 5),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window,q_offset",
                         FLASH_SHAPES)
def test_flash_kernel_matches_plain(dev, dtype, b, h, kv, sq, sk, hd, causal,
                                    window, q_offset):
    """K3 on the model's layout: q and k contiguous, v a transposed view
    of a [B, S, KV, hd] buffer, as ``blocks._qkv`` makes it."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(sq + hd)
    q = _rand(gen, dev, dt, b, h, sq, hd)
    k = _rand(gen, dev, dt, b, kv, sk, hd)
    v = _rand(gen, dev, dt, b, sk, kv, hd).transpose(1, 2)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash_attention(q, k, v, **kw)
    plain = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == (b, h, sq, hd)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)


# (B, H, KV, Sq, Sk, hd, vd, causal, q_offset): V narrower than q/k —
# deepseek-v2's MLA prefill (128 heads, q/k 192 wide, V 128) at a
# 160-token prompt, and small odd shapes with grouped heads and an offset
NARROW_V_SHAPES = [
    (1, 128, 128, 160, 160, 192, 128, True, 0),
    (2, 6, 3, 37, 50, 24, 16, True, 13),
    (1, 4, 2, 65, 65, 192, 128, False, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,vd,causal,q_offset",
                         NARROW_V_SHAPES)
def test_flash_kernel_with_narrow_v_matches_plain(dev, dtype, b, h, kv, sq,
                                                  sk, hd, vd, causal,
                                                  q_offset):
    """K3 with V zero-padded to q's width in the wrapper: one launch, the
    output V's width, within the plain version's tolerance."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(sq + hd + vd)
    q = _rand(gen, dev, dt, b, h, sq, hd)
    k = _rand(gen, dev, dt, b, kv, sk, hd)
    v = _rand(gen, dev, dt, b, sk, kv, vd).transpose(1, 2)
    kw = dict(causal=causal, q_offset=q_offset)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    plain = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == (b, h, sq, vd)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)


# (B, H, KV, S, hd, window): chip_smoke.py's K4 shapes — the
# chunked-prefill continuation, the dense batch, a gemma3 global layer,
# the dense batch with a window — and odd widths
DECODE_SHAPES = [
    (1, 16, 8, 1024, 128, 0),
    (8, 16, 8, 1024, 128, 0),
    (8, 4, 1, 1024, 256, 0),
    (8, 16, 8, 1024, 128, 512),
    (3, 6, 2, 50, 24, 7),
    (2, 3, 3, 17, 16, 0),
    (8, 24, 8, 1024, 64, 0),
    (8, 4, 1, 1024, 256, 300),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,hd,window", DECODE_SHAPES)
def test_decode_kernel_matches_plain(dev, dtype, b, h, kv, s, hd, window):
    """K4 on a layer view of a slot cache [reps, n_slots, KV, S, hd],
    one position per row (row 0 at position 0, one at the last slot)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(s + hd + b)
    q = _rand(gen, dev, dt, b, h, hd)
    cache = _rand(gen, dev, dt, 2, 2, b, kv, s, hd)
    k, v = cache[0, 1], cache[1, 0]
    pos = torch.randint(0, s, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = 0
    pos[-1] = s - 1
    out = decode_attention(q, k, v, pos, window=window)
    plain = ref.decode_attention_ref(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dt and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)


#: a position EDGE + d stands for d keys past the first split edge of K4's
#: plan on the card at hand (its split length)
EDGE = 1 << 20


# (B, H, KV, S, hd, window, positions): rows one before, at and one past
# the first split edge of the plan; the first and last slot; rows that
# keep no key (cur_pos -1: the mean of V over all S), alone and beside
# windowed rows
DECODE_POSITIONS = [
    (1, 16, 8, 1024, 128, 0, [EDGE - 1]),
    (1, 16, 8, 1024, 128, 0, [EDGE]),
    (1, 16, 8, 1024, 128, 0, [EDGE + 1]),
    (8, 4, 1, 1024, 256, 0, [0, 1023, 1, 1022, 64, 511, 512, 700]),
    (1, 16, 8, 1024, 128, 0, [-1]),
    (4, 16, 8, 1024, 128, 512, [-1, 0, 700, 1023]),
    (3, 6, 2, 300, 64, 0, [-1, 150, 299]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,hd,window,positions", DECODE_POSITIONS)
def test_decode_kernel_at_split_edges(dev, dtype, b, h, kv, s, hd, window,
                                      positions):
    """K4 where its key-axis splits meet, and where a row keeps no key."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(s + hd + b + 1)
    q = _rand(gen, dev, dt, b, h, hd)
    cache = _rand(gen, dev, dt, 2, b, kv, s, hd)
    k, v = cache[0], cache[1]
    n_splits, split_len = split_plan(b, h, kv, s,
                                     sm_count(torch.cuda.current_device()))
    assert n_splits > 1
    positions = [p - EDGE + split_len if p > EDGE // 2 else p
                 for p in positions]
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    out = decode_attention(q, k, v, pos, window=window)
    plain = ref.decode_attention_ref(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dt and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)


def test_attention_kernels_are_deterministic(dev):
    """Two launches on the same inputs give the same bits: K3's sums and
    K4's merge of its splits run in a fixed order."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q = _rand(gen, dev, torch.bfloat16, 1, 16, 1024, 128)
    k = _rand(gen, dev, torch.bfloat16, 1, 8, 1024, 128)
    v = _rand(gen, dev, torch.bfloat16, 1, 8, 1024, 128)
    a = flash_attention(q, k, v)
    b = flash_attention(q, k, v)
    qd = _rand(gen, dev, torch.bfloat16, 8, 4, 256)
    cache = _rand(gen, dev, torch.bfloat16, 2, 8, 1, 1024, 256)
    pos = torch.randint(0, 1024, (8,), generator=gen, device=dev,
                        dtype=torch.int32)
    c = decode_attention(qd, cache[0], cache[1], pos)
    d = decode_attention(qd, cache[0], cache[1], pos)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


def test_attention_wrappers_reject_what_the_kernels_cannot_take(dev):
    q = torch.randn(1, 2, 8, 16, device=dev)
    k = torch.randn(1, 1, 8, 16, device=dev)
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(q, k, torch.randn(1, 1, 8, 24, device=dev))
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q[..., 1:9], k[..., 1:9], k[..., 1:9])
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q[:, :, 0], k, k, torch.zeros(1, device=dev,
                                                       dtype=torch.int64))


def test_plain_switch_launches_nothing(dev):
    ops.reset_launch_counts()
    q = torch.randn(1, 2, 8, 16, device=dev)
    k = torch.randn(1, 1, 8, 16, device=dev)
    with ops.plain_on_card():
        ops.flash_attention(q, k, k)
        ops.decode_attention(q[:, :, 0], k, k,
                             torch.zeros(1, device=dev, dtype=torch.int32))
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)
    ops.flash_attention(q, k, k)
    assert flash_attention.launches == 1


def _engine(dev, **kw):
    cfg = ARCHS["internlm2-1.8b"].smoke()
    eng = ServingEngine(
        cfg, init_model(cfg, 0, device=dev),
        EngineConfig(n_slots=3, max_seq=64,
                     hbm_capacity_bytes=cfg.kv_bytes_per_token() * 16 * 6,
                     policy=MursPolicy(MursConfig.for_serving(period=1.0)),
                     device=str(dev), **kw),
    )
    shared = list(range(50, 66))
    for i in range(2):
        eng.submit(Request(f"A{i}", "A", list(range(10, 18)), 24))
    for i in range(3):
        eng.submit(Request(f"C{i}", "C", shared + [90 + i], 8))
    eng.run(max_ticks=600)
    return cfg, eng


@pytest.mark.parametrize("int8", [False, True])
def test_engine_decodes_through_the_kernel(dev, int8):
    ops.reset_launch_counts()
    cfg, eng = _engine(dev, paged_decode_int8=int8)
    assert len(eng.completed) == 5 and not eng.failed
    assert eng.paged_decode_ticks > 0
    fn = (paged_decode.paged_decode_attention_int8 if int8
          else paged_decode.paged_decode_attention)
    assert fn.launches == cfg.n_layers * eng.paged_decode_ticks


def test_gemma3_engine_runs_prefill_and_decode_kernels(dev):
    """Sliding-window gemma3 (smoke) serves through K3 and K4 on the card:
    every request completes, and decode never takes the paged path."""
    ops.reset_launch_counts()
    cfg = ARCHS["gemma3-1b"].smoke()
    eng = ServingEngine(
        cfg, init_model(cfg, 0, device=dev),
        EngineConfig(n_slots=3, max_seq=64, hbm_capacity_bytes=1e9,
                     prefill_chunk_tokens=32,
                     policy=MursPolicy(MursConfig.for_serving(period=1.0)),
                     device=str(dev)),
    )
    for i in range(3):
        eng.submit(Request(f"A{i}", "A", list(range(10, 50 + i)), 12))
    eng.run(max_ticks=600)
    assert len(eng.completed) == 3 and not eng.failed
    assert eng.paged_decode_ticks == 0
    assert flash_attention.launches > 0 and decode_attention.launches > 0


GMM_SHAPES = [  # (E, C, D, F): ragged, F not a multiple of 8 (bf16 takes
    # the CUDA-core kernel), three row tiles, granite's decode gate/up and
    # down (paged, C 4; dense per-row over 8 slots, C 32), prefills of 32,
    # 64, 65, 160, 400 and 1024 tokens (C 8, 16, 17, 40, 100, 256), the
    # tile edges at granite's widths (C 64 and 128, the 128 x 256 tile in
    # both orientations), and one row past a 128-row tile with a D that
    # ends inside a 64-deep chunk and an F that ends inside a column tile
    (3, 5, 72, 40), (2, 3, 10, 13), (2, 300, 64, 48), (40, 4, 1536, 512),
    (40, 4, 512, 1536), (40, 32, 1536, 512), (40, 8, 1536, 512),
    (40, 16, 1536, 512), (40, 17, 1536, 512), (40, 40, 1536, 512),
    (40, 40, 512, 1536), (40, 100, 1536, 512), (40, 256, 1536, 512),
    (40, 64, 1536, 512), (40, 128, 1536, 512), (40, 128, 512, 1536),
    (5, 129, 1528, 264),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_grouped_matmul_kernel_matches_plain(dev, dtype, e, c, d, f):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(e * c + d + f)
    x = torch.randn(e, c, d, generator=g, device=dev).to(dt)
    w = (torch.randn(e, d, f, generator=g, device=dev) / math.sqrt(d)).to(dt)
    out = grouped_matmul(x, w)
    plain = ref.grouped_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == (e, c, f)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_reads_x_through_strides(dev, dtype):
    """x an [E, C, D] view of [C, E, D] (rows contiguous, strided
    experts)."""
    dt = getattr(torch, dtype)
    x = torch.randn(6, 5, 64, device=dev).to(dt).transpose(0, 1)
    w = (torch.randn(5, 64, 24, device=dev) / 8).to(dt)
    out = grouped_matmul(x, w)
    plain = ref.grouped_matmul_ref(x, w)
    torch.testing.assert_close(out.float(), plain.float(),
                               atol=_atol(plain), rtol=0)


def test_grouped_matmul_wrapper_rejects_what_the_kernel_cannot_take(dev):
    x = torch.randn(2, 3, 8, device=dev)
    w = torch.randn(2, 8, 4, device=dev)
    with pytest.raises(TypeError):
        grouped_matmul(x, w.bfloat16())
    with pytest.raises(ValueError, match="chain"):
        grouped_matmul(x, torch.randn(2, 6, 4, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        grouped_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul(x.cpu(), w)


# (E, C, D, F): deepseek-v2's expert GEMMs — the dense decode's C 32 and a
# prefill's C 8, gate/up and down (each weight 2.5 GB in bf16)
DEEPSEEK_GMM_SHAPES = [
    (160, 32, 5120, 1536), (160, 32, 1536, 5120), (160, 8, 5120, 1536),
    (160, 8, 1536, 5120),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", DEEPSEEK_GMM_SHAPES)
def test_grouped_matmul_at_160_experts(dev, dtype, e, c, d, f):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(e * c + d + f)
    x = torch.randn(e, c, d, generator=g, device=dev).to(dt)
    w = (torch.randn(e, d, f, generator=g, device=dev) / math.sqrt(d)).to(dt)
    out = grouped_matmul(x, w)
    plain = ref.grouped_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == (e, c, f)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=_atol(plain),
                               rtol=0)
    del x, w, out, plain
    torch.cuda.empty_cache()


def test_deepseek_engine_runs_mla_through_k3_and_k5(dev):
    """deepseek-v2 (smoke) on the engine's dense path on the card: K3 once
    per layer of every prefill (V narrower than q/k), K5 three times per
    layer of every model call, and no K1, K2 or K4 (MLA decodes in its
    absorbed form, plain torch)."""
    ops.reset_launch_counts()
    cfg = ARCHS["deepseek-v2-236b"].smoke()
    eng = ServingEngine(
        cfg, init_model(cfg, 0, device=dev),
        EngineConfig(n_slots=3, max_seq=64, hbm_capacity_bytes=1e9,
                     policy=MursPolicy(MursConfig.for_serving(period=1.0)),
                     device=str(dev)),
    )
    for i in range(3):
        eng.submit(Request(f"A{i}", "A", list(range(10, 20 + i)), 8))
    eng.run(max_ticks=600)
    assert len(eng.completed) == 3 and not eng.failed
    assert eng.paged_decode_ticks == 0
    assert flash_attention.launches > 0
    assert flash_attention.launches % cfg.n_layers == 0
    assert decode_attention.launches == 0
    assert paged_decode.paged_decode_attention.launches == 0
    assert grouped_matmul.launches > 3 * flash_attention.launches


@pytest.mark.parametrize("name", ["whisper-base", "internvl2-26b"])
def test_frontend_models_through_the_kernels(dev, name):
    """whisper (encoder, cross-attention at Sq = 1) and internvl2 (patch
    embeddings before the tokens) at smoke width: ``prefill(extra=...)``
    and 3 decode steps through K3/K4 against the plain versions on the
    card, bf16 logits within 0.1 (the limit of the CPU parity tests)."""
    from repro_torch.models import decode_step, prefill

    cfg = ARCHS[name].smoke()
    params = init_model(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    key = "frame_embeds" if cfg.enc_layers else "patch_embeds"
    n = 40 if cfg.enc_layers else cfg.vision_tokens
    extra = {key: torch.randn(1, n, cfg.d_model, generator=gen,
                              device=dev).bfloat16()}
    toks = torch.randint(0, cfg.vocab, (1, 12), generator=gen, device=dev)
    n0 = 9 + (0 if cfg.enc_layers else n)

    def run():
        lg, c = prefill(cfg, params, toks[:, :9], extra=extra,
                        max_seq=n0 + 3)
        out = [lg[:, -1]]
        for i in range(3):
            lg, c = decode_step(cfg, params, toks[:, 9 + i:10 + i], c,
                                n0 + i)
            out.append(lg[:, 0])
        return torch.cat(out).float()

    ops.reset_launch_counts()
    kern = run()
    assert flash_attention.launches > 0 and decode_attention.launches > 0
    with ops.plain_on_card():
        plain = run()
    assert torch.isfinite(kern).all()
    torch.testing.assert_close(kern, plain, atol=0.1, rtol=0)


@pytest.mark.parametrize("paged", [True, False])
def test_granite_moe_engine_runs_the_expert_kernel(dev, paged):
    """granite-moe (smoke) serves through K5 on the card on both decode
    paths: 3 launches per layer of every model call."""
    ops.reset_launch_counts()
    cfg = ARCHS["granite-moe-3b-a800m"].smoke()
    eng = ServingEngine(
        cfg, init_model(cfg, 0, device=dev),
        EngineConfig(n_slots=3, max_seq=64, hbm_capacity_bytes=1e9,
                     paged_decode=paged,
                     policy=MursPolicy(MursConfig.for_serving(period=1.0)),
                     device=str(dev)),
    )
    for i in range(3):
        eng.submit(Request(f"A{i}", "A", list(range(10, 20 + i)), 8))
    eng.run(max_ticks=600)
    assert len(eng.completed) == 3 and not eng.failed
    assert (eng.paged_decode_ticks > 0) == paged
    # one launch per layer: K3 per prefill, K4 per decode_step, K1 per
    # decode_step_paged; K5 three per layer of each of those calls
    attention = (flash_attention.launches + decode_attention.launches
                 + paged_decode.paged_decode_attention.launches)
    assert attention > 0
    assert grouped_matmul.launches == 3 * attention


SSD_RTOL = 1e-3  # of max |plain|: see the module docstring

#: (B, S, nh, hd, ds, chunk): chip_smoke.py's kernel phase — mamba2
#: prefills of 32, 65, 256, 768 and 1024 tokens, zamba2's of 1024, a
#: batch of 3, and the ragged smoke shape; then mamba2's widths at the
#: edges of a query tile and of a chunk (S 1, 63, 64, 255, 256, 257),
#: zamba2's at 768, and head counts of 3 and 81
SSD_SHAPES = [
    (1, 32, 80, 64, 128, 256), (1, 65, 80, 64, 128, 256),
    (1, 256, 80, 64, 128, 256), (1, 768, 80, 64, 128, 256),
    (1, 1024, 80, 64, 128, 256), (1, 1024, 64, 64, 64, 256),
    (3, 300, 80, 64, 128, 256), (1, 45, 3, 16, 8, 32),
    (1, 1, 80, 64, 128, 256), (1, 63, 80, 64, 128, 256),
    (1, 64, 80, 64, 128, 256), (1, 255, 80, 64, 128, 256),
    (1, 257, 80, 64, 128, 256), (1, 768, 64, 64, 64, 256),
    (1, 300, 3, 64, 128, 256), (2, 600, 81, 64, 128, 256),
]


def _ssd_inputs(dev, b, s, nh, hd, ds, seed=0):
    """Model-like f32 inputs: SiLU outputs for x, B and C, dt a softplus,
    A = -linspace(1, 16, nh) as the model's A_log gives."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def silu(*shape):
        return torch.nn.functional.silu(
            torch.randn(*shape, generator=g, device=dev))

    x = silu(b, s, nh, hd)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, nh, generator=g, device=dev))
    A = -torch.linspace(1.0, 16.0, nh, device=dev)
    return x, dt, A, silu(b, s, ds), silu(b, s, ds)


@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(dev, b, s, nh, hd, ds, chunk):
    args = _ssd_inputs(dev, b, s, nh, hd, ds, seed=s + nh)
    out = ssd_scan(*args, chunk)
    plain = ref.ssd_scan_ref(*args, chunk)
    torch.cuda.synchronize()
    assert out.shape == (b, s, nh, hd) and torch.isfinite(out).all()
    atol = SSD_RTOL * plain.abs().max().item()
    torch.testing.assert_close(out, plain, atol=atol, rtol=0)


@pytest.mark.parametrize("s", [65, 600])
def test_ssd_scan_is_deterministic(dev, s):
    """Two launches on the same inputs give the same bits (one chunk and
    three): no float atomics, and every sum in one order."""
    args = _ssd_inputs(dev, 1, s, 80, 64, 128, seed=s)
    first = ssd_scan(*args, 256)
    second = ssd_scan(*args, 256)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_ssd_scan_rows_do_not_see_what_follows(dev):
    """A ragged scan equals the head of a longer one: the kernel masks
    the missing positions of its last chunk itself."""
    args = _ssd_inputs(dev, 1, 600, 4, 64, 128)
    full = ssd_scan(*args, 256)
    head = [a[:, :333].contiguous() if a.dim() > 1 else a for a in args]
    part = ssd_scan(*head, 256)
    atol = SSD_RTOL * full.abs().max().item()
    torch.testing.assert_close(part, full[:, :333], atol=atol, rtol=0)


def test_ssd_wrapper_rejects_what_the_kernel_cannot_take(dev):
    x, dt, A, Bm, C = _ssd_inputs(dev, 1, 40, 2, 16, 8)
    with pytest.raises(TypeError):
        ssd_scan(x.bfloat16(), dt, A, Bm, C, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm,
                 C, 32)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x.cpu(), dt, A, Bm, C, 32)
    with pytest.raises(ValueError, match="match"):
        ssd_scan(x, dt[:, :-1].contiguous(), A, Bm, C, 32)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, A, Bm, C, 512)
    wide = torch.zeros(1, 40, 2, 128, device=dev)
    with pytest.raises(ValueError, match="hd"):
        ssd_scan(wide, dt, A, Bm, C, 32)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssm_engine_runs_the_ssd_kernel(dev, name):
    """mamba2 and zamba2 (smoke) serve on the card: K6 once per Mamba
    layer of every ``prefill``; zamba2's shared attention through K3 and
    K4; the paged kernels never."""
    from repro_torch.serve import engine as engine_module

    cfg = ARCHS[name].smoke()
    calls = {"prefill": 0, "decode_step": 0}
    originals = {k: getattr(engine_module, k) for k in calls}

    def counting(name):
        def fn(*args, **kwargs):
            calls[name] += 1
            return originals[name](*args, **kwargs)
        return fn

    eng = ServingEngine(
        cfg, init_model(cfg, 0, device=dev),
        EngineConfig(n_slots=3, max_seq=96, hbm_capacity_bytes=1e9,
                     paged_decode=True,
                     policy=MursPolicy(MursConfig.for_serving(period=1.0)),
                     device=str(dev)),
    )
    for i in range(3):
        eng.submit(Request(f"A{i}", "A", list(range(10, 50 + 20 * i)), 8))
    ops.reset_launch_counts()
    try:
        for k in calls:
            setattr(engine_module, k, counting(k))
        eng.run(max_ticks=600)
    finally:
        for k, fn in originals.items():
            setattr(engine_module, k, fn)
    assert len(eng.completed) == 3 and not eng.failed
    n_mamba = sum(bt == "mamba" for bt in
                  list(cfg.block_pattern) * cfg.resolved_pattern_repeats
                  + list(cfg.suffix_blocks))
    n_shared = cfg.n_layers - n_mamba
    assert calls["prefill"] > 0
    assert ssd_scan.launches == n_mamba * calls["prefill"]
    assert flash_attention.launches == n_shared * calls["prefill"]
    assert decode_attention.launches == n_shared * calls["decode_step"]
    assert paged_decode.paged_decode_attention.launches == 0
    assert eng.paged_decode_ticks == 0


def test_cluster_migrates_and_restores_from_a_checkpoint(dev, tmp_path):
    """A smoke-width 2-replica cluster on the card: a request migrates
    off its home mid-decode and finishes with the tokens it gets alone on
    one engine (a batch of one on both sides), then a second request's
    replica crashes and the request restores from its newest KV
    checkpoint (``live`` or ``suffix``) and completes."""
    from repro_torch.serve import ClusterConfig, ServingCluster

    cfg = ARCHS["internlm2-1.8b"].smoke()
    params = init_model(cfg, 0, device=dev)

    def make():
        return EngineConfig(
            n_slots=2, max_seq=64,
            hbm_capacity_bytes=cfg.kv_bytes_per_token() * 200,
            policy=MursPolicy(MursConfig.for_serving(period=1.0)),
            device=str(dev))

    ref = ServingEngine(cfg, params, make())
    ref.submit(Request("m", "T", list(range(10, 18)), 16))
    ref.run(max_ticks=200)
    # the straggler pass stays off: against an idle replica, the busy one
    # always reads slow and would pull the request back
    cl = ServingCluster(cfg, params, ClusterConfig(
        engine=make, n_replicas=2, straggler_min_samples=10**9,
        checkpoint_every_ticks=4, checkpoint_dir=str(tmp_path)))
    cl.submit(Request("m", "T", list(range(10, 18)), 16))
    for _ in range(6):
        cl.step()
    src = cl._home["m"]
    assert cl.migrate("m", src)
    while cl.has_pending:
        cl.step()
    assert cl._home["m"] != src
    assert cl.replicas[cl._home["m"]].requests["m"].generated == \
        ref.requests["m"].generated
    cl.submit(Request("c", "T", list(range(20, 40)), 24))
    saved = cl.ckpt_saved
    while cl.ckpt_saved == saved or cl.tick % 4 != 3:
        cl.step()  # a checkpoint holds c, and c decoded past it
    cl.crash_replica(cl._home["c"])
    out = cl.run(max_ticks=300).extras
    assert sorted(cl.completed) == ["c", "m"] and out["failed"] == 0
    assert out["migrations"]["completed"] == 1
    assert out["checkpoint"]["restored_requests"] == 1
    assert set(out["checkpoint"]["outcomes"]) <= {"live", "suffix"}
    c = cl.replicas[cl._home["c"]].requests["c"]
    assert len(c.generated) == 24 and all(0 <= t < cfg.vocab
                                          for t in c.generated)


# ------------------------------------------------------------- training
# (B, H, KV, Sq, Sk, hd, vd, causal, window, q_offset): K3's backward at
# the training paths' masks and widths, cut short — internlm2 (16 over
# 8, hd 128, causal), gemma3's local layer (4 over 1, hd 256, window
# 512), whisper's encoder (non-causal, hd 64) and cross-attention (Sq 64
# over 300 keys), MLA (q/k 192, V 128 padded) — GQA groups of 1 to 16,
# ragged lengths and widths (the hd 16, 32 and 24 templates), an
# offset, and the smoke shape, whose last two rows keep no key; and the
# edges of the wgmma route's 64-row TMA tiles (hd 64 and 128): S of
# 1,000 and 200 (a ragged last tile), q heads per kv head of 1, 2 and 8,
# q_offset > 0 and a window at each of its widths
BWD_SHAPES = [
    (1, 16, 8, 256, 256, 128, 128, True, 0, 0),
    (1, 8, 1, 1000, 1000, 128, 128, True, 0, 0),
    (2, 4, 4, 200, 200, 64, 64, True, 0, 0),
    (1, 4, 2, 200, 200, 64, 64, True, 64, 0),
    (1, 4, 2, 300, 300, 128, 128, True, 100, 0),
    (1, 8, 1, 130, 260, 64, 64, True, 0, 130),
    (1, 2, 1, 1000, 1000, 64, 64, False, 0, 0),
    (1, 4, 1, 640, 640, 256, 256, True, 512, 0),
    (1, 8, 8, 300, 300, 64, 64, False, 0, 0),
    (1, 8, 8, 64, 300, 64, 64, False, 0, 0),
    (1, 16, 16, 160, 160, 192, 128, True, 0, 0),
    (2, 16, 1, 100, 100, 64, 64, True, 0, 0),
    (2, 6, 3, 65, 100, 24, 24, False, 0, 0),
    (1, 4, 2, 37, 37, 16, 16, True, 4, 5),
    (1, 4, 2, 50, 157, 128, 128, True, 0, 107),
    (1, 2, 1, 33, 97, 256, 256, True, 16, 64),
    (2, 4, 4, 130, 130, 32, 32, True, 0, 0),
]
#: f32 gradients: the kernel and autodiff of the plain version differ in
#: the order of their f32 sums over up to 1,500 keys or 16 heads × Sq
#: rows, whose terms cancel: 1e-4 of the largest |gradient|
BWD_F32_RTOL = 1e-4
#: bf16: the kernel rounds P and dS to bf16 as tensor-core operands
#: (FlashAttention-2's choice) and D from the rounded output; emulated on
#: the CPU at these masks this moves a gradient by at most one bf16 ulp
#: of the largest |gradient|; the limit is two
BWD_BF16_ULPS = 2


def _bwd_atol(plain):
    big = plain.float().abs().max().item()
    if plain.dtype == torch.float32:
        return BWD_F32_RTOL * max(big, 1.0)
    return BWD_BF16_ULPS * 2.0 ** (math.floor(math.log2(big)) - 7)


def _grads(fn, dout, *inputs):
    """(output, gradient of each input) of ``fn`` under ``dout``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out.backward(dout)
    return (out,) + tuple(t.grad for t in leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,vd,causal,window,q_offset",
                         BWD_SHAPES)
def test_flash_backward_matches_plain(dev, dtype, b, h, kv, sq, sk, hd, vd,
                                      causal, window, q_offset):
    """``ops.flash_attention`` with inputs that need a gradient: K3 once
    (saving the LSE) and its backward once; dq, dk and dv against
    autodiff of the plain version on the card."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(7 * sq + hd + vd)
    q = _rand(gen, dev, dt, b, h, sq, hd)
    k = _rand(gen, dev, dt, b, kv, sk, hd)
    v = _rand(gen, dev, dt, b, sk, kv, vd).transpose(1, 2)
    dout = _rand(gen, dev, dt, b, h, sq, vd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def attend(*t):
        return ops.flash_attention(*t, **kw)

    ops.reset_launch_counts()
    got = _grads(attend, dout, q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert flash_attention_bwd.launches == 1
    with ops.plain_on_card():
        want = _grads(attend, dout, q, k, v)
    assert flash_attention.launches == 1
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        atol = _atol(w) if name == "out" else _bwd_atol(w)
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("hd,h,kv,causal,window", [
    (128, 16, 8, True, 0), (128, 8, 1, True, 256), (64, 8, 8, False, 0),
    (64, 8, 2, True, 100), (256, 4, 1, True, 512),
])
def test_flash_backward_is_deterministic(dev, hd, h, kv, causal, window):
    """Two launches of K3's backward give the same bits on each route
    (wgmma at hd 64 and 128, mma.sync at 256): causal, windowed, GQA; no
    atomics, every sum in one order."""
    gen = torch.Generator(device=dev).manual_seed(hd + h + window)
    s = 1000
    q = _rand(gen, dev, torch.bfloat16, 2, h, s, hd)
    k = _rand(gen, dev, torch.bfloat16, 2, kv, s, hd)
    v = _rand(gen, dev, torch.bfloat16, 2, kv, s, hd)
    dout = _rand(gen, dev, torch.bfloat16, 2, h, s, hd)
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    first = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    second = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.isfinite(a.float()).all() and torch.equal(a, b_)


def test_flash_backward_of_a_row_without_a_key(dev):
    """Rows that keep no key took the mean of V over the Sk keys, a
    constant score: their dq is exactly 0, and dv gets dO / Sk from each
    (what autodiff of the plain version gives)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, kv, s, hd = 1, 4, 2, 37, 16
    q = _rand(gen, dev, torch.float32, b, h, s, hd)
    k = _rand(gen, dev, torch.float32, b, kv, s, hd)
    v = _rand(gen, dev, torch.float32, b, kv, s, hd)
    dout = torch.zeros(b, h, s, hd, device=dev)
    dout[:, :, 35:] = _rand(gen, dev, torch.float32, b, h, 2, hd)
    kw = dict(causal=True, window=4, q_offset=5)  # rows 35, 36 keep none
    _, dq, dk, dv = _grads(lambda *t: ops.flash_attention(*t, **kw), dout,
                           q, k, v)
    assert torch.equal(dq, torch.zeros_like(dq))
    assert torch.equal(dk, torch.zeros_like(dk))
    want = dout[:, :, 35:].reshape(b, kv, 2 * h // kv, hd).sum(2) / s
    torch.testing.assert_close(dv, want[:, :, None].expand_as(dv),
                               atol=1e-6, rtol=0)


def test_flash_without_a_gradient_launches_as_the_serving_path(dev):
    """No input needs a gradient, or grad mode is off: K3 once, no LSE
    saved, no backward — the serving path's launch."""
    q = torch.randn(1, 4, 64, 64, device=dev).bfloat16()
    ops.reset_launch_counts()
    ops.flash_attention(q, q[:, :2], q[:, :2])
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), q[:, :2], q[:, :2])
    assert flash_attention.launches == 2
    assert flash_attention_bwd.launches == 0


TRAIN_CAPACITY = 512  # granite-moe's _capacity(cfg, 2048)
GMM_BWD_SHAPES = [  # (E, C, D, F): granite's training gate/up and down
    # at two sequences a microbatch, ragged smoke shapes, a C that ends
    # inside a 128-row tile (dx) and a 64-deep step (dw) in both
    # orientations, and deepseek-v2's gate/up widths at a small C
    (40, 2 * TRAIN_CAPACITY, 1536, 512), (40, 2 * TRAIN_CAPACITY, 512, 1536),
    (3, 5, 72, 40), (2, 3, 16, 24), (40, 1000, 1536, 512),
    (40, 200, 512, 1536), (160, 64, 5120, 1536),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GMM_BWD_SHAPES)
def test_grouped_matmul_backward_matches_plain(dev, dtype, e, c, d, f):
    """``ops.grouped_matmul`` with inputs that need a gradient: K5 once
    forward and its backward once (dX = dY W^T and dW = X^T dY in one
    launch, no transposed copy); every gradient within one ulp of
    autodiff of the plain version (both sum in f32 and round once)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(e * c + d + f + 1)
    x = torch.randn(e, c, d, generator=g, device=dev).to(dt)
    w = (torch.randn(e, d, f, generator=g, device=dev) / math.sqrt(d)).to(dt)
    dy = torch.randn(e, c, f, generator=g, device=dev).to(dt)
    ops.reset_launch_counts()
    got = _grads(ops.grouped_matmul, dy, x, w)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == 1
    assert grouped_matmul_bwd.launches == 1
    with ops.plain_on_card():
        want = _grads(ops.grouped_matmul, dy, x, w)
    for g_, w_ in zip(got, want):
        assert g_.dtype == dt and g_.shape == w_.shape
        torch.testing.assert_close(g_.float(), w_.float(), atol=_atol(w_),
                                   rtol=0)
    del x, w, dy, got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", [(5, 6, 64, 24), (40, 300, 1536, 512)])
def test_grouped_matmul_backward_reads_x_through_strides(dev, dtype, e, c, d,
                                                         f):
    """K5's backward on x an [E, C, D] view of [C, E, D] (rows contiguous,
    strided experts and rows: the dispatch's layout), read in place."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(e + c + d + f)
    x = _rand(gen, dev, dt, c, e, d).transpose(0, 1)
    w = (torch.randn(e, d, f, generator=gen, device=dev)
         / math.sqrt(d)).to(dt)
    dy = _rand(gen, dev, dt, e, c, f)
    got = grouped_matmul_bwd(x, w, dy)
    want = ref.grouped_matmul_bwd_ref(x, w, dy)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert g_.is_contiguous()
        torch.testing.assert_close(g_.float(), w_.float(), atol=_atol(w_),
                                   rtol=0)


def test_grouped_matmul_bwd_wrapper_rejects_what_the_kernel_cannot_take(dev):
    x = torch.randn(2, 3, 8, device=dev)
    w = torch.randn(2, 8, 4, device=dev)
    dy = torch.randn(2, 3, 4, device=dev)
    with pytest.raises(TypeError):
        grouped_matmul_bwd(x, w, dy.bfloat16())
    with pytest.raises(ValueError, match="chain"):
        grouped_matmul_bwd(x, torch.randn(2, 6, 4, device=dev), dy)
    with pytest.raises(ValueError, match="dy"):
        grouped_matmul_bwd(x, w, torch.randn(2, 3, 5, device=dev))
    with pytest.raises(ValueError, match="w must be contiguous"):
        grouped_matmul_bwd(x, w.transpose(1, 2).contiguous().transpose(1, 2),
                           dy)
    with pytest.raises(ValueError, match="dy must be contiguous"):
        grouped_matmul_bwd(x, w, dy.transpose(1, 2).contiguous()
                           .transpose(1, 2))
    with pytest.raises(ValueError, match="rows must be contiguous"):
        grouped_matmul_bwd(x.transpose(1, 2).contiguous().transpose(1, 2), w,
                           dy)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul_bwd(x, w, dy.cpu())


def test_kernels_without_a_backward_raise_when_a_gradient_is_needed(dev):
    """The decode kernels (K4 here) on a CUDA tensor that needs a
    gradient raise; K6, which has its backward kernel now, runs under
    autograd (``test_ssd_backward_matches_plain``)."""
    q = torch.randn(2, 4, 16, device=dev, requires_grad=True)
    kc = torch.randn(2, 2, 8, 16, device=dev)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="decode only"):
        ops.decode_attention(q, kc, kc, pos)
    with torch.no_grad():
        assert ops.decode_attention(q, kc, kc, pos).shape == q.shape


#: (B, S, nh, hd, ds, chunk): K6's backward at one chunk (S 1, 64, 200),
#: a ragged last chunk (600, 1000), whole chunks (512) at mamba2's widths
#: (80 heads of 64, ds 128, Q 256), zamba2's (64 heads, ds 64) at 700,
#: and narrow ones: hd 24 and ds 40 (both tiles zero-padded), a chunk
#: of 100 (a ragged second tile in every chunk), ds 100; and head counts
#: that do not fill the kernel's groups of 16 heads: 21 at ds 128
#: (ragged), 5 at ds 64 (ragged, B 2), 3 below one chunk, 33 (three
#: groups, the last of one head) at a chunk of 64
SSD_BWD_SHAPES = [
    (1, 1, 80, 64, 128, 256), (1, 64, 80, 64, 128, 256),
    (2, 200, 80, 64, 128, 256), (1, 600, 80, 64, 128, 256),
    (1, 512, 80, 64, 128, 256), (1, 1000, 80, 64, 128, 256),
    (2, 700, 64, 64, 64, 256), (1, 45, 3, 16, 8, 32),
    (2, 230, 5, 24, 40, 100), (1, 300, 3, 64, 100, 128),
    (1, 600, 21, 64, 128, 256), (2, 300, 5, 64, 64, 256),
    (1, 100, 3, 64, 128, 256), (1, 150, 33, 32, 64, 64),
]
#: K6's backward against autodiff of the plain scan, of max |plain|: the
#: f32 terms summed in other orders; dx, dB and dC within 1e-4 (the CPU
#: spread of the plain backward against autograd is at most 3e-7), ddt
#: and dA within 1e-3: their terms, the reverse running sums of dseg,
#: cancel (CPU: 1.6e-5 for dA, and f32 against f64 1.8e-4 at a chunk of
#: 256)
SSD_BWD_RTOL = {"dx": 1e-4, "ddt": 1e-3, "dA": 1e-3, "dB": 1e-4,
                "dC": 1e-4}


def _ssd_dy(dev, b, s, nh, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(b, s, nh, hd, generator=g, device=dev)


@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SSD_BWD_SHAPES)
def test_ssd_backward_matches_plain(dev, b, s, nh, hd, ds, chunk):
    """``ops.ssd_scan`` with inputs that need a gradient: K6 once and its
    backward once; y and the five gradients against autodiff of the plain
    scan inside ``plain_on_card``."""
    args = _ssd_inputs(dev, b, s, nh, hd, ds, seed=s + nh + 1)
    dy = _ssd_dy(dev, b, s, nh, hd, seed=s)
    ops.reset_launch_counts()
    got = _grads(lambda *t: ops.ssd_scan(*t, chunk), dy, *args)
    torch.cuda.synchronize()
    assert ssd_scan.launches == 1 and ssd_scan_bwd.launches == 1
    with ops.plain_on_card():
        want = _grads(lambda *t: ops.ssd_scan(*t, chunk), dy, *args)
    assert ssd_scan.launches == 1 and ssd_scan_bwd.launches == 1
    atol = SSD_RTOL * want[0].abs().max().item()
    torch.testing.assert_close(got[0], want[0], atol=atol, rtol=0)
    for name, g, w in zip(SSD_BWD_RTOL, got[1:], want[1:]):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        atol = SSD_BWD_RTOL[name] * w.abs().max().item()
        torch.testing.assert_close(g, w, atol=atol, rtol=0,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("s", [65, 600])
def test_ssd_backward_is_deterministic(dev, s):
    """Two launches of K6's backward give the same bits (one chunk and
    three): no float atomics, every sum in one order."""
    args = _ssd_inputs(dev, 2, s, 80, 64, 128, seed=s)
    dy = _ssd_dy(dev, 2, s, 80, 64, seed=s + 1)
    first = ssd_scan_bwd(*args, dy, 256)
    second = ssd_scan_bwd(*args, dy, 256)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def test_ssd_backward_wrapper_rejects_what_the_kernel_cannot_take(dev):
    x, dt, A, Bm, C = _ssd_inputs(dev, 1, 40, 2, 16, 8)
    dy = torch.zeros_like(x)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(x, dt, A, Bm, C, dy[:, :-1].contiguous(), 32)
    with pytest.raises(TypeError):
        ssd_scan_bwd(x, dt, A, Bm, C, dy.double(), 32)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan_bwd(x, dt, A, Bm, C, dy, 512)


def test_ssd_without_a_gradient_launches_as_the_serving_path(dev):
    """No input needs a gradient, or grad mode is off: K6 once and no
    backward, as serving launches it."""
    x, dt, A, Bm, C = _ssd_inputs(dev, 1, 300, 4, 64, 128)
    ops.reset_launch_counts()
    ops.ssd_scan(x, dt, A, Bm, C, 256)
    with torch.no_grad():
        ops.ssd_scan(x.requires_grad_(), dt, A, Bm, C, 256)
    assert ssd_scan.launches == 2 and ssd_scan_bwd.launches == 0


def _train_batch(cfg, dev, b=2, s=64):
    g = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev,
                           dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-moe-3b-a800m"])
def test_train_step_through_the_kernels_matches_plain(dev, name):
    """A smoke model's loss and gradient (f32, remat on) through the
    kernels: K3 forward twice per layer (the recompute), its backward
    once, K5 six times per MoE layer (three forward, three recomputed)
    and its backward three times; inside ``plain_on_card`` (its
    recompute on autograd's device thread too) no launch.  Every leaf
    non-zero and within 1e-2 of the plain gradient (chip_smoke.py's
    TRAIN_REF_F32_RTOL: the bf16 cotangent rounding compounds last-bit
    differences)."""
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves

    cfg = ARCHS[name].smoke()
    params = init_model(cfg, 0, dtype=torch.float32, device=dev)
    batch = _train_batch(cfg, dev)
    ops.reset_launch_counts()
    loss, grads = value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    n_moe = cfg.n_layers if cfg.moe is not None else 0
    assert flash_attention.launches == 2 * cfg.n_layers
    assert flash_attention_bwd.launches == cfg.n_layers
    assert grouped_matmul.launches == 6 * n_moe
    assert grouped_matmul_bwd.launches == 3 * n_moe
    with ops.plain_on_card():
        p_loss, p_grads = value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    assert flash_attention.launches == 2 * cfg.n_layers
    assert flash_attention_bwd.launches == cfg.n_layers
    assert abs(loss.item() - p_loss.item()) <= 1e-5
    for g, w in zip(tree_leaves(grads), tree_leaves(p_grads)):
        assert g.norm() > 0 and w.norm() > 0
        assert ((g - w).norm() / w.norm()).item() <= 1e-2


#: a Mamba-2 smoke train step's leaves against the plain path's, per leaf
#: of its norm: with ``bf16_grad`` the identity (the kernels differ from
#: the plain versions only in the order of f32 sums) within 1e-3, since
#: A_log's and dt_bias's gradients sum dA and ddt, whose terms cancel
#: (chip_smoke.py's TRAIN_REF_EXACT_RTOL_SSM; its full-width zamba2 unit
#: read 2.5e-4); with the bf16 cotangent rounding, where last-bit
#: differences flip roundings that compound with depth, within 2e-2
#: (chip_smoke.py's TRAIN_REF_F32_RTOL for zamba2; zamba2 smoke's 14
#: layers read 1.07e-2 on the card, mamba2's 2 layers under 1e-2)
SSM_TRAIN_RTOL = {"exact": 1e-3, "rounded": 2e-2}


@pytest.mark.parametrize("boundary", sorted(SSM_TRAIN_RTOL))
@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssm_train_step_through_the_kernels_matches_plain(dev, name,
                                                          boundary,
                                                          monkeypatch):
    """A Mamba-2 smoke model's loss and gradient (f32, remat on) through
    the kernels: K6 forward twice per Mamba layer of the repeated unit
    (the recompute) and once per suffix layer, its backward once per
    Mamba layer, and zamba2's shared attention through K3 and its
    backward; inside ``plain_on_card`` no launch.  Every leaf non-zero
    and within SSM_TRAIN_RTOL[boundary] of the plain gradient."""
    import repro_torch.models.layers as layers
    import repro_torch.models.transformer as transformer
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves

    if boundary == "exact":
        monkeypatch.setattr(transformer, "bf16_grad", lambda x: x)
        monkeypatch.setattr(layers, "bf16_grad", lambda x: x)
    cfg = ARCHS[name].smoke()
    unit = list(cfg.block_pattern)
    reps = cfg.resolved_pattern_repeats
    n_unit = unit.count("mamba") * reps
    n_suffix = list(cfg.suffix_blocks).count("mamba")
    n_attn = (len(unit) - unit.count("mamba")) * reps
    params = init_model(cfg, 0, dtype=torch.float32, device=dev)
    batch = _train_batch(cfg, dev, s=300)
    ops.reset_launch_counts()
    loss, grads = value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    counts = (ssd_scan.launches, ssd_scan_bwd.launches,
              flash_attention.launches, flash_attention_bwd.launches)
    assert counts == (2 * n_unit + n_suffix, n_unit + n_suffix,
                      2 * n_attn, n_attn)
    with ops.plain_on_card():
        p_loss, p_grads = value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    assert counts == (ssd_scan.launches, ssd_scan_bwd.launches,
                      flash_attention.launches, flash_attention_bwd.launches)
    assert abs(loss.item() - p_loss.item()) <= 1e-5
    for g, w in zip(tree_leaves(grads), tree_leaves(p_grads)):
        assert g.norm() > 0 and w.norm() > 0
        err = ((g - w).norm() / w.norm()).item()
        assert err <= SSM_TRAIN_RTOL[boundary]
