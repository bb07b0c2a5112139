"""The port on the card: CUDA kernels against their plain versions, and
the engine's paged path through them.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips with a
reason elsewhere.  The file imports no JAX, so it runs on a machine that
has only PyTorch:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import paged_decode, ref  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.transformer import _quantize_pool_int8  # noqa: E402
from repro_torch.sched import MursConfig, MursPolicy  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda

F32_ATOL = 1e-5  # f32 against f32: summation order only
BF16_ATOL = 2e-2  # one bf16 rounding of outputs of order 1


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
    atol = F32_ATOL if dt == torch.float32 else BF16_ATOL
    args = _case(dev, dt, seed=hd + bh, bh=bh, width=width, page=page, hd=hd)
    out = paged_decode.paged_decode_attention(*args)
    plain = ref.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert out.dtype == dt and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,width,page,hd", SHAPES)
def test_int8_kernel_matches_plain(dev, dtype, bh, width, page, hd):
    dt = getattr(torch, dtype)
    atol = F32_ATOL if dt == torch.float32 else BF16_ATOL
    q, k, v, table, lens = _case(dev, dt, seed=hd + bh + 1, bh=bh,
                                 width=width, page=page, hd=hd)
    kc, ks = _quantize_pool_int8(k)
    vc, vs = _quantize_pool_int8(v)
    args = (q, kc, vc, ks, vs, table, lens)
    out = paged_decode.paged_decode_attention_int8(*args)
    plain = ref.paged_decode_attention_int8_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain.float(), atol=atol, rtol=0)


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
    paged_decode.reset_launch_counts()
    cfg, eng = _engine(dev, paged_decode_int8=int8)
    assert len(eng.completed) == 5 and not eng.failed
    assert eng.paged_decode_ticks > 0
    fn = (paged_decode.paged_decode_attention_int8 if int8
          else paged_decode.paged_decode_attention)
    assert fn.launches == cfg.n_layers * eng.paged_decode_ticks
