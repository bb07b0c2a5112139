"""K5's backward on the CPU: the plain twin against the JAX package, and
the autograd route the card takes, rehearsed.

* ``ref.grouped_matmul_bwd_ref`` against ``jax.vjp`` of the JAX model's
  expert einsums (``repro.models.blocks``: ``"becd,edf->becf"`` for gate
  and up, ``"becf,efd->becd"`` for down), the batch folded into the
  capacity axis as the port's MoE block folds it: f32 within
  ``F32_ATOL`` = 1e-5 (summation order only), bf16 within one bf16 ulp of
  the largest |gradient| (both sum in f32 and round once).
* ``ops.grouped_matmul`` on inputs that need a gradient, with ``ops``
  routing CPU tensors to the kernel wrappers and both wrappers swapped
  for counted plain versions: one forward launch, one backward launch,
  and gradients bit-equal to autograd of ``ref.grouped_matmul_ref``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import grouped_matmul as tgmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: the wrappers themselves, whose counters the swapped versions bump
GMM, GMM_BWD = tgmm.grouped_matmul, tgmm.grouped_matmul_bwd
F32_ATOL = 1e-5  # f32 against f32: summation order only

# (B, E, C, D, F): ragged everywhere, granite smoke's gate/up, a prefill's
# capacity with a wider D
SHAPES = [(2, 3, 5, 72, 40), (1, 8, 4, 64, 64), (2, 4, 16, 96, 24)]


def _bf16_ulp(y):
    return 2.0 ** (math.floor(math.log2(float(np.abs(y).max()))) - 7)


def _jnp(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eq", ["becd,edf->becf", "becf,efd->becd"])
@pytest.mark.parametrize("b,e,c,d,f", SHAPES)
def test_grouped_matmul_bwd_ref_matches_jax_vjp(dtype, eq, b, e, c, d, f):
    """dx and dw of the JAX package's expert einsum (down's: the same
    form with D and F's roles swapped) against the plain twin on the
    port's [E, B C, ...] layout."""
    if eq == "becf,efd->becd":
        d, f = f, d
    rng = np.random.default_rng(b * 1000 + e * c + d + f)
    x = rng.standard_normal((b, e, c, d), dtype=np.float32)
    w = (rng.standard_normal((e, d, f), dtype=np.float32) / math.sqrt(d))
    dy = rng.standard_normal((b, e, c, f), dtype=np.float32)
    jx, jw, jdy = (_jnp(a, dtype) for a in (x, w, dy))
    _, vjp = jax.vjp(lambda xx, ww: jnp.einsum(eq, xx, ww), jx, jw)
    jdx, jdw = (np.asarray(g.astype(jnp.float32)) for g in vjp(jdy))

    def fold(a):  # [B, E, C, k] -> [E, B C, k], as the port's block
        return a.transpose(1, 0, 2, 3).reshape(e, b * c, a.shape[-1])

    tdx, tdw = ref.grouped_matmul_bwd_ref(
        _torch(fold(np.asarray(jx.astype(jnp.float32))), dtype),
        _torch(np.asarray(jw.astype(jnp.float32)), dtype),
        _torch(fold(np.asarray(jdy.astype(jnp.float32))), dtype))
    assert tdx.dtype == getattr(torch, dtype)
    got_dx = tdx.float().numpy().reshape(e, b, c, d).transpose(1, 0, 2, 3)
    for got, want in ((got_dx, jdx), (tdw.float().numpy(), jdw)):
        atol = F32_ATOL if dtype == "float32" else _bf16_ulp(want)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _counted(wrapper, plain):
    def launch(*args):
        wrapper.launches += 1
        return plain(*args)
    return launch


@pytest.fixture
def kernel_route(monkeypatch):
    """``ops`` sends CPU tensors down the card's route, whose two K5
    wrappers are counted plain versions."""
    monkeypatch.setattr(ops, "_on_cpu", lambda q: ops._PLAIN.get())
    monkeypatch.setattr(tgmm, "grouped_matmul",
                        _counted(GMM, ref.grouped_matmul_ref))
    monkeypatch.setattr(tgmm, "grouped_matmul_bwd",
                        _counted(GMM_BWD, ref.grouped_matmul_bwd_ref))
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_grouped_matmul_autograd_route_calls_each_wrapper_once(
        kernel_route, dtype, strided):
    """One call that needs a gradient: K5 once forward, its backward once
    (no K5 launch on transposed copies); x as the dispatch's strided view
    too.  The gradients equal autograd of the plain version bit for
    bit."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(5)
    e, c, d, f = 3, 7, 24, 16
    if strided:
        x = torch.randn(c, e, d, generator=g).to(dt).transpose(0, 1)
    else:
        x = torch.randn(e, c, d, generator=g).to(dt)
    w = (torch.randn(e, d, f, generator=g) / math.sqrt(d)).to(dt)
    dy = torch.randn(e, c, f, generator=g).to(dt)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(ops.grouped_matmul(xl, wl), (xl, wl), dy)
    assert GMM.launches == 1 and GMM_BWD.launches == 1
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(ref.grouped_matmul_ref(xp, wp), (xp, wp), dy)
    for a, b_ in zip(got, want):
        assert a.dtype == dt and torch.equal(a, b_)
    assert GMM_BWD in ops.WRAPPERS


def test_grouped_matmul_bwd_wrapper_takes_cuda_tensors_only():
    x, w, dy = torch.zeros(2, 3, 8), torch.zeros(2, 8, 4), torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        GMM_BWD(x, w, dy)
    assert GMM_BWD.launches == 0
