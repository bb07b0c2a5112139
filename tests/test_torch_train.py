"""The port's training stack against the JAX package on the CPU, at smoke
size: the loss and every gradient leaf (internlm2, granite-moe, gemma3,
mamba2, zamba2),
one AdamW update and the schedule, a microbatched train step, the
chunked-vocab loss, int8 error-feedback compression, the data pipeline's
batches and the copied pressure controller.  Inputs are made with numpy
from a seed and handed to both; parameters come from the JAX package's
``init_model`` through ``params_from_numpy``.  The JAX side runs jitted
(its Pallas kernels are not on this path: ``forward`` runs the jnp
attention), and each jitted gradient is shared by the tests that read it
through module-scoped fixtures.

f32 gradients.  The JAX package cannot differentiate an f32 model: its
``bf16_grad`` rule returns the cotangent AS bf16, and the f32 backward
that follows refuses the mixed dtypes (ROADMAP Queue 3;
``test_jax_cannot_differentiate_an_f32_model`` holds that).  The port's
``bf16_grad`` rounds the cotangent to bf16 and keeps the primal's dtype.
So the f32 reference here is the JAX package with its module attribute
``repro.models.transformer.bf16_grad`` swapped, inside the fixture, for
that rule (no file of the JAX package changes); in bf16 the two rules are
the same and the package runs as it is.

Tolerances, each stated beside its comparison:
- f32: every sum is f32 on both sides in different orders, and the
  cotangent rounds to bf16 at every block boundary, where a last-bit
  difference flips a rounding by one bf16 step (2^-8 relative); the
  flips compound with depth.  ``F32_GRAD_RTOL`` = 1e-2 of each leaf's
  norm ‖g − g_jax‖ / ‖g_jax‖ (measured on this CPU: 1.3e-6 internlm2 and
  6.7e-7 granite-moe at 2 layers, 2.6e-3 gemma3 at 14, 1.6e-3 mamba2 at
  2 and 7.6e-3 zamba2 at 14, at its Mamba blocks' ``dt_bias``); the loss
  within 1e-5.  With the rounding taken out of both packages, gemma3's 14
  layers agree within ``F32_EXACT_GRAD_RTOL`` = 1e-4 (measured 2.6e-6):
  the port's arithmetic is the JAX package's.
- bf16: weights, activations and gradients are bf16 on both sides,
  rounded from f32 sums taken in different orders (XLA's fusions round
  in other places than torch's eager ops).  ``BF16_GRAD_RTOL`` = 0.05 of
  each leaf's norm (measured at most 0.040, gemma3); the loss within
  0.02.  zamba2's 14 layers (12 Mamba-2 blocks and the shared attention
  twice) compound it further: 0.077, at its Mamba blocks' ``dt_bias``,
  ``D`` and ``A_log``, where each package's own bf16 gradient differs
  from its f32 one by 0.10 (JAX) and 0.11 (port); its limit
  (``BF16_GRAD_RTOL_BY_ARCH``) is 0.15.  With the rounding taken out
  (f32, ``bf16_grad`` the identity) zamba2 agrees within 2.6e-5 and
  mamba2 within 1.3e-5.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
import repro.models.transformer as jtransformer  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import pressure as jpressure  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.dist import compression as tcomp  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import pressure as tpressure  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

F32_GRAD_RTOL = 1e-2
F32_EXACT_GRAD_RTOL = 1e-4
F32_LOSS_ATOL = 1e-5
BF16_GRAD_RTOL = 0.05
BF16_GRAD_RTOL_BY_ARCH = {"zamba2-1.2b": 0.15}
BF16_LOSS_ATOL = 0.02
B, S = 2, 24  # smoke batch; gemma3 smoke's window is shorter than S

ARCH_NAMES = ["internlm2-1.8b", "granite-moe-3b-a800m", "gemma3-1b",
              "mamba2-2.7b", "zamba2-1.2b"]


@jax.custom_vjp
def _bf16_round_grad(x):
    return x


def _round_fwd(x):
    return x, None


def _round_bwd(_, g):
    return (g.astype(jnp.bfloat16).astype(g.dtype),)


_bf16_round_grad.defvjp(_round_fwd, _round_bwd)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, -3:] = -1  # padding positions too
    return {"tokens": tokens, "labels": labels}


def _t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_value_and_grad(cfg, params, batch, f32):
    """The JAX package's loss and gradient, jitted; in f32 through the
    rounding bf16_grad rule (module docstring)."""
    mp = pytest.MonkeyPatch()
    if f32:
        # the residual boundaries, and the Mamba-2 block's five, which it
        # imports from ``layers`` at call time
        mp.setattr(jtransformer, "bf16_grad", _bf16_round_grad)
        mp.setattr(jlayers, "bf16_grad", _bf16_round_grad)
    try:
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: jstep.lm_loss(cfg, p, b)))
        loss, grads = fn(params, batch)
        return float(loss), _np(grads)
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=[
    (name, dt) for name in ARCH_NAMES for dt in ("float32", "bfloat16")
], ids=lambda p: f"{p[0]}-{p[1]}")
def grads_case(request):
    """(arch, dtype, port cfg, JAX params as numpy, batch, JAX loss, JAX
    grads as numpy)."""
    name, dtype = request.param
    cfg, tcfg = ARCHS[name].smoke(), TARCHS[name].smoke()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = jm.init_model(cfg, jax.random.PRNGKey(1), dtype=jdt)
    batch = _batch(cfg)
    loss, grads = _jax_value_and_grad(cfg, params, batch,
                                      dtype == "float32")
    return name, dtype, tcfg, _np(params), batch, loss, grads


def _rel_errs(t_tree, j_tree):
    """‖g − g_jax‖ / ‖g_jax‖ per leaf, in jax.tree_util order."""
    got = [t.detach().float().numpy() for t in tree_leaves(t_tree)]
    want = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(
        j_tree)]
    assert len(got) == len(want)
    errs = []
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        errs.append(float(np.linalg.norm(g - w) / max(np.linalg.norm(w),
                                                      1e-30)))
    return errs


def test_loss_and_every_gradient_leaf_match_jax(grads_case):
    name, dtype, tcfg, params, batch, j_loss, j_grads = grads_case
    tparams = params_from_numpy(params, "cpu")
    loss, grads = tstep.value_and_grad(tcfg, tparams, _t_batch(batch))
    f32 = dtype == "float32"
    # tolerances: module docstring (F32_* / BF16_*)
    assert abs(float(loss) - j_loss) <= (F32_LOSS_ATOL if f32
                                         else BF16_LOSS_ATOL)
    errs = _rel_errs(grads, j_grads)
    print(f"{name} {dtype}: loss {float(loss)} vs {j_loss}, worst leaf "
          f"{max(errs):.3g}")
    assert max(errs) <= (F32_GRAD_RTOL if f32 else BF16_GRAD_RTOL_BY_ARCH.get(
        name, BF16_GRAD_RTOL)), errs
    for g, p in zip(tree_leaves(grads), tree_leaves(tparams)):
        assert g.dtype == p.dtype  # the MoE router is f32 in a bf16 model


@jax.custom_vjp
def _identity_grad(x):
    return x


_identity_grad.defvjp(lambda x: (x, None), lambda _, g: (g,))


def test_f32_gradients_agree_without_the_boundary_rounding(monkeypatch):
    """gemma3 smoke (14 layers, local and global attention, tied
    embeddings) in f32 with ``bf16_grad`` the identity in both packages:
    every leaf within F32_EXACT_GRAD_RTOL."""
    import repro_torch.models.transformer as ttransformer

    name = "gemma3-1b"
    cfg, tcfg = ARCHS[name].smoke(), TARCHS[name].smoke()
    params = jm.init_model(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    batch = _batch(cfg)
    monkeypatch.setattr(jtransformer, "bf16_grad", _identity_grad)
    monkeypatch.setattr(ttransformer, "bf16_grad", lambda x: x)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.lm_loss(cfg, p, b)))(params, batch)
    loss, grads = tstep.value_and_grad(
        tcfg, params_from_numpy(_np(params), "cpu"), _t_batch(batch))
    assert abs(float(loss) - float(j_loss)) <= F32_LOSS_ATOL
    errs = _rel_errs(grads, _np(j_grads))
    assert max(errs) <= F32_EXACT_GRAD_RTOL, errs


def test_jax_cannot_differentiate_an_f32_model():
    """The reference fault the module docstring names: its bf16_grad
    hands an f32 backward a bf16 cotangent (ROADMAP Queue 3)."""
    cfg = ARCHS["internlm2-1.8b"].smoke()
    params = jm.init_model(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    with pytest.raises((TypeError, AssertionError)):
        jax.value_and_grad(lambda p: jstep.lm_loss(cfg, p, _batch(cfg)))(
            params)


def test_remat_modes_and_no_remat_give_one_gradient():
    """remat True (a checkpoint per unit), "dots" (projections saved) and
    off differ only in what the backward recomputes: equal gradients."""
    cfg = TARCHS["internlm2-1.8b"].smoke()
    params = params_from_numpy(_np(jm.init_model(
        ARCHS["internlm2-1.8b"].smoke(), jax.random.PRNGKey(2),
        dtype=jnp.float32)), "cpu")
    batch = _t_batch(_batch(cfg, seed=3))
    ref_loss, ref = tstep.value_and_grad(cfg, params, batch, remat=False)
    for remat in (True, "dots"):
        loss, g = tstep.value_and_grad(cfg, params, batch, remat=remat)
        assert torch.equal(loss, ref_loss)
        for a, b in zip(tree_leaves(g), tree_leaves(ref)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_chunked_vocab_loss_equals_the_whole_loss():
    """lm_loss with loss_chunk (5 positions a chunk, a ragged last one)
    against the same loss without it, and their gradients: the same f32
    sums in another grouping (1e-6)."""
    cfg = TARCHS["gemma3-1b"].smoke()  # tied embeddings
    params = params_from_numpy(_np(jm.init_model(
        ARCHS["gemma3-1b"].smoke(), jax.random.PRNGKey(4),
        dtype=jnp.float32)), "cpu")
    batch = _t_batch(_batch(cfg, seed=5))
    whole, g_whole = tstep.value_and_grad(cfg, params, batch)
    chunked, g_chunk = tstep.value_and_grad(cfg, params, batch, loss_chunk=5)
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=1e-6)
    for a, b in zip(tree_leaves(g_chunk), tree_leaves(g_whole)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def _tree_like(params, rng, scale=1.0, dtype=np.float32):
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(dtype),
        params)


def test_adamw_update_and_schedule_match_jax():
    """One update from a mid-run state (step 7, clipped: the gradient's
    norm is far above clip_norm) in bf16 params: params, m, v, step and
    the gradient norm; and the schedule at warmup, peak and decay steps.
    f32 on both sides: m, v, gnorm within 1e-6 relative; the bf16
    params within one bf16 step."""
    cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=20)
    rng = np.random.default_rng(6)
    shapes = {"a": (4, 8), "b": [(16,), (2, 3, 5)]}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    params_bf = jax.tree_util.tree_map(lambda p: jnp.asarray(
        p, jnp.bfloat16), params)
    grads = _tree_like(params, rng, 3.0)
    m = _tree_like(params, rng, 0.1)
    v = jax.tree_util.tree_map(np.abs, _tree_like(params, rng, 0.01))
    jstate = jadamw.AdamWState(jnp.int32(7), m, v)
    j_p, j_s, j_n = jadamw.update(cfg, grads, jstate, params_bf)

    tcfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=20)
    t_p = params_from_numpy(_np(params_bf), "cpu")
    tstate = tadamw.AdamWState(torch.tensor(7, dtype=torch.int32),
                               params_from_numpy(m, "cpu"),
                               params_from_numpy(v, "cpu"))
    out_p, out_s, out_n = tadamw.update(
        tcfg, params_from_numpy(grads, "cpu"), tstate, t_p)
    assert out_p is t_p and int(out_s.step) == int(j_s.step) == 8
    assert math.isclose(float(out_n), float(j_n), rel_tol=1e-6)
    for got, want in ((out_s.m, j_s.m), (out_s.v, j_s.v)):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)
    for a, b in zip(tree_leaves(out_p), jax.tree_util.tree_leaves(j_p)):
        want = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), want,
                                   atol=2.0 ** -7 * np.abs(want).max(),
                                   rtol=0)
    for step in (0, 1, 3, 4, 11, 20, 25):
        np.testing.assert_allclose(
            float(tadamw.schedule(tcfg, step)),
            float(jadamw.schedule(cfg, jnp.int32(step))), rtol=1e-6)


@pytest.fixture(scope="module")
def microbatch_case():
    """The JAX package's jitted 2-microbatch step on internlm2 smoke
    (bf16) from a batch of 4."""
    cfg = ARCHS["internlm2-1.8b"].smoke()
    params = jm.init_model(cfg, jax.random.PRNGKey(8))
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(cfg, seed=9, b=4)
    p_np = _np(params)
    step = jax.jit(jstep.make_train_step(cfg, opt, microbatches=2))
    new_p, new_s, metrics = step(params, jadamw.init(params), batch)
    return p_np, batch, _np(new_p), _np(new_s), {
        k: float(v) for k, v in metrics.items()}


def test_microbatched_train_step_matches_jax(microbatch_case):
    """make_train_step(microbatches=2): loss and grad norm within the bf16
    loss tolerance and 2 % (the f32-accumulated bf16 gradients of the
    bf16 model), the first moment within BF16_GRAD_RTOL; the updated bf16
    params within 2·lr plus one bf16 step of the largest |param|: Adam's
    first step moves every element by ±lr, so an element whose tiny
    gradient differs in sign between the packages lands 2·lr apart."""
    p_np, batch, j_p, j_s, j_m = microbatch_case
    tcfg = TARCHS["internlm2-1.8b"].smoke()
    opt = tadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = params_from_numpy(p_np, "cpu")
    step = tstep.make_train_step(tcfg, opt, microbatches=2)
    new_p, new_s, metrics = step(params, tadamw.init(params),
                                 _t_batch(batch))
    assert int(new_s.step) == int(j_m["step"]) == 1
    assert abs(float(metrics["loss"]) - j_m["loss"]) <= BF16_LOSS_ATOL
    assert math.isclose(float(metrics["grad_norm"]), j_m["grad_norm"],
                        rel_tol=0.02)
    errs = _rel_errs(new_s.m, j_s.m)
    assert max(errs) <= BF16_GRAD_RTOL, errs
    for a, b in zip(tree_leaves(new_p), jax.tree_util.tree_leaves(j_p)):
        want = np.asarray(b, np.float32)
        np.testing.assert_allclose(
            a.detach().float().numpy(), want,
            atol=2 * opt.lr + 2.0 ** -8 * np.abs(want).max(), rtol=0)


def test_compress_grads_matches_jax():
    """Codes and residuals equal to the JAX package's over two steps of
    error feedback (f32 on both sides; the dequantized bf16 gradient
    equal, the residuals within 1e-7 of a scale), and the wire size."""
    rng = np.random.default_rng(10)
    grads = {"w": rng.standard_normal((6, 9)).astype(np.float32),
             "b": [rng.standard_normal((7,)).astype(np.float32) * 1e-3,
                   np.zeros((3,), np.float32)]}
    grads_bf = jax.tree_util.tree_map(
        lambda g: jnp.asarray(g, jnp.bfloat16), grads)
    j_ef = jcomp.init(grads)
    t_ef = tcomp.init(params_from_numpy(grads, "cpu"))
    for _ in range(2):
        j_deq, j_ef, j_err = jcomp.compress_grads(grads_bf, j_ef)
        t_deq, t_ef, t_err = tcomp.compress_grads(
            params_from_numpy(_np(grads_bf), "cpu"), t_ef)
        for a, b in zip(tree_leaves(t_deq),
                        jax.tree_util.tree_leaves(j_deq)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        for a, b in zip(tree_leaves(t_ef), jax.tree_util.tree_leaves(j_ef)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                       rtol=0)
        assert math.isclose(float(t_err), float(j_err), rel_tol=1e-6)
    # scale 1 (amax 127): exact halves round to even, as jnp.round does
    t = torch.tensor([0.5, 1.5, 2.5, -2.5, -0.5, 127.0])
    codes, scale = tcomp._quantize_tensor(t)
    j_codes, _ = jcomp.quantize(jnp.asarray(t.numpy()))
    assert float(scale) == 1.0
    assert codes.tolist() == [0, 2, 2, -2, 0, 127]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    assert tcomp.compressed_bytes(params_from_numpy(grads, "cpu")) == \
        jcomp.compressed_bytes(grads)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-base",
                                  "internvl2-26b"])
def test_host_batch_equals_jax_bit_for_bit(arch):
    """Tokens, labels and the front ends' embeddings, padding on."""
    shape = ShapeConfig("t", 32, 3, "train")
    for step in (0, 5):
        j = jpipeline._host_batch(
            ARCHS[arch].smoke(), shape,
            jpipeline.DataConfig(seed=3, pad_fraction=0.25), step)
        t = tpipeline._host_batch(
            TARCHS[arch].smoke(), shape,
            tpipeline.DataConfig(seed=3, pad_fraction=0.25), step)
        assert sorted(j) == sorted(t)
        for k in j:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(j[k], t[k])


def test_pipeline_prefetches_the_host_batches_in_order():
    cfg = TARCHS["internlm2-1.8b"].smoke()
    shape = ShapeConfig("t", 16, 2, "train")
    pipe = tpipeline.DataPipeline(cfg, shape, tpipeline.DataConfig(seed=1))
    try:
        for step in range(3):
            got = next(pipe)
            want = tpipeline._host_batch(cfg, shape,
                                         tpipeline.DataConfig(seed=1), step)
            for k in want:
                assert torch.equal(got[k], torch.from_numpy(want[k]))
    finally:
        pipe.close()


def test_pressure_controller_copy_keeps_the_history():
    readings = [0.1, 0.5, 0.5, 0.5, 0.85, 0.9, 0.1, 0.1, 0.1, 0.3, 0.1,
                0.1, 0.1, 0.95, 0.05]
    hist = []
    for mod in (jpressure, tpressure):
        it = iter(readings)
        acc = mod.PressureAdaptiveAccumulator(probe=lambda: next(it),
                                              max_factor=8)
        for _ in readings:
            acc.step()
        hist.append(acc.history)
    assert hist[0] == hist[1]
    assert {h["event"] for h in hist[1]} >= {"red-double", "cool-halve"}


def _recompute_dispatch(monkeypatch, name):
    """The dispatch (``ops.plain_active()`` at every ``ops`` call) of a
    loss made inside ``plain_on_card``, then of its backward run on
    another thread; returns (forward's, backward's, the smoke config)."""
    import threading

    from repro_torch.kernels import ops

    seen = []
    real = ops._on_cpu
    monkeypatch.setattr(ops, "_on_cpu", lambda q: (
        seen.append(ops.plain_active()), real(q))[1])
    cfg = TARCHS[name].smoke()
    params = params_from_numpy(_np(jm.init_model(
        ARCHS[name].smoke(), jax.random.PRNGKey(2),
        dtype=jnp.float32)), "cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with ops.plain_on_card():
        loss = tstep.lm_loss(cfg, params, _t_batch(_batch(cfg)))
    forward = list(seen)
    seen.clear()
    worker = threading.Thread(target=lambda: torch.autograd.grad(loss,
                                                                 leaves))
    worker.start()
    worker.join()
    return forward, seen, cfg


def test_recompute_takes_the_forward_dispatch_on_another_thread(
        monkeypatch):
    """A checkpointed unit's recompute runs where autograd runs it — on
    the card, autograd's device thread, which does not see the caller's
    ``plain_on_card``.  A loss made inside ``plain_on_card`` and
    differentiated on another thread still recomputes every attention
    call through the plain dispatch (without the repair the recompute
    took the kernels' path there and the checkpoint's saved tensors
    differed)."""
    forward, backward, cfg = _recompute_dispatch(monkeypatch,
                                                 "internlm2-1.8b")
    assert forward and all(forward)
    assert len(backward) == cfg.n_layers and all(backward)


def test_mamba_recompute_takes_the_forward_dispatch_on_another_thread(
        monkeypatch):
    """The same for mamba2: every recomputed SSD scan takes the plain
    dispatch on autograd's thread, so a scan whose forward ran plain
    never reaches K6's autograd Function in the recompute."""
    forward, backward, cfg = _recompute_dispatch(monkeypatch, "mamba2-2.7b")
    assert len(forward) == cfg.n_layers and all(forward)
    assert len(backward) == cfg.n_layers and all(backward)
