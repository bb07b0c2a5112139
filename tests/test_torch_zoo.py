"""The rest of the zoo on the port against the JAX package, at ``.smoke()``.

deepseek-v2-236b (MLA attention, an MoE FFN of routed and shared
experts), stablelm-1.6b (MHA), qwen1.5-110b (GQA with ``qkv_bias``),
whisper-base (an encoder-decoder over stub frame embeddings) and
internvl2-26b (a language backbone behind stub patch embeddings), on the
same parameters: made by the JAX package's ``init_model`` and carried
across by ``params_from_numpy``.

* Every config of ``ARCHS`` equals the JAX package's, field by field, and
  the port's own ``init_model`` builds the JAX tree's keys, shapes and
  dtypes for every one of the ten.
* K3's plain version with V narrower than q/k (MLA's shape) against
  ``repro.models.layers.chunked_attention``: f32 within ``F32_ATOL``.
* ``prefill`` (with ``extra`` for whisper and internvl2) and three
  ``decode_step`` calls against JAX: bf16 logits within ``LOGIT_ATOL`` =
  0.1, f32 within ``F32_LOGIT_ATOL`` = 1e-4, as
  ``tests/test_torch_model.py`` and ``tests/test_torch_moe.py`` state;
  stablelm's and qwen's paged step against the JAX paged step (its Pallas
  kernel in interpret mode) as well.
* The tick-cost model prices MLA, shared experts and 160 routed experts
  with the JAX package's coefficients.
* The port's engine refuses whisper and internvl2 with
  ``ExtraInputsNotServed``; the JAX engine fails at its first prefill
  with ``TypeError`` (ROADMAP Queue 3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402
from repro.roofline.analysis import tick_cost_model as j_tick_cost  # noqa: E402
from repro.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.roofline.analysis import tick_cost_model  # noqa: E402

LOGIT_ATOL = 0.1  # bf16 logits, as tests/test_torch_model.py states
F32_ATOL = 1e-5  # f32 against f32: summation order only
F32_LOGIT_ATOL = 1e-4  # f32 parameters through a whole model

NEW = ["deepseek-v2-236b", "stablelm-1.6b", "qwen1.5-110b", "whisper-base",
       "internvl2-26b"]
S, GEN = 11, 3  # prompt tokens, decode steps


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _t_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _t_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _t_leaves(t)]
    return [tree]


def _random_biases(p, cfg):
    """qwen's q/k/v biases initialise to zero; give them seeded values so
    the bias path carries weight in the comparison."""
    if not cfg.qkv_bias:
        return p
    rng = np.random.default_rng(5)
    attn = p["layers"]["b0"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(
            0.5 * rng.standard_normal(attn[name].shape, np.float32),
            attn[name].dtype)
    return p


def _close(t_logits, j_logits, atol):
    got, want = t_logits.float().numpy(), np.asarray(j_logits, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_config_equals_jax(name):
    assert set(TARCHS) == set(ARCHS)
    a, b = ARCHS[name], TARCHS[name]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.smoke()) == dataclasses.asdict(b.smoke())
    assert a.param_count() == b.param_count()
    assert a.kv_bytes_per_token() == b.kv_bytes_per_token()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_own_init_builds_the_jax_tree(name):
    """Keys, shapes and dtypes of the port's ``init_model`` equal the JAX
    tree's (MLA's seven weights, whisper's encoder, audio projection and
    per-block cross weights, internvl2's vision projection)."""
    cfg = ARCHS[name].smoke()
    p = jax.eval_shape(lambda k: jm.init_model(cfg, k), jax.random.PRNGKey(0))
    own = tm.init_model(TARCHS[name].smoke(), 0, device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(p)
    assert [(tuple(x.shape), str(x.dtype)) for _, x in flat] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
         for t in _t_leaves(own)]


# ----------------------------------------------------- K3 with a narrow V
@pytest.mark.parametrize("causal,q_offset,kv", [
    (True, 0, 4), (True, 5, 2), (False, 0, 4), (False, 0, 1),
])
def test_plain_flash_with_narrow_v_matches_jax(causal, q_offset, kv):
    """q/k 24 wide, V 16 wide (MLA's 192/128 in small): the scale is
    1/sqrt(24), the output V's width."""
    rng = np.random.default_rng(3)
    b, h, sq, sk, hd, vd = 2, 4, 9, 9 + q_offset, 24, 16
    q = rng.standard_normal((b, h, sq, hd), np.float32)
    k = rng.standard_normal((b, kv, sk, hd), np.float32)
    v = rng.standard_normal((b, kv, sk, vd), np.float32)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=q_offset, chunk=4)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              q_offset=q_offset, chunk=4)
    assert got.shape == (b, h, sq, vd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(
        got.numpy(),
        ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                q_offset=q_offset, chunk=4).numpy())


# ------------------------------------------------------ prefill and decode
def _extra(cfg, b, dtype):
    """The front ends' stub inputs, made with numpy (as the JAX smoke
    test shapes them: 2 frames per token, ``vision_tokens`` patches)."""
    rng = np.random.default_rng(7)
    out = {}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model), np.float32)
    if cfg.enc_layers:
        out["frame_embeds"] = rng.standard_normal(
            (b, 2 * (S + GEN), cfg.d_model), np.float32)
    return {k: v.astype(dtype) for k, v in out.items()}


@pytest.fixture(scope="module", params=[
    (name, dt) for name in NEW for dt in ("bfloat16", "float32")
], ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """(name, jax cfg, port cfg, JAX params, port params, atol)."""
    name, dt = request.param
    cfg, tcfg = ARCHS[name].smoke(), TARCHS[name].smoke()
    p = _random_biases(
        jm.init_model(cfg, jax.random.PRNGKey(0), dtype=getattr(jnp, dt)), cfg)
    atol = LOGIT_ATOL if dt == "bfloat16" else F32_LOGIT_ATOL
    return name, cfg, tcfg, p, _port(p), atol


def test_prefill_and_decode_match_jax(model):
    """``prefill`` (with the front end's ``extra``) and GEN decode steps,
    on 2 rows: logits of every step, and the caches' shapes and dtypes
    (MLA: latent and rope key; whisper: ``cross_kv`` carried)."""
    name, cfg, tcfg, p, tp, atol = model
    b = 2
    dt = np.asarray(jax.tree_util.tree_leaves(p)[0]).dtype
    extra = _extra(cfg, b, dt)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (b, S + GEN),
                                             np.int32)
    n = S + (cfg.vision_tokens if cfg.frontend == "vision_stub" else 0)
    jl, jc = jm.prefill(cfg, p, jnp.asarray(toks[:, :S]),
                        extra={k: jnp.asarray(v) for k, v in extra.items()}
                        or None, max_seq=n + GEN, remat=False)
    tl, tc = tm.prefill(tcfg, tp, torch.from_numpy(toks[:, :S]),
                        extra=_port(extra) or None, max_seq=n + GEN)
    _close(tl, jl, atol)
    jleaves = jax.tree_util.tree_leaves(jc)
    tleaves = _t_leaves(tc)
    assert [(tuple(x.shape), str(x.dtype)) for x in jleaves] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tleaves]
    assert ("cross_kv" in tc) == bool(cfg.enc_layers)
    for t in range(GEN):
        tok = toks[:, S + t:S + t + 1]
        jl, jc = jm.decode_step(cfg, p, jnp.asarray(tok), jc,
                                jnp.int32(n + t))
        tl, tc = tm.decode_step(tcfg, tp, torch.from_numpy(tok), tc, n + t)
        _close(tl, jl, atol)


def test_mla_cache_layout():
    """deepseek's decode cache: the latent [reps, B, max_seq, rank] and
    the rope key [reps, B, max_seq, rope] in bf16, per block — the
    leaves the engine pages (their seq axis is -2)."""
    cfg = TARCHS["deepseek-v2-236b"]
    small = dataclasses.replace(cfg, n_layers=2, pattern_repeats=2)
    c = tm.init_cache(small, 3, 40, device="cpu")
    lat, rope = c["unit"]["b0"]
    assert lat.shape == (2, 3, 40, 512) and rope.shape == (2, 3, 40, 64)
    assert lat.dtype == rope.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["stablelm-1.6b", "qwen1.5-110b"])
def test_paged_decode_matches_jax(name):
    """One paged step of two rows (and a pad row) against the JAX paged
    step: stablelm's one head per kv group, qwen's grouped heads with
    seeded qkv biases.  (At ``.smoke()`` stablelm and qwen are
    internlm2's shape, 4 heads over 4 kv heads, and qwen adds the
    biases.)"""
    cfg, tcfg = ARCHS[name].smoke(), TARCHS[name].smoke()
    assert tm.paged_decode_supported(tcfg)
    p = _random_biases(jm.init_model(cfg, jax.random.PRNGKey(0)), cfg)
    tp = _port(p)
    lens, page, n_slots, max_seq = [9, 5], 4, 2, 16
    slots = []
    for i, n in enumerate(lens):
        toks = np.random.default_rng(10 + i).integers(0, cfg.vocab, (1, n),
                                                      np.int32)
        slots.append(jm.prefill(cfg, p, jnp.asarray(toks),
                                max_seq=max_seq)[1])
    jc = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=1 if xs[0].ndim == 5 else 0),
        *slots)
    tables, s_slot, s_idx, pid = [], [], [], 0
    for slot, n in enumerate(lens):
        need = n // page + 1
        tables.append(list(range(pid, pid + need)))
        s_slot += [slot] * need
        s_idx += list(range(need))
        pid += need
    n_pool = 1 << (pid - 1).bit_length()
    tab = np.zeros((3, 4), np.int32)
    for r, row in enumerate(tables):
        tab[r, :len(row)] = row
    args = (
        np.asarray(lens + [0], np.int32),
        np.asarray([0, 1, n_slots], np.int32),
        tab,
        np.asarray([n + 1 for n in lens] + [0], np.int32),
        np.asarray(s_slot + [0] * (n_pool - pid), np.int32),
        np.asarray(s_idx + [0] * (n_pool - pid), np.int32),
    )
    toks = np.asarray([[3], [4], [0]], np.int32)
    jl, _ = jm.decode_step_paged(
        cfg, p, jnp.asarray(toks), jc, *map(jnp.asarray, args),
        page_tokens=page, n_pool=n_pool, interpret=True)
    tl, _ = tm.decode_step_paged(
        tcfg, tp, torch.from_numpy(toks), _port(jc),
        *map(torch.from_numpy, args), page_tokens=page, n_pool=n_pool)
    _close(tl[:2], np.asarray(jl)[:2], LOGIT_ATOL)


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "whisper-base",
                                  "internvl2-26b"])
def test_paged_path_stays_off(name):
    """As in the JAX package: MLA latents, encoder-decoder and vision
    stacks keep the dense path."""
    assert not tm.paged_decode_supported(TARCHS[name])
    assert not jm.paged_decode_supported(ARCHS[name])


def test_prefill_without_extra_raises():
    for name, key in (("whisper-base", "frame_embeds"),
                      ("internvl2-26b", "patch_embeds")):
        tcfg = TARCHS[name].smoke()
        tp = tm.init_model(tcfg, 0, device="cpu")
        with pytest.raises(ValueError, match=key):
            tm.prefill(tcfg, tp, torch.zeros((1, 4), dtype=torch.int32))


# ---------------------------------------------------------------- pricing
@pytest.mark.parametrize("name", NEW)
def test_tick_cost_prices_as_jax(name):
    """MLA's latent bytes, shared experts and 160 routed experts priced
    with the JAX package's coefficients (only the card's constants
    differ)."""
    a, b = j_tick_cost(ARCHS[name]), tick_cost_model(TARCHS[name])
    for field in ("weight_bytes", "active_params", "kv_write_bytes_per_token",
                  "act_bytes_per_token", "page_bytes"):
        assert getattr(a, field) == getattr(b, field), field
    if name == "deepseek-v2-236b":
        assert b.kv_write_bytes_per_token == 60 * (512 + 64) * 2
        assert b.active_params < b.weight_bytes / 2 / 5


# ---------------------------------------------------------------- refusal
@pytest.mark.parametrize("name", ["whisper-base", "internvl2-26b"])
def test_engine_refuses_extra_needing_models(name):
    """The port refuses at construction; the JAX engine takes the request
    and fails at its first prefill, reading ``extra`` that its jitted
    prefill never passes."""
    cfg, tcfg = ARCHS[name].smoke(), TARCHS[name].smoke()
    with pytest.raises(tserve.ExtraInputsNotServed, match="Queue 3"):
        tserve.ServingEngine(
            tcfg, tm.init_model(tcfg, 0, device="cpu"),
            tserve.EngineConfig(n_slots=2, max_seq=32,
                                hbm_capacity_bytes=1e9, device="cpu"))
    j = ServingEngine(cfg, jm.init_model(cfg, jax.random.PRNGKey(0)),
                      EngineConfig(n_slots=2, max_seq=32,
                                   hbm_capacity_bytes=1e9))
    j.submit(Request("r0", "A", list(range(5, 12)), 3))
    with pytest.raises(TypeError, match="not subscriptable"):
        j.run(max_ticks=5)
