"""GQA attention block, full or sliding-window: init, full-sequence
(prefill) and decode apply; MLA (deepseek-v2's multi-head latent
attention), whose prefill runs through K3 with a V narrower than q/k and
whose decode is the absorbed latent form in plain f32 torch (the JAX
package has no kernel for it); the token-choice top-k MoE FFN, whose
expert GEMMs run through ``kernels.ops.grouped_matmul`` (K5 on the card);
and the Mamba-2 block, whose prefill scan runs through
``kernels.ops.ssd_scan`` (K6 on the card).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import obs
from ..configs.base import ArchConfig
from ..dist.sharding import (by_roles, is_dtensor, merge_heads, shard,
                              split_heads)
from ..kernels import ops as kernel_ops
from ..kernels import spmd
from ..kernels.ref import NEG_INF
from .layers import (
    apply_rope,
    chunked_attention,
    decode_attention,
    decode_attention_ring,
    dense_init,
    rms_norm,
)


#: the logical axes of q (and of attention's output) [B, H, S, hd]
_HEADS = ("batch", "heads", "seq", None)


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype, device):
    hd = cfg.head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.n_heads * hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(cfg.n_kv_heads * hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(cfg.n_kv_heads * hd, dtype=dtype, device=device)
    return p


def _qkv(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """x [B, S, d] → q [B, H, S, hd], k/v [B, KV, S, hd]."""
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, cfg.n_heads, _HEADS)
    k = split_heads(k, cfg.n_kv_heads, ("batch", "kv_heads", "seq", None))
    v = split_heads(v, cfg.n_kv_heads, ("batch", "kv_heads", "seq", None))
    return q, k, v


def attention_forward(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    q_offset: int = 0,
    return_cache: bool = False,
):
    """Full-sequence attention (prefill); with ``return_cache`` also the
    roped K and V [B, KV, S, hd]."""
    s = x.shape[1]
    q, k, v = _qkv(p, cfg, x)
    positions = q_offset + torch.arange(s, device=x.device)
    q = apply_rope(q, positions[None, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, None, :], cfg.rope_theta)
    out = chunked_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset
    )
    y = torch.matmul(merge_heads(out, _HEADS), p["wo"])
    if return_cache:
        return y, (k, v)
    return y


def attention_decode(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    cache: Tuple[torch.Tensor, torch.Tensor],
    pos: Union[int, torch.Tensor],
    *,
    window: Optional[int] = None,
    rows: Optional[torch.Tensor] = None,
):
    """Single-token decode.

    Full attention: cache k/v [B, KV, S_max, hd], written at ``pos`` (an
    int or a [B] tensor).  Sliding window: when the cache holds exactly
    ``window`` slots it is a RING buffer, written at ``pos % window``
    (see ``layers.decode_attention_ring``); a shorter cache (max_seq <
    window) is positional.  The cache is updated IN PLACE — the JAX
    package returns a new cache, the port writes into the engine's cache
    to save a copy of it per step.  ``rows`` (int64 indices) limits the
    write to those batch rows: the others keep their cache bit for bit,
    as the masked vmapped step keeps them.
    """
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x)  # seq dim == 1
    pos_t = torch.as_tensor(pos, device=x.device).reshape(-1)
    positions = pos_t[:, None, None] if pos_t.numel() > 1 else pos_t.reshape(
        1, 1, 1
    )
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    k_cache, v_cache = cache
    pos_b = pos_t.expand(b) if pos_t.numel() == 1 else pos_t
    ring = window is not None and k_cache.shape[2] == window
    write_at = pos_b % window if ring else pos_b
    if is_dtensor(k_cache) and rows is None:
        spmd.write_at(k_cache, k_new[:, :, 0], write_at, 2)
        spmd.write_at(v_cache, v_new[:, :, 0], write_at, 2)
    else:
        idx = torch.arange(b, device=x.device) if rows is None else rows
        k_cache[idx, :, write_at[idx]] = k_new[idx, :, 0]
        v_cache[idx, :, write_at[idx]] = v_new[idx, :, 0]
    if ring:
        out = decode_attention_ring(q, k_cache, v_cache, pos_b, window)
    else:
        out = decode_attention(q, k_cache, v_cache, pos_b, window=window)
    y = torch.matmul(merge_heads(out, _HEADS), p["wo"])
    return y, (k_cache, v_cache)


# ===================================================================== MLA
def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    """deepseek-v2's MLA weights, in the JAX package's order and shapes:
    low-rank q (``wq_a`` → norm → ``wq_b``), the joint KV latent plus the
    shared rope key (``wkv_a``), its up-projection to per-head nope keys
    and values (``wkv_b``), and ``wo``."""
    m = cfg.mla
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq_a": dense_init(gen, d, m.q_lora_rank, dtype, device),
        "q_ln": torch.zeros(m.q_lora_rank, dtype=dtype, device=device),
        "wq_b": dense_init(gen, m.q_lora_rank, h * qk_dim, dtype, device),
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype, device),
        "kv_ln": torch.zeros(m.kv_lora_rank, dtype=dtype, device=device),
        "wkv_b": dense_init(gen, m.kv_lora_rank,
                            h * (m.qk_nope_head_dim + m.v_head_dim), dtype,
                            device),
        "wo": dense_init(gen, h * m.v_head_dim, d, dtype, device),
    }


def _mla_q(p: dict, cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """x [B, S, d] → (q_nope [B, H, S, nope], roped q_rope [B, H, S,
    rope]); ``positions`` broadcasts to [B, 1, S]."""
    m = cfg.mla
    q_lat = rms_norm(torch.matmul(x, p["wq_a"]), p["q_ln"], cfg.norm_eps)
    q = split_heads(torch.matmul(q_lat, p["wq_b"]), cfg.n_heads, _HEADS)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """x [B, S, d] → (normed latent [B, S, rank], roped shared key
    [B, 1, S, rope])."""
    m = cfg.mla
    kv_a = torch.matmul(x, p["wkv_a"])
    latent = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., m.kv_lora_rank:][:, None], positions,
                        cfg.rope_theta)
    return latent, k_rope


def mla_forward(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    q_offset: int = 0,
    return_cache: bool = False,
):
    """MLA prefill: the latent expanded to per-head keys (nope + the
    shared rope key, 192 wide at full width) and values (128 wide), then
    causal attention through K3 with V narrower than q/k; with
    ``return_cache`` also the cache — the latent [B, S, rank] and the
    rope key [B, S, rope], not per-head K/V."""
    m = cfg.mla
    b, s, _ = x.shape
    positions = (q_offset + torch.arange(s, device=x.device))[None, None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    latent, k_rope = _mla_latent(p, cfg, x, positions)
    kv = split_heads(torch.matmul(latent, p["wkv_b"]), cfg.n_heads, _HEADS)
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([
        k_nope,
        k_rope.expand(b, cfg.n_heads, s, m.qk_rope_head_dim),
    ], dim=-1)
    out = chunked_attention(q, k, v, causal=True, q_offset=q_offset)
    y = torch.matmul(merge_heads(out, _HEADS), p["wo"])
    if return_cache:
        return y, (latent, k_rope[:, 0])
    return y


def mla_decode(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    cache: Tuple[torch.Tensor, torch.Tensor],
    pos: Union[int, torch.Tensor],
    *,
    rows: Optional[torch.Tensor] = None,
):
    """Absorbed-form MLA decode in f32: ``wkv_b``'s key half is folded
    into the query and attention runs over the latent cache
    [B, S_max, rank] and the rope-key cache [B, S_max, rope], both
    written at ``pos`` (an int or a [B] tensor) IN PLACE, in every row or
    only in ``rows``.  Plain torch on every device: the JAX package has
    no kernel for it."""
    m = cfg.mla
    b = x.shape[0]
    latent_cache, rope_cache = cache
    pos_t = torch.as_tensor(pos, device=x.device).reshape(-1)
    pos_b = pos_t.expand(b) if pos_t.numel() == 1 else pos_t
    positions = pos_b.reshape(b, 1, 1) if pos_t.numel() > 1 else (
        pos_t.reshape(1, 1, 1))
    q_nope, q_rope = _mla_q(p, cfg, x, positions)  # [B, H, 1, *]
    latent_new, k_rope_new = _mla_latent(p, cfg, x, positions)
    if is_dtensor(latent_cache) and rows is None:
        spmd.write_at(latent_cache, latent_new[:, 0], pos_b, 1)
        spmd.write_at(rope_cache, k_rope_new[:, 0, 0], pos_b, 1)
    else:
        idx = torch.arange(b, device=x.device) if rows is None else rows
        latent_cache[idx, pos_b[idx]] = latent_new[idx, 0]
        rope_cache[idx, pos_b[idx]] = k_rope_new[idx, 0, 0]
    wkv_b = p["wkv_b"].reshape(
        m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim
    )
    w_k = wkv_b[..., :m.qk_nope_head_dim].float()  # [r, H, nope]
    w_v = wkv_b[..., m.qk_nope_head_dim:].float()  # [r, H, v]
    q_lat = torch.einsum("bhqn,rhn->bhqr", q_nope.float(), w_k)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    lat = latent_cache.float()
    logits = (
        torch.einsum("bhqr,bsr->bhqs", q_lat, lat)
        + torch.einsum("bhqe,bse->bhqs", q_rope.float(), rope_cache.float())
    ) * scale
    keep = (torch.arange(latent_cache.shape[1], device=x.device)[None, :]
            <= pos_b[:, None])  # [B, S]
    logits = torch.where(keep[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bhqr", probs, lat)
    out = torch.einsum("bhqr,rhv->bhqv", ctx, w_v)  # [B, H, 1, v]
    y = torch.matmul(merge_heads(out, _HEADS).to(x.dtype), p["wo"])
    return y, (latent_cache, rope_cache)


# ===================================================================== MoE
def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    """Router [d, E] in f32; gate/up [E, d, f] and down [E, f, d] in
    ``dtype``; normal weights scaled by 1/sqrt(d_model), as in the JAX
    package."""
    moe = cfg.moe
    d, e, f = cfg.d_model, moe.num_experts, moe.d_ff_expert
    scale = 1.0 / math.sqrt(d)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device) * scale

    return {
        "router": normal(d, e),
        "gate": normal(e, d, f).to(dtype),
        "up": normal(e, d, f).to(dtype),
        "down": normal(e, f, d).to(dtype),
    }


def _capacity(cfg: ArchConfig, seq: int) -> int:
    """Per-sequence expert capacity of a prefill of ``seq`` tokens."""
    moe = cfg.moe
    c = int(math.ceil(seq * moe.top_k / moe.num_experts * moe.capacity_factor))
    return max(8, min(c, seq))


def _decode_capacity(cfg: ArchConfig, rows: int) -> int:
    """Expert capacity of one decode dispatch group of ``rows`` tokens."""
    moe = cfg.moe
    return max(4, int(math.ceil(
        rows * moe.top_k / moe.num_experts * moe.capacity_factor
    )))


def moe_dispatch_row(x: torch.Tensor, gates: torch.Tensor, top_k: int,
                     capacity: int):
    """Sort-based dispatch of G independent groups at once: the JAX
    package's ``moe_dispatch_row`` (one group) written out over a leading
    group axis instead of vmapped.

    x [G, N, d], gates [G, N, E].  Returns (xe, slot, tok, gate, keep):
    slot/tok/gate/keep [G, N·k] are JAX's per group, in expert-sorted
    order, with ``slot = expert · capacity + position`` and 0 where the
    entry is dropped.  ``xe`` [E, G·capacity, d] holds the groups folded
    into the capacity axis, expert e's slots of group g at rows
    ``g·capacity .. (g+1)·capacity`` — the layout one grouped matmul over
    all groups takes.

    Parity with JAX: ``lax.top_k`` breaks ties toward the lower index (a
    stable descending sort here), ``jnp.argsort`` is stable and
    ``searchsorted`` left-sided.
    """
    g, n, e = gates.shape
    d = x.shape[-1]
    dev = x.device
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_vals = torch.softmax(vals[..., :top_k], dim=-1)  # renormalised
    flat_expert = idx[..., :top_k].reshape(g, n * top_k)
    flat_gate = top_vals.reshape(g, n * top_k)
    flat_tok = torch.arange(n, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = flat_expert.gather(1, order)
    sorted_tok = flat_tok[order]
    sorted_gate = flat_gate.gather(1, order)
    starts = torch.searchsorted(
        sorted_expert, torch.arange(e, device=dev).expand(g, e).contiguous()
    )  # [G, E]
    pos = torch.arange(n * top_k, device=dev) - starts.gather(1, sorted_expert)
    keep = pos < capacity
    slot = torch.where(keep, sorted_expert * capacity + pos, 0)
    # folded row of each kept entry; dropped ones land on a spare last row
    group = torch.arange(g, device=dev)[:, None]
    dest = torch.where(
        keep, sorted_expert * (g * capacity) + group * capacity + pos,
        e * g * capacity,
    )
    xe = x.new_zeros(e * g * capacity + 1, d)
    xe[dest.reshape(-1)] = x[group, sorted_tok].reshape(-1, d)
    return (xe[:-1].view(e, g * capacity, d), slot, sorted_tok, sorted_gate,
            keep)


def _combine(slot, tok, gate_w, keep, ye, cap: int, top_k: int):
    """The gated sum of each token's k expert outputs, in f32 [G, N, d],
    token by token: ``ye`` [E, G·cap, d] holds the groups folded into the
    capacity axis; a dropped entry reads slot 0 of its group with weight
    0."""
    groups, d = slot.shape[0], ye.shape[-1]
    ye = ye.reshape(-1, d)
    group = torch.arange(groups, device=ye.device)[:, None]
    rows = (slot // cap) * (groups * cap) + group * cap + slot % cap
    by_tok = torch.argsort(tok, dim=-1, stable=True)
    weight = (gate_w * keep).gather(1, by_tok)
    vals = ye[rows.gather(1, by_tok)].float() * weight[..., None]
    return vals.view(groups, -1, top_k, d).sum(dim=2)


def moe_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                per_row: bool = False) -> torch.Tensor:
    """Token-choice top-k MoE with capacity dropping, as the JAX package's
    ``moe_forward``: a prefill (s > 1) dispatches each sequence on its own
    with ``_capacity(s)``; a decode step (s == 1) dispatches the whole
    batch as ONE group, so rows compete for capacity and a later row
    loses its expert once earlier rows filled it.  ``per_row`` makes
    every decode row its own group instead — what the JAX engine's
    per-slot vmapped decode computes (a single row never drops).

    The groups fold into the capacity axis, so each of the three expert
    products is one ``ops.grouped_matmul`` call (K5 on the card); the
    combine adds the gated expert outputs in f32."""
    moe = cfg.moe
    s, d = x.shape[1], x.shape[2]
    with obs.span("moe.route"):
        gates = torch.softmax(torch.matmul(x.float(), p["router"]), dim=-1)
    one_group = s == 1 and not per_row  # the batch's rows are its tokens
    if one_group:
        x, gates = x.transpose(0, 1), gates.transpose(0, 1)
    cap = _capacity(cfg, s) if s > 1 else _decode_capacity(cfg, x.shape[1])
    groups, n = gates.shape[0], gates.shape[1]
    # on DTensors each device dispatches and combines its own groups
    g0, folded = {"group": 0}, {"group": 1}  # [E, G·cap, d]: groups in dim 1
    with obs.span("moe.dispatch"):
        if is_dtensor(x):
            xe, slot, tok, gate_w, keep = by_roles(
                lambda xl, gl: moe_dispatch_row(xl, gl, moe.top_k, cap),
                (x, gates), (g0, g0), (folded,) + (g0,) * 4,
                ((moe.num_experts, groups * cap, d),)
                + ((groups, n * moe.top_k),) * 4)
        else:
            xe, slot, tok, gate_w, keep = moe_dispatch_row(
                x, gates, moe.top_k, cap)
    # the groups fold into the capacity axis: where they are the batch's
    # sequences (or rows), that axis carries JAX's "batch" pin
    rows_axis = None if one_group else "batch"
    with obs.span("moe.experts"):
        xe = shard(xe, ("expert", rows_axis, None))
        h_gate = kernel_ops.grouped_matmul(xe, p["gate"])
        h_up = kernel_ops.grouped_matmul(xe, p["up"])
        h = F.silu(h_gate.float()).to(x.dtype) * h_up
        h = shard(h, ("expert", rows_axis, "expert_mlp"))
        ye = kernel_ops.grouped_matmul(h, p["down"])
    with obs.span("moe.combine"):
        if is_dtensor(ye):
            y = by_roles(lambda *t: _combine(*t, cap, moe.top_k),
                         (slot, tok, gate_w, keep, ye),
                         (g0,) * 4 + (folded,), (g0,), ((groups, n, d),))
        else:
            y = _combine(slot, tok, gate_w, keep, ye, cap, moe.top_k)
        if one_group:
            y = y.transpose(0, 1)
        return y.to(x.dtype)


# ================================================================== Mamba-2
def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    """Mamba-2 block with split projections (z, x, B, C, dt), as in the
    JAX package: depthwise conv weights ``[d_conv, width]`` drawn from
    N(0, 0.1²), and in f32 ``A_log = log(linspace(1, 16, nh))``, ``D = 1``
    and ``dt_bias = 0``."""
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.d_inner(d)
    nh = ssm.n_heads(d)

    def conv(width):
        w = torch.randn((ssm.d_conv, width), generator=gen,
                        dtype=torch.float32, device=device)
        return (w * 0.1).to(dtype)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": dense_init(gen, d, di, dtype, device),
        "w_x": dense_init(gen, d, di, dtype, device),
        "w_B": dense_init(gen, d, ssm.d_state, dtype, device),
        "w_C": dense_init(gen, d, ssm.d_state, dtype, device),
        "w_dt": dense_init(gen, d, nh, dtype, device),
        "conv_x": conv(di),
        "conv_B": conv(ssm.d_state),
        "conv_C": conv(ssm.d_state),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones(nh, **f32),
        "dt_bias": torch.zeros(nh, **f32),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """Depthwise causal conv along seq; x [B, S, C], w [d_conv, C].  In
    x's dtype, rounded after every product and every add, as the JAX
    package's Python ``sum`` of bf16 terms is."""
    d_conv = w.shape[0]
    x_pad = F.pad(x, (0, 0, d_conv - 1, 0))
    return sum(x_pad[:, i:i + s] * w[i][None, None, :] for i in range(d_conv))


def _ssd_scan(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """Chunked SSD scan [arXiv:2405.21060 §6] through ``kernels.ops``
    (K6 on the card, ``ref.ssd_scan_ref`` on the CPU).  x [b, s, nh, hd],
    dt [b, s, nh], A [nh], B and C [b, s, ds], all f32; y f32."""
    return kernel_ops.ssd_scan(x, dt, A, B, C, chunk)


def mamba_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                  return_cache: bool = False):
    """Mamba-2 block over a sequence (prefill); with ``return_cache`` also
    (conv_x tail, conv_B tail, conv_C tail, SSD state): the last
    ``d_conv - 1`` positions of the bf16 projections (fewer when the
    sequence is shorter, as in the JAX package) and the f32 state
    [B, nh, hd, ds].  bf16 rounds where the JAX package's does: the
    projections, the conv, ``y`` before the gate, the gate product; in
    training the projections' cotangents too (``bf16_grad``)."""
    ssm = cfg.ssm
    b, s, d = x.shape
    di = ssm.d_inner(d)
    nh = ssm.n_heads(d)
    # read at call time, as the JAX package's function-level import is,
    # so that a swap of ``layers.bf16_grad`` reaches these five boundaries
    from .layers import bf16_grad

    # the cotangents reaching the projections round to bf16, as the JAX
    # package's: the scan's internals run in f32
    z = bf16_grad(torch.matmul(x, p["w_z"]))
    x_in = bf16_grad(torch.matmul(x, p["w_x"]))
    B_in = bf16_grad(torch.matmul(x, p["w_B"]))
    C_in = bf16_grad(torch.matmul(x, p["w_C"]))
    dt_raw = bf16_grad(torch.matmul(x, p["w_dt"]))

    xc = F.silu(_causal_conv(x_in, p["conv_x"], s).float())
    Bc = F.silu(_causal_conv(B_in, p["conv_B"], s).float())
    Cc = F.silu(_causal_conv(C_in, p["conv_C"], s).float())

    xs = xc.reshape(b, s, nh, ssm.head_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y = _ssd_scan(xs, dt, A, Bc, Cc, ssm.chunk_size)
    y = y + p["D"][None, None, :, None] * xs
    y = y.reshape(b, s, di).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = torch.matmul(y, p["out_proj"])
    if return_cache:
        tail = ssm.d_conv - 1
        cache = (
            x_in[:, -tail:],
            B_in[:, -tail:],
            C_in[:, -tail:],
            _final_state(xs, dt, A, Bc),
        )
        return out, cache
    return out


def _final_state(xs, dt, A, B) -> torch.Tensor:
    """Final SSM state  H = sum_j exp(sum_{l>j} dA_l) dt_j B_j x_j  (f32),
    [b, nh, hd, ds]: plain torch, as the JAX package's is plain jnp."""
    dA = dt * A[None, None, :]
    seg = torch.cumsum(dA, dim=1)
    total = seg[:, -1:, :]
    decay = torch.exp(total - seg)  # [b, s, nh]
    wx = (decay * dt)[..., None] * xs.float()
    return torch.einsum("bsd,bshp->bhpd", B, wx)


def _ssd_step(state, xs, dt, A, Bc, Cc, D):
    """One recurrent step of the SSD state [b, nh, hd, ds] (f32), and its
    output with the D skip [b, nh, hd]."""
    decay = torch.exp(dt * A[None, :])  # [b, nh]
    new_state = decay[:, :, None, None] * state + torch.einsum(
        "bd,bhp->bhpd", Bc, dt[..., None] * xs
    )
    y = torch.einsum("bhpd,bd->bhp", new_state, Cc)  # [b, nh, hd]
    return new_state, y + D[None, :, None] * xs


def mamba_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache, pos,
                 *, rows: Optional[torch.Tensor] = None):
    """Single-token Mamba-2 step: O(1) state update, plain torch (the JAX
    package's is plain jnp).  ``cache`` is (conv_x tail, conv_B tail,
    conv_C tail, SSD state), updated IN PLACE — only ``rows`` when given,
    so the other rows keep their recurrent state bit for bit, as the JAX
    engine's masked vmapped step keeps it.  ``pos`` is unused: the state
    carries the position.  The step's conv is a dot over the window (f32
    sum, one bf16 rounding), as the JAX package's einsum is; it rounds
    otherwise than the prefill conv, in both packages."""
    ssm = cfg.ssm
    b, _, d = x.shape
    di = ssm.d_inner(d)
    nh = ssm.n_heads(d)
    cx, cB, cC, state = cache
    x0 = x[:, 0]
    z = torch.matmul(x0, p["w_z"])
    x_in = torch.matmul(x0, p["w_x"])
    B_in = torch.matmul(x0, p["w_B"])
    C_in = torch.matmul(x0, p["w_C"])
    dt_raw = torch.matmul(x0, p["w_dt"])

    def step_conv(tail, new, w):
        window = torch.cat([tail, new[:, None]], dim=1)  # [b, d_conv, c]
        out = (window.float() * w.float()[None]).sum(dim=1).to(window.dtype)
        return F.silu(out.float()), window[:, 1:]

    xc, new_cx = step_conv(cx, x_in, p["conv_x"])
    Bc, new_cB = step_conv(cB, B_in, p["conv_B"])
    Cc, new_cC = step_conv(cC, C_in, p["conv_C"])
    xs = xc.reshape(b, nh, ssm.head_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [b, nh]
    A = -torch.exp(p["A_log"])
    if is_dtensor(xs):  # each device steps its rows' heads
        bh, b_only = {"batch": 0, "heads": 1}, {"batch": 0}
        h_only = {"heads": 0}
        new_state, y = by_roles(
            _ssd_step, (state, xs, dt, A, Bc, Cc, p["D"]),
            (bh, bh, bh, h_only, b_only, b_only, h_only), (bh, bh),
            (tuple(state.shape), tuple(xs.shape)))
    else:
        new_state, y = _ssd_step(state, xs, dt, A, Bc, Cc, p["D"])
    y = y.reshape(b, di).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = torch.matmul(y, p["out_proj"])[:, None]
    idx = torch.arange(b, device=x.device) if rows is None else rows
    for old, new in ((cx, new_cx), (cB, new_cB), (cC, new_cC),
                     (state, new_state)):
        if is_dtensor(old) and rows is None:  # every row: a copy
            old.copy_(new.to(old.dtype).redistribute(old.device_mesh,
                                                     old.placements))
        else:
            old[idx] = new[idx].to(old.dtype)
    return out, cache
