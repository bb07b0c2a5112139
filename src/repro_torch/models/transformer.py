"""Model assembly for pure full-attention stacks: init, prefill, decode.

The parameter and cache trees keep the JAX package's layout so the two
can be compared like with like: the repeated unit's leaves are stacked
``[reps, ...]`` under ``layers`` (keys ``b0``, ``b1``, ... per block of
the pattern), suffix blocks are a list, and a cache is
``{"unit": {"b0": (k, v)}, "suffix": [...]}`` with k/v
``[reps, batch, KV, max_seq, hd]`` in bf16.  Where JAX scans over the
stacked unit, the port loops over its leading axis.

Only stacks of plain ``attn`` blocks run here; any other architecture
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

from ..configs.base import ArchConfig
from ..kernels import ops as kernel_ops
from . import blocks
from .layers import (
    apply_mlp,
    apply_rope,
    dense_init,
    embed_init,
    init_mlp,
    rms_norm,
)

PyTree = Any


def _require_supported(cfg: ArchConfig) -> None:
    """The port runs pure GQA attention stacks only (ROADMAP Queue 1
    item 10 ports the rest of the zoo)."""
    if not paged_decode_supported(cfg) or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: only dense stacks of 'attn' blocks are ported; "
            "MoE, MLA, Mamba, sliding-window, encoder-decoder and vision "
            "stacks wait for ROADMAP Queue 1 item 10"
        )


def paged_decode_supported(cfg: ArchConfig) -> bool:
    """True when the whole stack is plain full attention — the layout the
    paged-decode kernel serves."""
    stack = list(cfg.block_pattern) + list(cfg.suffix_blocks)
    return (
        cfg.mla is None
        and cfg.ssm is None
        and not cfg.enc_layers
        and cfg.frontend in (None, "none")
        and bool(stack)
        and all(bt == "attn" for bt in stack)
    )


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on; asking for CUDA where there is
    none raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # "cuda" means the current card, by index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# -------------------------------------------------------------------- init
def _init_block(gen, cfg: ArchConfig, dtype, device) -> dict:
    return {
        "ln1": torch.zeros(cfg.d_model, dtype=dtype, device=device),
        "attn": blocks.init_attention(gen, cfg, dtype, device),
        "ln2": torch.zeros(cfg.d_model, dtype=dtype, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _stack(trees: List[PyTree]) -> PyTree:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_model(
    cfg: ArchConfig,
    seed: int = 0,
    *,
    dtype=torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> PyTree:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), in the JAX package's tree layout.  The numbers differ
    from ``jax.random``'s: to compare the two, carry the JAX parameters
    across with :func:`repro_torch.models.convert.params_from_numpy`."""
    _require_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    reps = cfg.resolved_pattern_repeats
    params: Dict[str, Any] = {
        "embed": {"tokens": embed_init(gen, cfg.vocab, cfg.d_model, dtype, dev)},
        "layers": _stack([
            {
                f"b{i}": _init_block(gen, cfg, dtype, dev)
                for i in range(len(cfg.block_pattern))
            }
            for _ in range(reps)
        ]),
        "suffix": [_init_block(gen, cfg, dtype, dev) for _ in cfg.suffix_blocks],
        "final_ln": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            gen, cfg.d_model, cfg.vocab, dtype, dev
        )
    return params


def init_cache(
    cfg: ArchConfig,
    batch: int,
    max_seq: int,
    *,
    device: Union[str, torch.device] = "cuda",
) -> PyTree:
    """Zeroed bf16 decode caches: {unit: {b<i>: (k, v)}, suffix: [...]}."""
    _require_supported(cfg)
    dev = resolve_device(device)
    reps = cfg.resolved_pattern_repeats
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)

    def kv(lead=()):
        return tuple(
            torch.zeros(lead + shape, dtype=torch.bfloat16, device=dev)
            for _ in range(2)
        )

    return {
        "unit": {f"b{i}": kv((reps,)) for i in range(len(cfg.block_pattern))},
        "suffix": [kv() for _ in cfg.suffix_blocks],
    }


def _layers(cfg: ArchConfig, params, caches=None) -> Iterator[Tuple]:
    """(block params, block cache) in execution order: the unit's blocks
    once per repeat (their leaves indexed at the repeat), then the suffix.
    Cache leaves are views, so writes land in ``caches``."""
    for r in range(cfg.resolved_pattern_repeats):
        for i in range(len(cfg.block_pattern)):
            key = f"b{i}"
            p = _index(params["layers"][key], r)
            c = None
            if caches is not None:
                k, v = caches["unit"][key]
                c = (k[r], v[r])
            yield p, c
    for j, p in enumerate(params["suffix"]):
        yield p, (caches["suffix"][j] if caches is not None else None)


def _index(tree: PyTree, r: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


# ----------------------------------------------------------------- forward
def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tokens"][tokens.long()]


def _unembed(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the f32 logits [B, S, V]."""
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    w = (
        params["embed"]["tokens"].t()
        if cfg.tie_embeddings
        else params["lm_head"]
    )
    return torch.matmul(x.float(), w.float())


def _ffn(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return apply_mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


def prefill(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, S]
    *,
    max_seq: Optional[int] = None,
):
    """Forward over the prompt; returns (last-position logits [B, 1, V],
    caches with the seq axis padded to ``max_seq``)."""
    _require_supported(cfg)
    b, s = tokens.shape
    max_seq = max_seq or s
    x = _embed(params, tokens)
    kvs = []
    for p, _ in _layers(cfg, params):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, (k, v) = blocks.attention_forward(
            p["attn"], cfg, h, return_cache=True
        )
        x = x + a
        x = x + _ffn(p, cfg, x)
        pad = max_seq - s
        if pad > 0:
            k = torch.nn.functional.pad(k, (0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        kvs.append((k, v))
    logits = _unembed(cfg, params, x[:, -1:])
    return logits, _caches_from_layers(cfg, kvs)


def _caches_from_layers(cfg: ArchConfig, kvs: List[Tuple]) -> PyTree:
    n_pat = len(cfg.block_pattern)
    reps = cfg.resolved_pattern_repeats
    unit = {}
    for i in range(n_pat):
        per_rep = [kvs[r * n_pat + i] for r in range(reps)]
        unit[f"b{i}"] = (
            torch.stack([k for k, _ in per_rep]),
            torch.stack([v for _, v in per_rep]),
        )
    return {"unit": unit, "suffix": kvs[reps * n_pat:]}


def decode_step(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, 1]
    caches,
    pos: Union[int, torch.Tensor],  # int, or [B] per-row positions
    *,
    rows: Optional[torch.Tensor] = None,
):
    """One decode step; returns (logits [B, 1, V], caches).

    The caches are updated in place (and returned): the new token's K/V
    land at ``pos`` of each row, or only of ``rows`` when given.
    """
    _require_supported(cfg)
    x = _embed(params, tokens)
    for p, cache in _layers(cfg, params, caches):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = blocks.attention_decode(p["attn"], cfg, h, cache, pos, rows=rows)
        x = x + a
        x = x + _ffn(p, cfg, x)
    return _unembed(cfg, params, x), caches


# ------------------------------------------------------- paged decode (pool)
def _quantize_pool_int8(pool: torch.Tensor):
    """Per-page absmax int8 quantization of a ``[n, P, hd]`` pool view:
    returns (codes int8, scales f32 [n]).  As in the JAX package the scale
    is computed in the pool's dtype and floored at 1e-8 (never-written pad
    pages are all zero), and codes are not clipped beyond the int8 cast;
    XLA's float→int8 cast saturates where torch's wraps, so the saturation
    is written out."""
    absmax = pool.abs().amax(dim=(1, 2))
    scales = torch.clamp_min(absmax / 127.0, 1e-8).float()
    codes = torch.round(pool.float() / scales[:, None, None])
    return codes.clamp(-128, 127).to(torch.int8), scales


def decode_step_paged(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, 1] — compacted active rows (B may be padded)
    caches,  # the engine's per-slot dense caches (slot axis = n_slots)
    poss: torch.Tensor,  # [B] int32 per-row decode position
    row_slot: torch.Tensor,  # [B] int32 slot of each row; n_slots for pad rows
    page_table: torch.Tensor,  # [B, W] int32 pool page ids (width-trimmed)
    seq_lens: torch.Tensor,  # [B] int32 tokens to attend (pos+1; 0 for pad)
    page_src_slot: torch.Tensor,  # [n_pool] int32 owning slot of each page
    page_src_idx: torch.Tensor,  # [n_pool] int32 logical page index there
    *,
    page_tokens: int,
    n_pool: int,
    int8: bool = False,
):
    """One decode step through the paged-decode kernel, one call per layer.

    As in the JAX package: the new token's K/V are written into the slot
    caches first (in place here), the pool view is gathered page by page
    from the owning slots through the provenance arrays, and the kv-head
    axis is folded into the page axis —

        pool row of (kv head g, page pid) = g · n_pool + pid
        table row of (request b, q head h) = table[b] + (h // G) · n_pool

    — so the whole batch is one [B·H, W] kernel call.  With ``int8`` the
    pool views are quantized per page and K2 runs instead of K1.

    Pad rows carry ``row_slot == n_slots``; the JAX package drops their
    out-of-bounds write.  Torch indexing raises on that index, so pad rows
    repeat row 0's write instead (row 0 is always a real row): duplicate
    writes of one value leave the cache exactly as the real write alone,
    with no device→host read to find the real rows.
    Returns (logits [B, 1, V], caches).
    """
    _require_supported(cfg)
    x = _embed(params, tokens)
    B = tokens.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    P = page_tokens
    dev = tokens.device

    hoff = (torch.arange(H, dtype=torch.int32, device=dev) // G) * n_pool
    table_flat = (
        page_table.to(torch.int32).repeat_interleave(H, dim=0)
        + hoff.repeat(B)[:, None]
    ).contiguous()
    lens_flat = seq_lens.to(torch.int32).repeat_interleave(H).contiguous()
    positions = poss.long()[:, None, None]  # [..., s] with s == 1
    n_slots = caches["unit"]["b0"][0].shape[1]
    row = torch.arange(B, device=dev)
    src = torch.where(row_slot.long() < n_slots, row, torch.zeros_like(row))
    w_slot = row_slot.long()[src]
    w_pos = poss.long()[src]
    s_slot = page_src_slot.long()
    s_idx = page_src_idx.long()

    for p, (kc, vc) in _layers(cfg, params, caches):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        ap = p["attn"]
        q, k_new, v_new = blocks._qkv(ap, cfg, h)  # [B, {H,KV}, 1, hd]
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
        kc[w_slot, :, w_pos] = k_new[src, :, 0]
        vc[w_slot, :, w_pos] = v_new[src, :, 0]
        # pool view: pad seq to whole pages, gather page provenance
        _, _, max_seq, _ = kc.shape
        lp = -(-max_seq // P)
        pad = lp * P - max_seq
        kcp = torch.nn.functional.pad(kc, (0, 0, 0, pad)) if pad else kc
        vcp = torch.nn.functional.pad(vc, (0, 0, 0, pad)) if pad else vc
        kcr = kcp.reshape(n_slots, KV, lp, P, hd)
        vcr = vcp.reshape(n_slots, KV, lp, P, hd)
        k_pool = kcr[s_slot, :, s_idx]  # [n_pool, KV, P, hd]
        v_pool = vcr[s_slot, :, s_idx]
        k_pool = k_pool.transpose(0, 1).reshape(KV * n_pool, P, hd)
        v_pool = v_pool.transpose(0, 1).reshape(KV * n_pool, P, hd)
        qf = q[:, :, 0, :].reshape(B * H, hd).contiguous()
        if int8:
            k_codes, k_scales = _quantize_pool_int8(k_pool)
            v_codes, v_scales = _quantize_pool_int8(v_pool)
            out = kernel_ops.paged_decode_attention_int8(
                qf, k_codes, v_codes, k_scales, v_scales,
                table_flat, lens_flat,
            )
        else:
            out = kernel_ops.paged_decode_attention(
                qf, k_pool.contiguous(), v_pool.contiguous(),
                table_flat, lens_flat,
            )
        out = out.reshape(B, 1, H * hd)
        x = x + torch.matmul(out, ap["wo"])
        x = x + _ffn(p, cfg, x)
    return _unembed(cfg, params, x), caches
