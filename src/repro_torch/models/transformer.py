"""Model assembly: init, the train-mode forward, prefill, decode.

The parameter and cache trees keep the JAX package's layout so the two
can be compared like with like: the repeated unit's leaves are stacked
``[reps, ...]`` under ``layers`` (keys ``b0``, ``b1``, ... per block of
the pattern), suffix blocks are a list, zamba2's shared attention body
is one (unstacked) ``shared_body``, and a cache is
``{"unit": {"b0": leaves}, "suffix": [...]}`` with leaves
``[reps, batch, ...]``: attention K/V ``[.., KV, max_seq, hd]`` in bf16,
MLA's latent ``[.., max_seq, rank]`` and rope key ``[.., max_seq, rope]``
in bf16, a Mamba block's conv tails ``[.., d_conv - 1, width]`` in bf16
and its SSD state ``[.., nh, hd, ds]`` in f32.  Where JAX scans over the
stacked unit, the port loops over its leading axis.

Every architecture of the JAX package runs here: stacks of ``attn`` and
``local_attn`` (sliding-window) blocks with GQA or MLA attention, each
with a dense gated MLP or a token-choice MoE FFN (with shared experts),
of ``mamba`` (Mamba-2) blocks and of ``shared_attn`` positions (zamba2's
adapters around the one shared attention body); a local block's decode
cache is an O(window) ring.  Two front ends take ``extra`` inputs as the
JAX package's do: a vision stub (internvl2) projects ``patch_embeds``
and places them before the tokens, and an encoder-decoder (whisper) runs
its encoder over ``frame_embeds`` and cross-attends every decoder block
to K/V built once from the encoder output, carried in the caches as
``cross_kv``.

Train mode (:func:`forward`, :func:`forward_hidden`,
:func:`backbone_forward`) is the JAX package's: every block through
:func:`_apply_block_full`, whose residual stream leaves through
``bf16_grad``; each repeat of the unit recomputed in the backward under
``torch.utils.checkpoint`` (``remat=True``, JAX's ``jax.checkpoint``) or
keeping its projections (``remat="dots"``); the f32 unembedding.
:func:`prefill` runs the same blocks, so the block code exists once.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch.utils import checkpoint as _ckpt

from .. import obs
from ..configs.base import ArchConfig
from ..dist.sharding import (gather_fsdp, is_dtensor, local_block,
                              merge_heads, on_shards, shard, split_heads)
from ..kernels import ops as kernel_ops
from ..tree import tree_leaves, tree_map
from . import blocks
from .layers import (
    apply_mlp,
    apply_rope,
    bf16_grad,
    chunked_attention,
    dense_init,
    embed_init,
    init_mlp,
    rms_norm,
)

PyTree = Any


#: the block types of the JAX package's block programs
BLOCK_TYPES = ("attn", "local_attn", "mamba", "shared_attn")


def _check_stack(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` on a block program no architecture has: an
    empty stack, an unknown block type, or Mamba blocks without SSM
    dimensions (or SSM dimensions without Mamba blocks)."""
    stack = list(cfg.block_pattern) + list(cfg.suffix_blocks)
    if (
        not stack
        or any(bt not in BLOCK_TYPES for bt in stack)
        or ("mamba" in stack) != (cfg.ssm is not None)
    ):
        raise ValueError(
            f"{cfg.name}: block program {stack} with ssm={cfg.ssm!r}: "
            f"blocks must be of {BLOCK_TYPES}, and 'mamba' blocks come "
            "with SSM dimensions"
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
def _init_block(gen, cfg: ArchConfig, btype: str, dtype, device) -> dict:
    p = {"ln1": torch.zeros(cfg.d_model, dtype=dtype, device=device)}
    if btype == "mamba":
        p["mamba"] = blocks.init_mamba(gen, cfg, dtype, device)
        return p
    if btype == "shared_attn":
        # adapters only; the shared body lives once at the model level
        p["in_adapter"] = dense_init(gen, cfg.d_model, cfg.d_model, dtype,
                                     device)
        p["out_adapter"] = dense_init(gen, cfg.d_model, cfg.d_model, dtype,
                                      device)
        return p
    if cfg.mla is not None:
        p["attn"] = blocks.init_mla(gen, cfg, dtype, device)
    else:
        p["attn"] = blocks.init_attention(gen, cfg, dtype, device)
    p["ln2"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
    if cfg.moe is None:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
        return p
    p["moe"] = blocks.init_moe(gen, cfg, dtype, device)
    if cfg.moe.num_shared_experts:
        p["shared_mlp"] = init_mlp(
            gen, cfg.d_model,
            cfg.moe.num_shared_experts * cfg.moe.d_ff_shared, dtype, device,
        )
    return p


def _init_shared_body(gen, cfg: ArchConfig, dtype, device) -> dict:
    """zamba2's shared transformer body (attention + MLP), one copy."""
    return {
        "ln1": torch.zeros(cfg.d_model, dtype=dtype, device=device),
        "attn": blocks.init_attention(gen, cfg, dtype, device),
        "ln2": torch.zeros(cfg.d_model, dtype=dtype, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _init_encoder(gen, cfg: ArchConfig, dtype, device) -> dict:
    """whisper's encoder: ``enc_layers`` non-causal attention + MLP
    layers, stacked, and a final norm."""
    def layer():
        return {
            "ln1": torch.zeros(cfg.d_model, dtype=dtype, device=device),
            "attn": blocks.init_attention(gen, cfg, dtype, device),
            "ln2": torch.zeros(cfg.d_model, dtype=dtype, device=device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
        }

    return {
        "layers": _stacked(layer, cfg.enc_layers),
        "final_ln": torch.zeros(cfg.d_model, dtype=dtype, device=device),
    }


def _stacked(make, reps: int) -> PyTree:
    """``reps`` trees from ``make()``, in call order, stacked on a new
    leading axis.  Each tree is copied into the stack as soon as it is
    made and freed before the next is made, so the peak is the stack and
    one tree (internvl2's 48 layers are 37 GB of bf16: a list of them and
    their stack would not fit one card)."""
    tree = make()
    out = tree_map(lambda t: torch.empty((reps,) + t.shape, dtype=t.dtype,
                                         device=t.device), tree)
    for r in range(reps):
        if tree is None:
            tree = make()
        for o, t in zip(tree_leaves(out), tree_leaves(tree)):
            o[r].copy_(t)
        tree = t = None
    return out


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
    _check_stack(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    reps = cfg.resolved_pattern_repeats
    params: Dict[str, Any] = {
        "embed": {"tokens": embed_init(gen, cfg.vocab, cfg.d_model, dtype, dev)},
        "layers": _stacked(lambda: {
            f"b{i}": _init_block(gen, cfg, bt, dtype, dev)
            for i, bt in enumerate(cfg.block_pattern)
        }, reps),
        "suffix": [
            _init_block(gen, cfg, bt, dtype, dev) for bt in cfg.suffix_blocks
        ],
        "final_ln": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            gen, cfg.d_model, cfg.vocab, dtype, dev
        )
    if "shared_attn" in tuple(cfg.block_pattern) + tuple(cfg.suffix_blocks):
        params["shared_body"] = _init_shared_body(gen, cfg, dtype, dev)
    if cfg.frontend == "vision_stub":
        params["vision_proj"] = dense_init(gen, cfg.d_model, cfg.d_model,
                                           dtype, dev)
    if cfg.enc_layers:
        params["encoder"] = _init_encoder(gen, cfg, dtype, dev)
        params["audio_proj"] = dense_init(gen, cfg.d_model, cfg.d_model,
                                          dtype, dev)
        # cross-attention weights per decoder block of the unit
        params["cross"] = _stacked(lambda: {
            f"b{i}": {
                "ln_x": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
                "attn": blocks.init_attention(gen, cfg, dtype, dev),
            }
            for i in range(len(cfg.block_pattern))
        }, reps)
    return params


def init_cache(
    cfg: ArchConfig,
    batch: int,
    max_seq: int,
    *,
    device: Union[str, torch.device] = "cuda",
) -> PyTree:
    """Zeroed decode caches: {unit: {b<i>: leaves}, suffix: [...]} —
    attention (k, v) in bf16, MLA's (latent, rope key) in bf16; a Mamba
    block's three bf16 conv tails and its f32 SSD state.  An
    encoder-decoder's ``cross_kv`` is not here: ``prefill`` builds it."""
    _check_stack(cfg)
    dev = resolve_device(device)
    reps = cfg.resolved_pattern_repeats

    def block(btype, lead=()):
        bf16 = dict(dtype=torch.bfloat16, device=dev)
        if btype == "mamba":
            ssm = cfg.ssm
            tail = ssm.d_conv - 1
            return (
                torch.zeros(lead + (batch, tail, ssm.d_inner(cfg.d_model)),
                            **bf16),
                torch.zeros(lead + (batch, tail, ssm.d_state), **bf16),
                torch.zeros(lead + (batch, tail, ssm.d_state), **bf16),
                torch.zeros(
                    lead + (batch, ssm.n_heads(cfg.d_model), ssm.head_dim,
                            ssm.d_state),
                    dtype=torch.float32, device=dev,
                ),
            )
        if cfg.mla is not None and btype in ("attn", "local_attn"):
            m = cfg.mla
            return (
                torch.zeros(lead + (batch, max_seq, m.kv_lora_rank), **bf16),
                torch.zeros(lead + (batch, max_seq, m.qk_rope_head_dim),
                            **bf16),
            )
        # sliding-window layers keep an O(window) RING buffer, not O(seq)
        seq = _cache_len(cfg, btype, max_seq)
        shape = lead + (batch, cfg.n_kv_heads, seq, cfg.head_dim)
        return tuple(torch.zeros(shape, **bf16) for _ in range(2))

    return {
        "unit": {
            f"b{i}": block(bt, (reps,))
            for i, bt in enumerate(cfg.block_pattern)
        },
        "suffix": [block(bt) for bt in cfg.suffix_blocks],
    }


def _window(cfg: ArchConfig, btype: str) -> Optional[int]:
    return cfg.sliding_window if btype == "local_attn" else None


def _cache_len(cfg: ArchConfig, btype: str, max_seq: int) -> int:
    """Cache slots of one block: ``max_seq``, or the ring's
    ``min(max_seq, window)`` for a sliding-window block."""
    window = _window(cfg, btype)
    return max_seq if window is None else min(max_seq, window)


def _layers(cfg: ArchConfig, params, caches=None) -> Iterator[Tuple]:
    """(block type, block params, block cache, cross-attention params) in
    execution order: the unit's blocks once per repeat (their leaves
    indexed at the repeat), then the suffix.  Cache leaves are views, so
    writes land in ``caches``.  The cross-attention params (whisper's
    decoder) are those of the unit block at that repeat, None elsewhere,
    as the JAX package cross-attends only in its scanned unit."""
    cross = params.get("cross")
    for r in range(cfg.resolved_pattern_repeats):
        for i, btype in enumerate(cfg.block_pattern):
            key = f"b{i}"
            p = _index(params["layers"][key], r)
            c = None
            if caches is not None:
                c = tuple(leaf[r] for leaf in caches["unit"][key])
            pc = None if cross is None else _index(cross[key], r)
            yield btype, gather_fsdp(p), c, gather_fsdp(pc)
    for j, (btype, p) in enumerate(zip(cfg.suffix_blocks, params["suffix"])):
        c = caches["suffix"][j] if caches is not None else None
        yield btype, gather_fsdp(p), c, None


def _index(tree: PyTree, r: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


# ----------------------------------------------------------------- forward
def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    table = gather_fsdp(params["embed"]["tokens"])
    if is_dtensor(table):
        x = _embed_local(table, tokens.long())
    else:
        x = table[tokens.long()]
    return shard(x, ("batch", "seq", "embed"))


def _embed_local(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup in a DTensor table, on each device's shards: the rows
    of its tokens' batch split; where the vocabulary is split across
    devices, each looks up the tokens in its rows (zeros for the others)
    and the sum over the split is pending (``Partial``) until the
    caller's pin: an all-reduce of the activations, not a gather of the
    table."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    first, _ = local_block(mesh, table.placements, 0, table.shape[0])

    def lookup(tab, tok):
        idx = tok - first
        here = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(here[..., None], rows, 0.0).to(tab.dtype)

    tok_pl = [p if p == Shard(0) and table.placements[i] != Shard(0)
              else Replicate() for i, p in enumerate(tokens.placements)]
    out_pl = [Partial() if table.placements[i] == Shard(0) else p
              for i, p in enumerate(tok_pl)]
    shape = tuple(tokens.shape) + (table.shape[1],)
    return on_shards(lookup, (table, tokens), (table.placements, tok_pl),
                     mesh, (out_pl,), (shape,))


def _unembed(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the f32 logits [B, S, V]."""
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = torch.matmul(x.float(), unembed_weight(cfg, params).float())
    return shard(logits, ("batch", "seq", "vocab"))


def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y``, ``y`` (a block's output projection, whose sum over the
    model axis is pending in a step on DTensors) pinned first to the
    residual's layout: the all-reduce of a row-parallel product lands
    there, as XLA places it, not in the next block's norm."""
    return x + shard(y, ("batch", "seq", "embed"))


def _ffn(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
         per_row: bool = False) -> torch.Tensor:
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" not in p:
        return apply_mlp(p["mlp"], h)
    y = blocks.moe_forward(p["moe"], cfg, h, per_row=per_row)
    if "shared_mlp" in p:
        y = y + apply_mlp(p["shared_mlp"], h)
    return y


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum``
    computes a mixed-dtype product."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def _extra(cfg: ArchConfig, extra: Optional[Dict[str, torch.Tensor]],
           key: str) -> torch.Tensor:
    if not extra or key not in extra:
        raise ValueError(
            f"{cfg.name}: prefill needs extra[{key!r}] (its "
            f"{'vision' if key == 'patch_embeds' else 'audio'} front end's "
            "embeddings)"
        )
    return extra[key]


def encoder_forward(cfg: ArchConfig, params, frames: torch.Tensor, *,
                    remat: Union[bool, str] = True) -> torch.Tensor:
    """whisper's encoder over (stub) frame embeddings [B, T, d]: the
    audio projection, then non-causal attention (K3 on the card) and the
    MLP per layer, then the final norm.  With ``remat`` and a gradient
    to record, each layer is recomputed in the backward, as the JAX
    package checkpoints its scanned layer."""
    enc = params["encoder"]
    x = _project(frames, params["audio_proj"]).to(params["audio_proj"].dtype)
    x = shard(x, ("batch", "seq", "embed"))

    def layer(h, p):
        p = gather_fsdp(p)
        h = _residual(h, blocks.attention_forward(
            p["attn"], cfg, rms_norm(h, p["ln1"], cfg.norm_eps), causal=False
        ))
        return _residual(h, apply_mlp(p["mlp"],
                                      rms_norm(h, p["ln2"], cfg.norm_eps)))

    for r in range(cfg.enc_layers):
        x = _remat_call(remat, layer, x, _index(enc["layers"], r))
    return rms_norm(x, enc["final_ln"], cfg.norm_eps)


def _encode_cross_kv(cfg: ArchConfig, params, enc_out: torch.Tensor):
    """Cross-attention K/V [B, KV, T, hd] from the encoder output, with
    the FIRST decoder block's ``wk``/``wv``: as in the JAX package, one
    K/V serves every decoder layer."""
    pc = gather_fsdp(_index(params["cross"]["b0"], 0))
    axes = ("batch", "kv_heads", "seq", None)
    k = split_heads(torch.matmul(enc_out, pc["attn"]["wk"]), cfg.n_kv_heads,
                    axes)
    v = split_heads(torch.matmul(enc_out, pc["attn"]["wv"]), cfg.n_kv_heads,
                    axes)
    return k, v


def _cross_attend(pc: dict, cfg: ArchConfig, x: torch.Tensor,
                  ctx_kv) -> torch.Tensor:
    """whisper's decoder cross-attention: the block's own ``wq``/``wo``
    over the shared encoder K/V, non-causal through K3 (at Sq = 1 in a
    decode step), added to the residual."""
    k, v = ctx_kv
    h = rms_norm(x, pc["ln_x"], cfg.norm_eps)
    q = split_heads(torch.matmul(h, pc["attn"]["wq"]), cfg.n_heads,
                    ("batch", "heads", "seq", None))
    out = chunked_attention(q, k, v, causal=False)
    return _residual(x, torch.matmul(merge_heads(out, blocks._HEADS),
                                     pc["attn"]["wo"]))


# --------------------------------------------------- full-sequence blocks
def _apply_block_full(
    p: dict,
    cfg: ArchConfig,
    btype: str,
    x: torch.Tensor,
    *,
    shared_body: Optional[dict],
    q_offset: int = 0,
    causal: bool = True,
    want_cache: bool,
):
    """One block over a whole sequence (train / prefill), as the JAX
    package's ``_apply_block_full``: returns (x, the block's cache or
    None).  The residual stream leaves every block through
    :func:`bf16_grad`, at the JAX package's boundaries."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    cache = None
    if btype == "mamba":
        if want_cache:
            y, cache = blocks.mamba_forward(p["mamba"], cfg, h,
                                            return_cache=True)
        else:
            y = blocks.mamba_forward(p["mamba"], cfg, h)
        x = _residual(x, y)
    elif btype == "shared_attn":
        x, cache = _shared_attn_full(p, cfg, shared_body, x, h,
                                     q_offset=q_offset, causal=causal)
    else:
        if cfg.mla is not None:
            out = blocks.mla_forward(p["attn"], cfg, h, q_offset=q_offset,
                                     return_cache=want_cache)
        else:
            out = blocks.attention_forward(
                p["attn"], cfg, h, window=_window(cfg, btype),
                causal=causal, q_offset=q_offset, return_cache=want_cache,
            )
        a, cache = out if want_cache else (out, None)
        x = _residual(x, a)
        x = _residual(x, _ffn(p, cfg, x))
    x = shard(bf16_grad(x), ("batch", "seq", "embed"))
    return x, (cache if want_cache else None)


def _dots_saved(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the plain matrix products
    (the projections, ``aten.mm``: a product without batch dimensions, as
    JAX's ``dots_with_no_batch_dims_saveable`` keeps) and recompute the
    rest, the attention and expert kernels included."""
    if op is torch.ops.aten.mm.default:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class _Recompute:
    """A checkpoint's recompute context: ``inner`` (selective
    checkpointing's, or none) and, where the forward ran inside
    ``ops.plain_on_card``, that again — on the card the recompute runs on
    autograd's device thread, which does not see the forward's context.
    Entered once per backward, any number of times."""

    def __init__(self, inner, plain: bool) -> None:
        self.inner, self.plain = inner, plain
        self._stack = None

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self.inner)
        if self.plain:
            self._stack.enter_context(kernel_ops.plain_on_card())

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)


def _remat_call(remat: Union[bool, str], fn, *args):
    """``fn(*args)``, recomputed in the backward where there is one to
    record and ``remat`` asks: ``True`` keeps only the inputs (JAX's
    ``jax.checkpoint``), ``"dots"`` keeps the projections' outputs too.
    The recompute takes the forward's kernel dispatch (:class:`_Recompute`).
    Under no grad mode (serving) it is a plain call."""
    if not remat or not torch.is_grad_enabled():
        return fn(*args)
    plain = kernel_ops.plain_active()

    def contexts():
        if remat == "dots":
            fwd, rec = _ckpt.create_selective_checkpoint_contexts(_dots_saved)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _Recompute(rec, plain)

    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=contexts)


def _block_types(cfg: ArchConfig) -> List[str]:
    """Every block's type in execution order (that of :func:`_layers`)."""
    return (list(cfg.block_pattern) * cfg.resolved_pattern_repeats
            + list(cfg.suffix_blocks))


def backbone_forward(
    cfg: ArchConfig,
    params,
    x: torch.Tensor,
    *,
    q_offset: int = 0,
    causal: bool = True,
    want_cache: bool = False,
    remat: Union[bool, str] = True,
    cross_ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """The block program over embeddings ``x`` [B, S, d]; returns (x,
    caches): with ``want_cache`` one cache per block in execution order
    (what :func:`prefill` pads and stacks), else None.

    Where JAX scans the stacked unit under ``jax.checkpoint``, this loops
    over its repeats and, with ``remat`` and a gradient to record, runs
    each repeat of the unit (its blocks and whisper's cross-attention)
    under ``torch.utils.checkpoint``: the backward recomputes one unit at
    a time, so the forward's attention kernels run twice per step.  The
    suffix blocks run once, unrolled and not recomputed, as in JAX."""
    shared_body = params.get("shared_body")
    pattern = cfg.block_pattern
    cross = params.get("cross")
    caches: List[Any] = []

    def unit_fn(h, unit_p, unit_cross, r):
        # the unit's weights gathered at use, again in the recompute
        unit_p, unit_cross = gather_fsdp((unit_p, unit_cross))
        outs = []
        for i, bt in enumerate(pattern):
            with obs.span("model.layer", index=r * len(pattern) + i):
                h, c = _apply_block_full(
                    unit_p[f"b{i}"], cfg, bt, h, shared_body=shared_body,
                    q_offset=q_offset, causal=causal, want_cache=want_cache,
                )
                if cross_ctx is not None:
                    h = _cross_attend(unit_cross[f"b{i}"], cfg, h, cross_ctx)
            outs.append(c)
        return (h, outs) if want_cache else h

    reps = cfg.resolved_pattern_repeats
    with obs.span("model.forward", entry="backbone"):
        for r in range(reps):
            unit_p = _index(params["layers"], r)
            unit_cross = None
            if cross_ctx is not None:
                unit_cross = _index(cross, r)
            if want_cache:
                x, outs = unit_fn(x, unit_p, unit_cross, r)
                caches.extend(outs)
            else:
                x = _remat_call(remat, unit_fn, x, unit_p, unit_cross, r)
        for j, (p_blk, bt) in enumerate(zip(params["suffix"],
                                            cfg.suffix_blocks)):
            with obs.span("model.layer", index=reps * len(pattern) + j):
                x, c = _apply_block_full(
                    gather_fsdp(p_blk), cfg, bt, x, shared_body=shared_body,
                    q_offset=q_offset, causal=causal, want_cache=want_cache,
                )
            caches.append(c)
    return x, (caches if want_cache else None)


def _front(cfg: ArchConfig, params, tokens: torch.Tensor,
           extra: Optional[Dict[str, torch.Tensor]],
           remat: Union[bool, str]):
    """The embedded tokens, with a vision stub's projected patches placed
    before them, and an encoder-decoder's cross-attention K/V (else
    None)."""
    x = _embed(params, tokens)
    cross_kv = None
    if cfg.frontend == "vision_stub":
        vis = _project(_extra(cfg, extra, "patch_embeds"),
                       params["vision_proj"]).to(x.dtype)
        x = shard(torch.cat([vis, x], dim=1), ("batch", "seq", "embed"))
    if cfg.enc_layers:
        enc_out = encoder_forward(cfg, params,
                                  _extra(cfg, extra, "frame_embeds"),
                                  remat=remat)
        cross_kv = _encode_cross_kv(cfg, params, enc_out)
    return x, cross_kv


def forward_hidden(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    *,
    extra: Optional[Dict[str, torch.Tensor]] = None,
    remat: Union[bool, str] = True,
) -> torch.Tensor:
    """Train-mode forward up to the final norm (no unembedding):
    [B, S(+vision), d]."""
    _check_stack(cfg)
    x, cross_kv = _front(cfg, params, tokens, extra, remat)
    x, _ = backbone_forward(cfg, params, x, remat=remat, cross_ctx=cross_kv)
    return rms_norm(x, params["final_ln"], cfg.norm_eps)


def unembed_weight(cfg: ArchConfig, params) -> torch.Tensor:
    """[d, V]: the tied embedding's transpose, or ``lm_head``."""
    return gather_fsdp(params["embed"]["tokens"].t() if cfg.tie_embeddings
                       else params["lm_head"])


def forward(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    *,
    extra: Optional[Dict[str, torch.Tensor]] = None,
    remat: Union[bool, str] = True,
) -> torch.Tensor:
    """Train-mode forward → f32 logits [B, S(+vision), vocab]."""
    x = forward_hidden(cfg, params, tokens, extra=extra, remat=remat)
    logits = torch.matmul(x.float(), unembed_weight(cfg, params).float())
    return shard(logits, ("batch", "seq", "vocab"))


def prefill(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, S]
    *,
    extra: Optional[Dict[str, torch.Tensor]] = None,
    max_seq: Optional[int] = None,
):
    """Forward over the prompt; returns (last-position logits [B, 1, V],
    caches with the seq axis padded to ``max_seq``).

    A vision-stub model (internvl2) takes ``extra["patch_embeds"]``
    [B, N, d], projected and placed before the tokens, so the caches
    hold N + S positions; an encoder-decoder (whisper) takes
    ``extra["frame_embeds"]`` [B, T, d], and its caches carry the
    cross-attention K/V as ``cross_kv`` for :func:`decode_step`.  The
    blocks are :func:`backbone_forward`'s, as in the JAX package."""
    with obs.span("model.forward", entry="prefill"):
        _check_stack(cfg)
        x, cross_kv = _front(cfg, params, tokens, extra, remat=False)
        s = x.shape[1]
        max_seq = max_seq or s
        x, layer_caches = backbone_forward(cfg, params, x, want_cache=True,
                                           cross_ctx=cross_kv)
        kvs = []
        for btype, cache in zip(_block_types(cfg), layer_caches):
            if btype != "mamba":
                # conv tails and state have no seq axis: no padding.  The
                # seq axis is -2 of K/V [B, KV, S, hd] and of MLA's [B, S, *]
                window = _window(cfg, btype)
                ring = window is not None and cfg.mla is None
                seq = _cache_len(cfg, btype, max_seq) if ring else max_seq
                if ring and s > seq:
                    cache = tuple(_to_ring(c, window) for c in cache)
                elif seq > s:
                    cache = tuple(
                        torch.nn.functional.pad(c, (0, 0, 0, seq - s))
                        for c in cache)
            kvs.append(cache)
        logits = _unembed(cfg, params, x[:, -1:])
        caches = _caches_from_layers(cfg, kvs)
        if cross_kv is not None:
            caches["cross_kv"] = cross_kv
        return logits, caches


def _shared_attn_full(p: dict, cfg: ArchConfig, body: dict,
                      x: torch.Tensor, h: torch.Tensor, *,
                      q_offset: int = 0, causal: bool = True):
    """zamba2's shared attention position over a sequence: the in
    adapter, the shared body (attention through K3 on the card, then its
    MLP), the out adapter added to the residual ``x``; returns (x, the
    body's K/V)."""
    body = gather_fsdp(body)
    inner = torch.matmul(h, p["in_adapter"])
    g = rms_norm(inner, body["ln1"], cfg.norm_eps)
    a, kv = blocks.attention_forward(body["attn"], cfg, g, q_offset=q_offset,
                                     causal=causal, return_cache=True)
    inner = _residual(inner, a)
    inner = _residual(inner, apply_mlp(
        body["mlp"], rms_norm(inner, body["ln2"], cfg.norm_eps)))
    return _residual(x, torch.matmul(inner, p["out_adapter"])), kv


def _to_ring(x: torch.Tensor, window: int) -> torch.Tensor:
    """Fold a prefill K/V [B, KV, S, hd] with S > window into the ring
    layout: slot j holds the last position p < S with p % window == j."""
    s = x.shape[2]
    j = torch.arange(window, device=x.device)
    return x[:, :, (s - 1) - ((s - 1 - j) % window)]


def _caches_from_layers(cfg: ArchConfig, kvs: List[Tuple]) -> PyTree:
    n_pat = len(cfg.block_pattern)
    reps = cfg.resolved_pattern_repeats
    unit = {}
    for i in range(n_pat):
        per_rep = [kvs[r * n_pat + i] for r in range(reps)]
        unit[f"b{i}"] = tuple(
            torch.stack([c[j] for c in per_rep])
            for j in range(len(per_rep[0]))
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
    per_row: bool = True,
):
    """One decode step; returns (logits [B, 1, V], caches).

    The caches are updated in place (and returned): the new token's K/V
    (or MLA latent and rope key) land at ``pos`` of each row, and a Mamba
    block's conv tails and state advance, in every row or only in
    ``rows`` when given.  With ``cross_kv`` in the caches (whisper) every
    decoder block of the unit cross-attends to it.  An MoE FFN dispatches
    each row as its own capacity group, as the JAX engine's per-slot
    vmapped step does (this is the engine's dense and continuation
    step), so rows never take capacity from one another; with
    ``per_row=False`` it dispatches the batch as one group, as
    ``repro.models.decode_step`` on a batch and :func:`decode_step_paged`
    do (the dry-run's decode step).
    """
    _check_stack(cfg)
    with obs.span("model.forward", entry="decode_step"):
        x = _embed(params, tokens)
        cross_kv = caches.get("cross_kv")
        layers = _layers(cfg, params, caches)
        for index, (btype, p, cache, pc) in enumerate(layers):
            with obs.span("model.layer", index=index):
                h = rms_norm(x, p["ln1"], cfg.norm_eps)
                if btype == "mamba":
                    y, _ = blocks.mamba_decode(p["mamba"], cfg, h, cache,
                                               pos, rows=rows)
                    x = _residual(x, y)
                elif btype == "shared_attn":
                    body = gather_fsdp(params["shared_body"])
                    inner = torch.matmul(h, p["in_adapter"])
                    g = rms_norm(inner, body["ln1"], cfg.norm_eps)
                    a, _ = blocks.attention_decode(body["attn"], cfg, g,
                                                   cache, pos, rows=rows)
                    inner = _residual(inner, a)
                    inner = _residual(inner, apply_mlp(
                        body["mlp"],
                        rms_norm(inner, body["ln2"], cfg.norm_eps)))
                    x = _residual(x, torch.matmul(inner, p["out_adapter"]))
                else:
                    if cfg.mla is not None:
                        a, _ = blocks.mla_decode(p["attn"], cfg, h, cache,
                                                 pos, rows=rows)
                    else:
                        a, _ = blocks.attention_decode(
                            p["attn"], cfg, h, cache, pos,
                            window=_window(cfg, btype), rows=rows,
                        )
                    x = _residual(x, a)
                    x = _residual(x, _ffn(p, cfg, x, per_row=per_row))
                if cross_kv is not None and pc is not None:
                    x = _cross_attend(pc, cfg, x, cross_kv)
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

    — so the whole batch is one [B·H, W] kernel call, whose G = H / KV
    adjacent rows of one kv head share a table and length row (the
    kernel's ``q_per_kv``: it loads their pages once).  With ``int8`` the
    pool views are quantized per page and K2 runs instead of K1.

    Pad rows carry ``row_slot == n_slots``; the JAX package drops their
    out-of-bounds write.  Torch indexing raises on that index, so pad rows
    repeat row 0's write instead (row 0 is always a real row): duplicate
    writes of one value leave the cache exactly as the real write alone,
    with no device→host read to find the real rows.  An MoE FFN
    dispatches the whole padded batch as one capacity group, pad rows
    (token 0, last) included, exactly as the JAX package does.
    Returns (logits [B, 1, V], caches).
    """
    _check_stack(cfg)
    if not paged_decode_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the paged path serves stacks of full-attention "
            "blocks only (paged_decode_supported)"
        )
    with obs.span("model.forward", entry="decode_step_paged"):
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
        src = torch.where(row_slot.long() < n_slots, row,
                          torch.zeros_like(row))
        w_slot = row_slot.long()[src]
        w_pos = poss.long()[src]
        s_slot = page_src_slot.long()
        s_idx = page_src_idx.long()

        layers = _layers(cfg, params, caches)
        for index, (_, p, (kc, vc), _) in enumerate(layers):
            with obs.span("model.layer", index=index):
                h = rms_norm(x, p["ln1"], cfg.norm_eps)
                ap = p["attn"]
                # [B, {H,KV}, 1, hd]
                q, k_new, v_new = blocks._qkv(ap, cfg, h)
                q = apply_rope(q, positions, cfg.rope_theta)
                k_new = apply_rope(k_new, positions, cfg.rope_theta)
                kc[w_slot, :, w_pos] = k_new[src, :, 0]
                vc[w_slot, :, w_pos] = v_new[src, :, 0]
                with obs.span("model.pool_gather"):
                    # pool view: pad seq to whole pages, gather page
                    # provenance
                    _, _, max_seq, _ = kc.shape
                    lp = -(-max_seq // P)
                    pad = lp * P - max_seq
                    kcp = (torch.nn.functional.pad(kc, (0, 0, 0, pad))
                           if pad else kc)
                    vcp = (torch.nn.functional.pad(vc, (0, 0, 0, pad))
                           if pad else vc)
                    kcr = kcp.reshape(n_slots, KV, lp, P, hd)
                    vcr = vcp.reshape(n_slots, KV, lp, P, hd)
                    k_pool = kcr[s_slot, :, s_idx]  # [n_pool, KV, P, hd]
                    v_pool = vcr[s_slot, :, s_idx]
                    k_pool = k_pool.transpose(0, 1).reshape(
                        KV * n_pool, P, hd).contiguous()
                    v_pool = v_pool.transpose(0, 1).reshape(
                        KV * n_pool, P, hd).contiguous()
                qf = q[:, :, 0, :].reshape(B * H, hd).contiguous()
                if int8:
                    k_codes, k_scales = _quantize_pool_int8(k_pool)
                    v_codes, v_scales = _quantize_pool_int8(v_pool)
                    out = kernel_ops.paged_decode_attention_int8(
                        qf, k_codes, v_codes, k_scales, v_scales,
                        table_flat, lens_flat, q_per_kv=G,
                    )
                else:
                    out = kernel_ops.paged_decode_attention(
                        qf, k_pool, v_pool, table_flat, lens_flat,
                        q_per_kv=G,
                    )
                out = out.reshape(B, 1, H * hd)
                x = x + torch.matmul(out, ap["wo"])
                x = x + _ffn(p, cfg, x)
        return _unembed(cfg, params, x), caches
