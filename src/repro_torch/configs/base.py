"""Architecture + shape configuration system.

Every assigned architecture is described by an :class:`ArchConfig`; layer
stacking uses a *block program* — ``pattern × repeats + suffix`` — so that
heterogeneous stacks (gemma3's 5:1 local:global, zamba2's mamba+shared-attn)
scan over the repeating unit while staying O(1) in HLO size.

Shapes are the four assigned input-shape cells; ``applicable_shapes`` encodes
the per-family skips mandated by the assignment (see DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# ----------------------------------------------------------------- shapes
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ------------------------------------------------------------- sub-configs
@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention dims [arXiv:2405.04434]."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD dims [arXiv:2405.21060]."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


# --------------------------------------------------------- memory classes
#: how an architecture's per-request serving state grows (DESIGN.md §12):
#: ``paged_kv`` grows linearly with context (pool pages), ``constant_state``
#: is O(1) regardless of context (mamba conv+SSD state, sliding windows),
#: ``encoder_decoder`` adds a one-shot encoder-side block at prefill on top
#: of decoder KV, and ``zero_kv`` holds no serving state at all (degenerate
#: configs; useful as the zero-pool control).
MEMORY_CLASSES: Tuple[str, ...] = (
    "paged_kv",
    "constant_state",
    "encoder_decoder",
    "zero_kv",
)


# ------------------------------------------------------------- arch config
@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # default d_model // n_heads
    # block program: pattern repeated, then suffix (each entry a block type:
    # "attn" | "local_attn" | "mamba" | "shared_attn")
    block_pattern: Tuple[str, ...] = ("attn",)
    pattern_repeats: Optional[int] = None  # default n_layers / len(pattern)
    suffix_blocks: Tuple[str, ...] = ()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    sliding_window: int = 1024  # for "local_attn" blocks
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # encoder-decoder (whisper): encoder layer count; decoder = n_layers
    enc_layers: int = 0
    enc_seq_divisor: int = 1  # encoder positions = seq_len // divisor
    frontend: str = "none"  # none | audio_stub | vision_stub
    #: number of frontend patch/frame embeddings for VLM (per sample)
    vision_tokens: int = 0
    #: which of the four shape cells apply (long_500k skipped for pure
    #: full-attention archs per the assignment; see DESIGN.md §4)
    applicable_shapes: Tuple[str, ...] = (
        "train_4k",
        "prefill_32k",
        "decode_32k",
    )
    #: reduced-config overrides used by smoke tests (CPU-runnable)
    smoke_overrides: Dict[str, object] = field(default_factory=dict)

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def resolved_pattern_repeats(self) -> int:
        if self.pattern_repeats is not None:
            return self.pattern_repeats
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern {self.block_pattern}; set pattern_repeats + suffix"
        )
        return self.n_layers // len(self.block_pattern)

    def __post_init__(self) -> None:
        total = self.resolved_pattern_repeats * len(self.block_pattern) + len(
            self.suffix_blocks
        )
        if total != self.n_layers:
            raise ValueError(
                f"{self.name}: block program covers {total} layers, "
                f"config says {self.n_layers}"
            )

    # ------------------------------------------------------------- helpers
    def smoke(self) -> "ArchConfig":
        """A reduced same-family config for CPU smoke tests."""
        base = dict(
            n_layers=len(self.block_pattern) * 2 + len(self.suffix_blocks),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_ff=128,
            vocab=512,
            d_head=16,
            pattern_repeats=2,
            vision_tokens=min(self.vision_tokens, 8),
            enc_layers=2 if self.enc_layers else 0,
        )
        if self.moe is not None:
            base["moe"] = MoEConfig(
                num_experts=8,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                num_shared_experts=self.moe.num_shared_experts,
                d_ff_shared=64 if self.moe.num_shared_experts else 0,
            )
        if self.mla is not None:
            base["mla"] = MLAConfig(
                kv_lora_rank=32,
                q_lora_rank=48,
                qk_nope_head_dim=16,
                qk_rope_head_dim=8,
                v_head_dim=16,
            )
        if self.ssm is not None:
            base["ssm"] = SSMConfig(
                d_state=16, expand=2, head_dim=16, chunk_size=32
            )
        base["sliding_window"] = min(self.sliding_window, 16)
        base.update(self.smoke_overrides)
        return dataclasses.replace(self, name=f"{self.name}-smoke", **base)

    def param_count(self) -> float:
        """Analytic total parameter count (for 6·N·D roofline terms)."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = 2.0 * self.vocab * d if not self.tie_embeddings else self.vocab * d
        counts = self._block_counts()
        for blk, cnt in counts.items():
            total += cnt * self._block_params(blk)
        # final norm
        total += d
        if self.enc_layers:
            total += self.enc_layers * (
                4 * d * d + 2 * self.d_ff * d  # self-attn + mlp (enc)
            )
        return total

    def active_param_count(self) -> float:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        moe = self.moe
        dense_total = self.param_count()
        all_expert = L * moe.num_experts * 3 * d * moe.d_ff_expert
        active_expert = L * moe.top_k * 3 * d * moe.d_ff_expert
        return dense_total - all_expert + active_expert

    def _block_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for b in (
            list(self.block_pattern) * self.resolved_pattern_repeats
            + list(self.suffix_blocks)
        ):
            counts[b] = counts.get(b, 0) + 1
        return counts

    # ----------------------------------------------------- serving byte model
    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> float:
        """Marginal HBM bytes appended per decoded token — the pool-page
        growth rate the paged KV manager allocates against.

        Full-attention blocks append one K+V (or one MLA latent) per
        token; local/sliding-window blocks are bounded by the window and
        mamba blocks by their state, so both contribute 0 here (their
        bytes live in :meth:`constant_state_bytes`)."""
        counts = self._block_counts()
        per_tok = 0.0
        if self.mla is not None:
            lat = self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
            per_tok += (
                counts.get("attn", 0) + counts.get("local_attn", 0)
            ) * lat * dtype_bytes
        else:
            kv = 2 * self.n_kv_heads * self.head_dim * dtype_bytes
            per_tok += counts.get("attn", 0) * kv
            per_tok += counts.get("shared_attn", 0) * kv
        return per_tok

    def constant_state_bytes(self, dtype_bytes: int = 2) -> float:
        """Fixed per-request state bytes, independent of context length:
        mamba conv tail + SSD state (f32), and sliding-window KV rings
        for non-MLA local-attention blocks."""
        counts = self._block_counts()
        total = 0.0
        if self.ssm is not None and counts.get("mamba", 0):
            di = self.ssm.d_inner(self.d_model)
            conv = (
                (self.ssm.d_conv - 1)
                * (di + 2 * self.ssm.d_state)
                * dtype_bytes
            )
            state = (
                self.ssm.n_heads(self.d_model)
                * self.ssm.head_dim
                * self.ssm.d_state
                * 4
            )
            total += counts["mamba"] * (conv + state)
        if self.mla is None and counts.get("local_attn", 0):
            kv = 2 * self.n_kv_heads * self.head_dim * dtype_bytes
            total += counts["local_attn"] * kv * self.sliding_window
        return total

    def encoder_bytes(self, prompt_tokens: int, dtype_bytes: int = 2) -> float:
        """One-shot encoder-side bytes an encoder-decoder pays at prefill:
        cross-attention K+V over the encoder positions, per encoder layer.
        0 for decoder-only architectures."""
        if not self.enc_layers or prompt_tokens <= 0:
            return 0.0
        enc_positions = max(1, prompt_tokens // max(1, self.enc_seq_divisor))
        kv = 2 * self.n_kv_heads * self.head_dim * dtype_bytes
        return float(self.enc_layers * enc_positions * kv)

    def context_bytes(self, n_tokens: int, dtype_bytes: int = 2) -> float:
        """Total per-request serving bytes at a context of ``n_tokens`` —
        linear term + constant state + encoder side.  Monotone
        non-decreasing in ``n_tokens`` for every architecture (the smoke
        test's invariant)."""
        n = max(0, n_tokens)
        return (
            self.kv_bytes_per_token(dtype_bytes) * n
            + self.constant_state_bytes(dtype_bytes)
            + self.encoder_bytes(n, dtype_bytes)
        )

    def memory_class(self) -> str:
        """Which of :data:`MEMORY_CLASSES` this architecture belongs to.

        Encoder-decoder wins over the others (whisper also carries
        decoder KV); otherwise any linear KV growth makes it
        ``paged_kv`` (zamba2's shared-attn KV keeps the hybrid here),
        pure O(1) state is ``constant_state`` (mamba2), and a config
        with no serving state at all is ``zero_kv``."""
        if self.enc_layers:
            return "encoder_decoder"
        if self.kv_bytes_per_token() > 0:
            return "paged_kv"
        if self.constant_state_bytes() > 0:
            return "constant_state"
        return "zero_kv"

    def spec(self) -> "ModelSpec":
        """The frozen :class:`ModelSpec` serving layers key slots,
        replicas, and policy decisions by."""
        return ModelSpec.from_config(self)

    def _block_params(self, blk: str) -> float:
        d = self.d_model
        hd = self.head_dim
        if blk == "mamba":
            assert self.ssm is not None
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_heads(d)
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D
            return (
                d * (2 * di + 2 * self.ssm.d_state + nh)
                + di * d
                + self.ssm.d_conv * (di + 2 * self.ssm.d_state)
                + 2 * nh
            )
        # attention blocks
        if self.mla is not None:
            m = self.mla
            qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * qk_dim
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank
                * self.n_heads
                * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        else:
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
                self.n_heads * hd
            ) * d
        if blk == "shared_attn":
            attn += 2 * d * d  # zamba-style in/out adapters around shared block
        # MLP
        if self.moe is not None:
            moe = self.moe
            mlp = moe.num_experts * 3 * d * moe.d_ff_expert + d * moe.num_experts
            mlp += moe.num_shared_experts * 3 * d * moe.d_ff_shared
        else:
            mlp = 3 * d * self.d_ff  # gated (SwiGLU) MLP
        return attn + mlp + 2 * d  # + norms


# -------------------------------------------------------------- model spec
@dataclass(frozen=True)
class ModelSpec:
    """The serving identity of one architecture: arch id + memory class +
    the byte-model scalars every layer above configs keys decisions by
    (engine admission, pool geometry, policy scoring, cluster routing).

    Derived from :class:`ArchConfig` via :meth:`from_config` /
    :meth:`ArchConfig.spec`; hashable and frozen so it can key dicts and
    cross replica boundaries by value."""

    arch: str
    memory_class: str  # one of MEMORY_CLASSES
    kv_bytes_per_token: float
    constant_state_bytes: float
    enc_layers: int = 0
    enc_seq_divisor: int = 1

    def __post_init__(self) -> None:
        if self.memory_class not in MEMORY_CLASSES:
            raise ValueError(
                f"{self.arch}: unknown memory class "
                f"{self.memory_class!r}; expected one of {MEMORY_CLASSES}"
            )

    @classmethod
    def from_config(cls, cfg: ArchConfig) -> "ModelSpec":
        """Snapshot the config's serving-relevant byte model."""
        return cls(
            arch=cfg.name,
            memory_class=cfg.memory_class(),
            kv_bytes_per_token=cfg.kv_bytes_per_token(),
            constant_state_bytes=cfg.constant_state_bytes(),
            enc_layers=cfg.enc_layers,
            enc_seq_divisor=cfg.enc_seq_divisor,
        )

    @property
    def grows_with_context(self) -> bool:
        """True when per-request bytes scale with context length — the
        axis MURS usage-rate classification runs on.  A constant-state
        tenant's demand is flat no matter how long it decodes."""
        return self.kv_bytes_per_token > 0
