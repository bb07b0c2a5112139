"""zamba2-1.2b [arXiv:2411.15242; hf].

38 blocks, d_model=2048: Mamba2 backbone (d_state=64) with a SHARED
full-attention block invoked every 6th position (32H kv=32, d_ff=8192 MLP in
the shared block).  Block program: (mamba ×5, shared_attn) ×6 + mamba ×2.
Hybrid: runs long_500k (mamba decode state constant; shared-attn KV linear).
A copy of the JAX package's config of the same name.
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_000,
    d_head=64,
    block_pattern=("mamba",) * 5 + ("shared_attn",),
    pattern_repeats=6,
    suffix_blocks=("mamba", "mamba"),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    applicable_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
