"""gemma3-1b [hf:google/gemma-3-1b-pt; unverified].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144; 5:1 local:global
sliding-window interleave (window 512), 128k-native context.  Block program:
(local ×5, global) ×4 + (local ×2) = 26 layers.  Runs long_500k: the locals
are O(window); the globals' 512k decode KV is linear-per-token (DESIGN.md §4).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262_144,
    d_head=256,
    block_pattern=("local_attn",) * 5 + ("attn",),
    pattern_repeats=4,
    suffix_blocks=("local_attn", "local_attn"),
    sliding_window=512,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    applicable_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
