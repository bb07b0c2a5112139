"""internvl2-26b [arXiv:2404.16821; hf].

InternViT-6B + InternLM2-20B backbone; this entry specifies the language
BACKBONE (48L d_model=6144 48H GQA kv=8 d_ff=16384 vocab=92553).  The vision
frontend is a STUB: input_specs() provides precomputed patch embeddings
(256 tokens/image tile after pixel-shuffle) that are concatenated with the
token embeddings.

A copy of the JAX package's config of the same name.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab=92_553,
    frontend="vision_stub",
    vision_tokens=256,
)
