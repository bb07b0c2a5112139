"""mamba2-2.7b [arXiv:2405.21060; unverified].

64L d_model=2560, attention-free SSD (state-space duality), d_state=128.
Decode state is CONSTANT-size — the constant-model arch in the MURS
classification; long_500k applies (sub-quadratic by construction).
A copy of the JAX package's config of the same name.
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    block_pattern=("mamba",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    applicable_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
