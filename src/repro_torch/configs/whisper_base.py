"""whisper-base [arXiv:2212.04356; unverified].

Encoder-decoder, 6+6 layers, d_model=512 8H d_ff=2048 vocab=51865.  The conv
frontend is a STUB: input_specs() provides precomputed frame embeddings at
the post-conv rate (seq_len // 2 encoder positions).  Shape adaptation
(DESIGN.md §4): train_4k = enc 2048 frames + dec seq 448; prefill = encoder
forward + cross-KV build; decode = decoder step against the cross-KV.
long_500k skipped (full attention).

A copy of the JAX package's config of the same name.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,            # decoder layers
    enc_layers=6,
    enc_seq_divisor=2,     # conv stub downsamples 2x
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51_865,
    frontend="audio_stub",
)
