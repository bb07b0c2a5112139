"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40 experts
top-8 with d_ff_expert 512, tied embeddings: about 3.30e9 parameters, of
which 40 × 3 × 1536 × 512 per layer are experts.  A copy of the JAX
package's config of the same name.
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49_155,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
)
