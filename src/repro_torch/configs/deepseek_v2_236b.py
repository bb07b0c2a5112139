"""deepseek-v2-236b [arXiv:2405.04434; hf].

60L d_model=5120 128H (GQA kv=128) d_ff=1536 vocab=102400;
MLA kv_lora=512 (+64 rope); MoE: 2 shared + 160 routed, top-6.
160 % 16 == 0 → expert parallelism over the model axis (10 experts/device).
MLA's latent KV cache (512+64 per token, head-count independent) is the
sub-linear serve-memory motif in the MURS classification.

A copy of the JAX package's config of the same name.
"""

from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,          # routed expert intermediate size
    vocab=102_400,
    d_head=128,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff_expert=1536,
        num_shared_experts=2,
        d_ff_shared=1536,
    ),
)
