"""granite-moe-3b-a800m — fine-grained MoE (IBM Granite 3.0 MoE family).

[hf:ibm-granite/granite-3.0-*-base]  32L d_model=1536 24H (GQA kv=8)
expert d_ff=512, vocab=49155, MoE 40 experts top-8.
"""

from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,  # every FFN sub-layer is MoE
    vocab_size=49155,
    block_pattern=(("attn", "moe"),),
    moe=MoECfg(num_experts=40, top_k=8, d_ff=512),
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0 MoE family (fine-grained)",
)
