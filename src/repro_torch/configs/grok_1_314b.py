"""grok-1-314b — coarse-grained MoE (xAI Grok-1).

[hf:xai-org/grok-1; unverified]  64L d_model=6144 48H (GQA kv=8)
expert d_ff=32768, vocab=131072, MoE 8 experts top-2.  Coarse-expert regime:
individual experts exceed one chip -> the planner assigns EP x TP over the
fast axis (paper SSII-A).
"""

from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=131072,
    block_pattern=(("attn", "moe"),),
    moe=MoECfg(num_experts=8, top_k=2, d_ff=32768),
    rope_theta=10_000.0,
    source="hf:xai-org/grok-1",
)
