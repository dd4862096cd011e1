"""gemma2-9b — dense LM with alternating local/global attention + softcaps.

[arXiv:2408.00118; hf]  42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, head_dim=256, sliding window 4096 on local layers,
attention-logit softcap 50, final-logit softcap 30.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    block_pattern=(("attn_local", "dense"), ("attn", "dense")),
    rope_theta=10_000.0,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    scale_embeddings=True,
    source="arXiv:2408.00118 (Gemma 2)",
)
