"""smollm-360m — small dense llama-architecture LM.

[hf:HuggingFaceTB/SmolLM-360M; hf]  32L d_model=960 15H (GQA kv=5)
d_ff=2560, vocab=49152.  15 heads do not divide any power-of-two mesh axis —
exercises the head-divisibility-free expert-data-parallel attention path.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    block_pattern=(("attn", "dense"),),
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)
