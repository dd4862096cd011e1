"""qwen2-vl-7b — VLM backbone (dense) with M-RoPE.

[arXiv:2409.12191; hf]  28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064.  Backbone only: the dynamic-resolution ViT frontend is a stub —
a batch carries precomputed patch embeddings (``"embeds"``).  M-RoPE (temporal /
height / width split of rotary dims) is implemented in models/layers.py.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=(("attn", "dense"),),
    rope_type="mrope",
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    source="arXiv:2409.12191 (Qwen2-VL)",
)
