"""musicgen-large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (GQA kv=32 i.e. MHA)
d_ff=8192, vocab=2048 (EnCodec codebook).  Backbone only: the EnCodec
frontend is a stub — a batch carries precomputed frame embeddings
(``"embeds"``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=(("attn", "dense"),),
    rope_type="none",  # musicgen uses learned/sinusoidal pos; stubbed as none
    frontend="audio_frames",
    source="arXiv:2306.05284 (MusicGen)",
)
