"""jamba-1.5-large-398b — hybrid Mamba + attention MoE.

[arXiv:2403.19887]  72L d_model=8192 64H (GQA kv=8) d_ff=24576,
vocab=65536, MoE 16 experts top-2.  The period-8 block: attention at 1 of
every 8 mixers (1:7 interleave), MoE in place of the dense FFN on every
other layer.  The SSM mixers take the Mamba2 (SSD) form shared with
mamba2-370m.  Far beyond one card at full size: the port runs its
``reduced()`` form.
"""

from repro_torch.configs.base import ArchConfig, MoECfg, SSMCfg

# Period-8 block: mixers m m m m a m m m; MoE on the odd layers.
_PATTERN = (
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("attn", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=_PATTERN,
    moe=MoECfg(num_experts=16, top_k=2, d_ff=24576),
    ssm=SSMCfg(state_size=128, head_dim=64, expand=2, conv_width=4),
    rope_type="none",  # no positional encoding: the Mamba layers carry position
    subquadratic=True,
    source="arXiv:2403.19887 (Jamba) + 1.5-large sizing",
)
