"""mamba2-370m — attention-free SSM (state-space duality).

[arXiv:2405.21060]  48L d_model=1024, no attention, no FFN (d_ff=0),
vocab=50280, ssm_state=128, 32 heads x 64.
"""

from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,  # unused (attention-free); kept for config uniformity
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    block_pattern=(("mamba", "none"),),
    ssm=SSMCfg(state_size=128, head_dim=64, expand=2, conv_width=4),
    rope_type="none",
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2405.21060 (Mamba2 SSD)",
)
