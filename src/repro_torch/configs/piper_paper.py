"""The paper's own model configurations.

* M10B — the Fig 14 base: dense [d_model=5120, d_ffn=20480, L=32, k=2]
  (~10B params) scaled out by expert count: E=16 (8 nodes) -> E=128 (64
  nodes, 862B) -> E=256 (128 nodes, 1.7T).
* super-545b — the X-MoE comparison model (Fig 13 "super", 545B fine-grained).
* Table I SOTA entries are kept as resource-model parameter dicts in
  ``TABLE_I`` (they are consumed by the resource model / planner benchmarks,
  not instantiated as models).
"""

from repro_torch.configs.base import ArchConfig, MoECfg


def m10b(num_experts: int) -> ArchConfig:
    """The paper's M10B dense base scaled by expert count (Fig 14)."""
    return ArchConfig(
        name=f"piper-m10b-e{num_experts}",
        family="moe" if num_experts > 1 else "dense",
        num_layers=32,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        head_dim=128,
        d_ff=0 if num_experts > 1 else 20480,
        vocab_size=51200,
        block_pattern=(("attn", "moe" if num_experts > 1 else "dense"),),
        moe=MoECfg(num_experts=num_experts, top_k=2, d_ff=20480)
        if num_experts > 1
        else None,
        # The paper's "10 Billion parameter" base at [d=5120, d_ffn=20480,
        # L=32] implies a 2-matrix FFN (n_mat=2): 32*(4*5120^2 +
        # 2*5120*20480) ~ 10.1B.  E=128 then gives 864B (paper: 862B) and
        # E=256 gives 1.72T (paper: 1.7T).
        ffn_activation="gelu",
        source="Piper paper SSVII-D (M10B expert scaling)",
    )


M10B_E16 = m10b(16)
M10B_E128 = m10b(128)  # ~862B (paper: 512 GPUs, 39.38 TFLOPs)
M10B_E256 = m10b(256)  # ~1.7T (paper: 1024 GPUs, 33 TFLOPs)

# Fig 13 "small/medium/large/super" fine-grained X-MoE comparison family.
# X-MoE's published "super" model is 545B with DeepSeek-style fine-grained
# experts; the paper trains it on 512 MI250X GCDs.
SUPER_545B = ArchConfig(
    name="piper-super-545b",
    family="moe",
    num_layers=62,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=0,
    vocab_size=102400,
    block_pattern=(("attn", "moe"),),
    moe=MoECfg(num_experts=160, top_k=6, d_ff=3584),
    source="Piper paper SSVII-C / X-MoE super model (fine-grained, ~545B)",
)

# Table I — SOTA MoE configurations (resource-model inputs; d_ffn is
# per-expert).  Used by benchmarks/table1 and the Table IV migration-cost
# reproduction.
TABLE_I = {
    "DeepSeek-V2": dict(total_b=236, active_b=21, E=160, Es=2, k=6, L=60,
                        d_model=5120, d_ffn=1536, context=131072),
    "DeepSeek-V3": dict(total_b=671, active_b=37, E=256, Es=1, k=8, L=61,
                        d_model=7168, d_ffn=2048, context=131072),
    "Mixtral-8x7B": dict(total_b=47, active_b=13, E=8, Es=0, k=2, L=32,
                         d_model=4096, d_ffn=14336, context=32768),
    "Mixtral-8x22B": dict(total_b=141, active_b=39, E=8, Es=0, k=2, L=56,
                          d_model=6144, d_ffn=16384, context=65536),
    "Qwen3-30B-A3B": dict(total_b=30, active_b=3, E=128, Es=0, k=8, L=48,
                          d_model=2048, d_ffn=768, context=131072),
    "Qwen3-235B-A22B": dict(total_b=235, active_b=22, E=128, Es=0, k=8, L=94,
                            d_model=7168, d_ffn=2048, context=131072),
    "Kimi-K2": dict(total_b=1000, active_b=32, E=384, Es=1, k=8, L=61,
                    d_model=7168, d_ffn=2048, context=131072),
    "Switch-Base": dict(total_b=7, active_b=0.2, E=128, Es=0, k=1, L=12,
                        d_model=768, d_ffn=2048, context=512),
    "Grok-1": dict(total_b=314, active_b=80, E=8, Es=0, k=2, L=64,
                   d_model=6144, d_ffn=32768, context=8192),
    "GLaM-1.2T": dict(total_b=1200, active_b=97, E=64, Es=0, k=2, L=64,
                      d_model=8192, d_ffn=32768, context=1024),
}
