"""Architecture registry: ``get_arch(name)`` / ``--arch <id>``."""

from repro_torch.configs.base import (
    A2A_ALGOS,
    A2A_CHUNK_CANDIDATES,
    DEFAULT_A2A,
    DEFAULT_DISPATCH,
    DEFAULT_SCHEDULE,
    DISPATCH_MODES,
    SCHEDULES,
    ArchConfig,
    Block,
    MoECfg,
    SSMCfg,
    ShapeSpec,
    SHAPES,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
    shape_applicable,
)
from repro_torch.configs import piper_paper
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1_314B
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN_LARGE
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.smollm_360m import CONFIG as SMOLLM_360M
from repro_torch.configs.yi_9b import CONFIG as YI_9B

ARCHS = {
    c.name: c
    for c in (
        GRANITE_MOE_3B,
        GROK_1_314B,
        MAMBA2_370M,
        MUSICGEN_LARGE,
        DEEPSEEK_7B,
        SMOLLM_360M,
        GEMMA2_9B,
        YI_9B,
        QWEN2_VL_7B,
        JAMBA_1_5_LARGE,
        piper_paper.M10B_E16,
        piper_paper.M10B_E128,
        piper_paper.M10B_E256,
        piper_paper.SUPER_545B,
    )
}

# The ten assigned architectures (dry-run / roofline scope).
ASSIGNED = [
    "granite-moe-3b-a800m",
    "grok-1-314b",
    "mamba2-370m",
    "musicgen-large",
    "deepseek-7b",
    "smollm-360m",
    "gemma2-9b",
    "yi-9b",
    "qwen2-vl-7b",
    "jamba-1.5-large-398b",
]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


__all__ = [
    "ArchConfig", "Block", "MoECfg", "SSMCfg", "ShapeSpec", "SHAPES",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K", "shape_applicable",
    "DISPATCH_MODES", "DEFAULT_DISPATCH", "SCHEDULES", "DEFAULT_SCHEDULE", "A2A_ALGOS",
    "DEFAULT_A2A", "A2A_CHUNK_CANDIDATES", "ARCHS", "ASSIGNED", "get_arch", "list_archs",
]
