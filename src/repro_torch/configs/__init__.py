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
)
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1_314B
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.smollm_360m import CONFIG as SMOLLM_360M
from repro_torch.configs.yi_9b import CONFIG as YI_9B

ARCHS = {c.name: c for c in (GRANITE_MOE_3B, GROK_1_314B, MAMBA2_370M, DEEPSEEK_7B,
                             SMOLLM_360M, GEMMA2_9B, YI_9B, JAMBA_1_5_LARGE)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ArchConfig", "Block", "MoECfg", "SSMCfg", "DISPATCH_MODES", "DEFAULT_DISPATCH",
    "SCHEDULES", "DEFAULT_SCHEDULE", "A2A_ALGOS", "DEFAULT_A2A", "A2A_CHUNK_CANDIDATES",
    "ARCHS", "get_arch",
]
