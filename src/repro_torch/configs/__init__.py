"""Architecture registry: ``get_arch(name)`` / ``--arch <id>``."""

from repro_torch.configs.base import (
    DEFAULT_DISPATCH,
    DISPATCH_MODES,
    ArchConfig,
    Block,
    MoECfg,
)
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B

ARCHS = {c.name: c for c in (GRANITE_MOE_3B,)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ArchConfig", "Block", "MoECfg", "DISPATCH_MODES", "DEFAULT_DISPATCH",
    "ARCHS", "get_arch",
]
