"""Architecture registry: name → ArchConfig (the reference's ten
architectures; a model whose mixer is not ported yet raises at init)."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_MODULES = (
    "minitron_4b", "minicpm3_4b", "gemma_7b", "granite_3_8b",
    "jamba_1_5_large_398b", "seamless_m4t_medium", "chameleon_34b",
    "moonshot_v1_16b_a3b", "mixtral_8x7b", "rwkv6_1_6b",
)


def _load() -> Dict[str, ArchConfig]:
    import importlib
    out = {}
    for m in _MODULES:
        cfg = importlib.import_module(f"repro_torch.configs.{m}").CONFIG
        out[cfg.name] = cfg
    return out


_REGISTRY: Dict[str, ArchConfig] = {}


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    global _REGISTRY
    if not _REGISTRY:
        _REGISTRY = _load()
    cfg = _REGISTRY[name]
    return cfg.reduced() if reduced else cfg


def list_archs() -> List[str]:
    global _REGISTRY
    if not _REGISTRY:
        _REGISTRY = _load()
    return sorted(_REGISTRY)
