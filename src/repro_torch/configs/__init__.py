"""Configurations of the port (counterparts of ``repro.configs``).

The architecture registry: ``get("internlm2-1.8b")`` etc.  Every
architecture has its full published config (``FULL``, the reference's
exact dimensions) and a reduced ``-smoke`` variant (``SMOKE``: the same
family and topology, tiny widths) for the CPU tests.  The paper's
demonstration problem config is :mod:`.brusselator`.
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import SHAPES, ArchConfig, ShapeConfig

_MODULES = [
    "deepseek_v3_671b", "dbrx_132b", "xlstm_125m", "qwen2_vl_2b",
    "internlm2_1_8b", "deepseek_coder_33b", "qwen2_72b", "starcoder2_7b",
    "zamba2_7b", "whisper_tiny",
]

_REGISTRY: Dict[str, ArchConfig] = {}


def _load():
    if _REGISTRY:
        return
    for m in _MODULES:
        mod = importlib.import_module(f"{__name__}.{m}")
        for cfg in mod.CONFIGS:
            _REGISTRY[cfg.name] = cfg


def get(name: str) -> ArchConfig:
    _load()
    return _REGISTRY[name]


def names():
    _load()
    return sorted(_REGISTRY)


ARCH_IDS = [
    "deepseek-v3-671b", "dbrx-132b", "xlstm-125m", "qwen2-vl-2b",
    "internlm2-1.8b", "deepseek-coder-33b", "qwen2-72b", "starcoder2-7b",
    "zamba2-7b", "whisper-tiny",
]


def cell_is_runnable(arch_id: str, shape_name: str) -> bool:
    """long_500k needs sub-quadratic sequence mixing (the skip rule)."""
    cfg = get(arch_id)
    shp = SHAPES[shape_name]
    if shp.name == "long_500k" and not cfg.supports_long_context:
        return False
    return True


__all__ = ["ARCH_IDS", "ArchConfig", "SHAPES", "ShapeConfig", "get",
           "names", "cell_is_runnable"]
