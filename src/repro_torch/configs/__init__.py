"""Architecture registry: the 10 assigned architectures (``--arch <id>``),
each with its published configuration (FULL) and a smoke-test REDUCED
variant — the port of ``repro/configs``, as :class:`LMConfig` values with
torch dtypes.  The TPU dry-run shape sets (``repro/configs/shapes.py``)
are not ported (they belong to the multi-device layer)."""
from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from ..models.lm import LMConfig

_MODULES: Dict[str, str] = {
    "granite-20b": "granite_20b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-3-2b": "granite_3_2b",
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "mamba2-780m": "mamba2_780m",
    "internvl2-26b": "internvl2_26b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str, reduced: bool = False) -> LMConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch '{arch}'; available: {ARCH_IDS}")
    mod = import_module(f".{_MODULES[arch]}", __package__)
    return mod.REDUCED if reduced else mod.FULL
