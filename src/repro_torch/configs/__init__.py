"""Configurations of the port (copies of the reference's):
``get_config(arch)`` / ``list_archs()`` over the archs ported so far."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    COOC_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    BaseConfig,
    CoocConfig,
    LMConfig,
    RecSysConfig,
    ShapeSpec,
    replace,
)

_ARCH_MODULES: Dict[str, str] = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "cooccur-csl": "repro_torch.configs.cooccur_csl",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> BaseConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has "
                       f"{list_archs()} (the others wait for the side "
                       "models, ROADMAP.md §1)")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG
