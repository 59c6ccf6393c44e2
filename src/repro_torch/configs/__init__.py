"""Configurations of the port (copies of the reference's):
``get_config(arch)`` / ``list_archs()`` over the archs ported so far."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    COOC_SHAPES,
    RECSYS_SHAPES,
    BaseConfig,
    CoocConfig,
    RecSysConfig,
    ShapeSpec,
    replace,
)

_ARCH_MODULES: Dict[str, str] = {
    "cooccur-csl": "repro_torch.configs.cooccur_csl",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> BaseConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has "
                       f"{list_archs()} (the others wait for the side "
                       "models, ROADMAP.md §1)")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG
