"""Config registry (port of ``repro/configs/base.py``).

One module per architecture defines ``CONFIG`` with the reference's
exact sizes and registers it.  ``get(name)`` returns the full config;
``get_smoke(name)`` the reduced same-family variant the CPU tests use.

Every architecture of the reference has a module here, and the port
runs each: the dense, MoE (``olmoe_1b_7b``, ``granite_moe_1b_a400m``),
SSM, hybrid, VLM and MLA decoders and the encoder-decoder
(``whisper_large_v3``).  ``get`` of a name the reference does not know
raises ``KeyError``.  ``all_arch_ids`` is the reference's full id list.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

#: The reference's architecture ids (repro/configs/base.py).
ARCH_IDS: List[str] = [
    "qwen2_vl_2b",
    "recurrentgemma_9b",
    "mamba2_130m",
    "olmoe_1b_7b",
    "whisper_large_v3",
    "granite_moe_1b_a400m",
    "qwen2_5_3b",
    "granite_8b",
    "qwen3_14b",
    "minicpm3_4b",
    "paper_kernel",
]

# CLI aliases (dashes as given in the reference)
ALIASES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-130m": "mamba2_130m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "whisper-large-v3": "whisper_large_v3",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-8b": "granite_8b",
    "qwen3-14b": "qwen3_14b",
    "minicpm3-4b": "minicpm3_4b",
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    name = ALIASES.get(name, name)
    if name not in _REGISTRY:
        if name not in ARCH_IDS:
            raise KeyError(f"unknown architecture {name!r}")
        importlib.import_module(f"{__package__}.{name}")
    return _REGISTRY[name]


def get_smoke(name: str) -> ModelConfig:
    return get(name).smoke()


def all_arch_ids(include_paper: bool = False) -> List[str]:
    ids = [a for a in ARCH_IDS if a != "paper_kernel"]
    return ids + (["paper_kernel"] if include_paper else [])
