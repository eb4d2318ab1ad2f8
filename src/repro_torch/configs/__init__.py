"""Architecture config registry.

Every assigned architecture is a selectable config (``--arch <id>``); the
paper's own ViT-Base/Large are included for the faithful reproduction of its
tables. IDs are the exact assignment strings.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "gemma2-9b": "gemma2_9b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "stablelm-12b": "stablelm_12b",
    "qwen2.5-14b": "qwen2_5_14b",
    "rwkv6-3b": "rwkv6_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-base": "whisper_base",
    "nemotron-4-340b": "nemotron_4_340b",
    "vit-base": "vit_base",
    "vit-large": "vit_large",
}

ASSIGNED: List[str] = [k for k in _MODULES if not k.startswith("vit-")]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}
