"""Architecture config registry: ``get_config(arch_id)`` / ``--arch <id>``.

The port's copy of ``repro/configs``: the ten data files, this registry
and ``shapes.py`` (the assigned input shapes and ``config_for_shape``).

Perf experiments can override any ModelConfig field without code edits via
``REPRO_CFG_OVERRIDES='{"moe_dispatch_groups": 64, "remat_policy": "dots"}'``
(applied to every config this process loads — used by the §Perf hillclimb).
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "xlstm-125m": "xlstm_125m",
    "musicgen-large": "musicgen_large",
    "yi-9b": "yi_9b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    cfg = mod.CONFIG
    overrides = os.environ.get("REPRO_CFG_OVERRIDES")
    if overrides:
        cfg = dataclasses.replace(cfg, **json.loads(overrides))
    return cfg


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
