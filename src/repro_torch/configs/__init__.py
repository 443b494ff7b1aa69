"""Architecture config registry (port of ``repro/configs/__init__.py``).

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` resolve the assigned
architecture ids (``--arch`` flags use these exact strings).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (AttentionConfig, INPUT_SHAPES,
                                      InputShape, ModelConfig, MoEConfig,
                                      SSMConfig, TrainConfig, dtype_of,
                                      scaled)

ARCH_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "starcoder2-15b": "starcoder2_15b",
    "internvl2-1b": "internvl2_1b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-base": "whisper_base",
    "gemma2-2b": "gemma2_2b",
    "minicpm3-4b": "minicpm3_4b",
    "zamba2-7b": "zamba2_7b",
    "gemma3-27b": "gemma3_27b",
    "mnist-mlp": "mnist_mlp",
}

ASSIGNED_ARCHS = [a for a in ARCH_MODULES if a != "mnist-mlp"]


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = [
    "ARCH_MODULES", "ASSIGNED_ARCHS", "AttentionConfig", "INPUT_SHAPES",
    "InputShape", "ModelConfig", "MoEConfig", "SSMConfig", "TrainConfig",
    "dtype_of", "get_config", "get_smoke_config", "scaled",
]
