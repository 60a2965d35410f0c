"""Config registry: ``get_config("<arch-id>")`` for every architecture of
the reference; ``list_archs`` and ``shape_by_name`` as the reference has
them."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (STANDARD_SHAPES, ArchConfig, DMDConfig,
                                      DMDControllerConfig, ModelConfig,
                                      MoEConfig, OptimizerConfig,
                                      ParallelConfig, SSMConfig, ShapeConfig,
                                      TrainConfig, reduced)

_ARCH_MODULES: Dict[str, str] = {
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "pollutant-mlp": "repro_torch.configs.pollutant_mlp",
}
# every architecture of the reference's registry, in its order
ARCHS = ("minicpm-2b", "granite-20b", "gemma3-27b", "tinyllama-1.1b",
         "whisper-base", "qwen2-vl-7b", "zamba2-2.7b", "mamba2-2.7b",
         "llama4-maverick-400b-a17b", "qwen3-moe-30b-a3b")


def list_archs() -> List[str]:
    """The reference's architecture ids, in its order."""
    return list(ARCHS)


def shape_by_name(name: str) -> ShapeConfig:
    for s in STANDARD_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).get_config()


__all__ = ["ArchConfig", "DMDConfig", "DMDControllerConfig", "ModelConfig",
           "MoEConfig", "OptimizerConfig", "ParallelConfig", "SSMConfig",
           "STANDARD_SHAPES", "ShapeConfig", "TrainConfig", "get_config",
           "list_archs", "reduced", "shape_by_name"]
