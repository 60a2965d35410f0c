"""Config registry: ``get_config("<arch-id>")`` for the architectures the
port builds so far; ``list_archs`` and ``shape_by_name`` as the reference
has them."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (STANDARD_SHAPES, ArchConfig, DMDConfig,
                                      DMDControllerConfig, ModelConfig,
                                      MoEConfig, OptimizerConfig,
                                      ParallelConfig, SSMConfig, ShapeConfig,
                                      TrainConfig, reduced)

_ARCH_MODULES: Dict[str, str] = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "pollutant-mlp": "repro_torch.configs.pollutant_mlp",
}
# the reference's other architectures, and the part of the port that
# brings each (ROADMAP Queue 1)
_LATER: Dict[str, str] = {
    "minicpm-2b": "the dense LM slice with its schedule",
    "granite-20b": "the mesh (head-TP) serving slice",
    "gemma3-27b": "the ring-cache serving slice",
    "whisper-base": "the enc-dec slice",
    "qwen2-vl-7b": "the M-RoPE slice",
    "zamba2-2.7b": "the SSM/hybrid slice",
    "mamba2-2.7b": "the SSM/hybrid slice",
    "llama4-maverick-400b-a17b": "the MoE slice",
    "qwen3-moe-30b-a3b": "the MoE slice",
}


# every architecture of the reference's registry, in its order
ARCHS = ("minicpm-2b", "granite-20b", "gemma3-27b", "tinyllama-1.1b",
         "whisper-base", "qwen2-vl-7b", "zamba2-2.7b", "mamba2-2.7b",
         "llama4-maverick-400b-a17b", "qwen3-moe-30b-a3b")


def list_archs() -> List[str]:
    """The reference's architecture ids (``get_config`` builds the ported
    ones and names the slice that brings each other one)."""
    return list(ARCHS)


def shape_by_name(name: str) -> ShapeConfig:
    for s in STANDARD_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def get_config(name: str) -> ArchConfig:
    if name in _LATER:
        raise KeyError(f"arch {name!r} is not ported yet: it comes with "
                       f"{_LATER[name]}; ported: {sorted(_ARCH_MODULES)}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).get_config()


__all__ = ["ArchConfig", "DMDConfig", "DMDControllerConfig", "ModelConfig",
           "MoEConfig", "OptimizerConfig", "ParallelConfig", "SSMConfig",
           "STANDARD_SHAPES", "ShapeConfig", "TrainConfig", "get_config",
           "list_archs", "reduced", "shape_by_name"]
