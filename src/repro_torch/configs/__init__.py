"""Config registry: ``get_config("<arch-id>")`` for the architectures the
port builds so far."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ArchConfig, DMDConfig,
                                      DMDControllerConfig, ModelConfig,
                                      MoEConfig, OptimizerConfig,
                                      ParallelConfig, SSMConfig, TrainConfig,
                                      reduced)

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
           "TrainConfig", "get_config", "reduced"]
