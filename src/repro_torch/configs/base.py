"""Configuration dataclasses, mirrored field for field from the reference.

The reference's ``repro.configs.base`` cannot be imported here (it pulls in
``repro.core`` and therefore JAX), so the three configs the port reads are
copied: the same fields, the same defaults, the same order. A test pins
them against the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.core.schedule import DMDGroupRule


@dataclass(frozen=True)
class DMDControllerConfig:
    """Loss-gated adaptive jump controller (DESIGN.md §5). The port does not
    run the controller yet; the config is carried so ``resolve_groups`` can
    read ``enabled``/``energy``/``ridge`` exactly as the reference does."""
    enabled: bool = False
    eval_rows: int = 32
    accept_tol: float = 1e-3
    val_gate: bool = False
    grow: float = 1.5
    shrink: float = 0.5
    s_min: float = 1.0
    relax_floor: float = 0.125
    gain_ema: float = 0.8
    energy: float = 0.995
    ridge: float = 0.0
    ridge_max: float = 0.1
    shrink_levels: Tuple[float, ...] = (0.5,)
    meta_lr: float = 0.0


@dataclass(frozen=True)
class DMDConfig:
    enabled: bool = True
    m: int = 14                     # snapshots per DMD round (paper: 14)
    s: int = 55                     # extrapolation horizon (paper: 55)
    tol: float = 1e-4               # sigma_r / sigma_0 > tol (fp32 floor)
    atol: float = 0.0               # absolute sigma floor; 0 = off
    warmup_steps: int = 100
    cooldown_steps: int = 10
    mode: str = "matpow"            # matpow | eig (eig: not ported yet)
    clamp_eigs: bool = False
    anchor: str = "first"           # none | first | mean
    affine: bool = True
    trust_region: float = 2.0
    relax: float = 1.0
    snapshot_dtype: str = "float32"  # float32 | bfloat16 snapshot storage
    gram_upcast: bool = True
    streaming_gram: bool = True     # carry the (n_sys, m, m) Gram; False =
                                    # recompute it at every jump
    arena: bool = True              # packed block-major buckets; False =
                                    # per-leaf buffers (the A/B oracle)
    arena_block_n: int = 512
    arena_native: bool = True
    scope: str = "leaf"             # leaf | bucket (bucket: not ported yet)
    kernel_route: str = "auto"
    param_filter: str = "all"
    min_param_size: int = 0
    groups: Tuple[DMDGroupRule, ...] = ()
    anneal: float = 1.0
    controller: DMDControllerConfig = field(
        default_factory=DMDControllerConfig)
    reset_opt_state: bool = True


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"              # sgd | momentum | adam (ported so far)
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    schedule: str = "constant"      # constant (ported so far)
    warmup_steps: int = 0
    total_steps: int = 10000
    decay_fraction: float = 0.1
    min_lr_ratio: float = 0.1
