"""Learning-rate schedules as functions of the step counter.

Each schedule takes the step as a tensor (the Trainer's device int32
counter, or anything ``torch.as_tensor`` takes) and returns the lr as an
fp32 scalar tensor on the step's device, computed in fp32 as the reference
computes it. Nothing here reads a value back to the host, so a captured
CUDA graph recomputes the lr from the counter on every replay.

Includes WSD (warmup-stable-decay): linear warmup -> constant plateau ->
linear decay over the final ``decay_fraction`` of training down to
``min_lr_ratio * lr``.
"""
from __future__ import annotations

import math

import torch


def make_schedule(cfg):
    """cfg: OptimizerConfig -> f(step) -> lr (fp32 scalar tensor)."""
    base = cfg.lr
    warm = max(int(cfg.warmup_steps), 0)
    total = max(int(cfg.total_steps), 1)
    floor = cfg.min_lr_ratio * base

    def as_step(step) -> torch.Tensor:
        return torch.as_tensor(step)

    def warmup_part(step: torch.Tensor) -> torch.Tensor:
        if warm == 0:
            return torch.ones((), dtype=torch.float32, device=step.device)
        return torch.clamp_max((step.float() + 1.0) / warm, 1.0)

    if cfg.schedule in ("constant", "linear_warmup"):
        def f(step):
            return base * warmup_part(as_step(step))
    elif cfg.schedule == "cosine":
        def f(step):
            step = as_step(step)
            t = torch.clamp((step - warm) / max(total - warm, 1), 0.0, 1.0)
            cos = 0.5 * (1.0 + torch.cos(math.pi * t))
            return (floor + (base - floor) * cos) * warmup_part(step)
    elif cfg.schedule == "wsd":
        decay_steps = max(int(total * cfg.decay_fraction), 1)
        stable_end = total - decay_steps

        def f(step):
            step = as_step(step)
            t = torch.clamp((step - stable_end) / decay_steps, 0.0, 1.0)
            return (base - (base - floor) * t) * warmup_part(step)
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return f
