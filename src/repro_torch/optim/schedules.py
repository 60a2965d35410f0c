"""Learning-rate schedules as functions of the step counter. Only the
constant schedule (with optional linear warmup) is ported so far."""
from __future__ import annotations

import numpy as np


def make_schedule(cfg):
    """cfg: OptimizerConfig -> f(step) -> lr as an fp32 scalar, computed in
    fp32 as the reference computes it."""
    if cfg.schedule not in ("constant", "linear_warmup"):
        raise NotImplementedError(
            f"schedule {cfg.schedule!r} is not ported yet; use 'constant'")
    base = cfg.lr
    warm = max(int(cfg.warmup_steps), 0)

    def f(step: int) -> np.float32:
        if warm == 0:
            return np.float32(base) * np.float32(1.0)
        ramp = min((np.float32(step) + np.float32(1.0)) / np.float32(warm),
                   np.float32(1.0))
        return np.float32(base) * np.float32(ramp)
    return f
