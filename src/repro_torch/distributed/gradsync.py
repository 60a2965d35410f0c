"""Cross-pod gradient sync with int8 compression.

The pod-to-pod link is the slow hop of a multi-pod mesh. Each gradient
leaf crosses it as int8 with a per-leaf absmax scale, quantised and
rescaled on each rank's own block: the sum runs over ``"pod"`` only, and
local blocks stay local.

The reference sums its int8 payload in int16. Neither NCCL nor gloo
reduces int16, so the wire dtype here is int32: the sums are exact either
way (up to 2^31 / 127 pods), so the result equals the reference's, at
twice its wire bytes (ROADMAP Queue 3).

The train step calls it after the gradient has been reduced over the
batch axes, as the reference does, so every pod quantises the same
values.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.paths import map_with_paths

PyTree = Any


def _quantize_sum(g: torch.Tensor, mesh) -> torch.Tensor:
    scale = torch.clamp_min(g.abs().max() / 127.0, 1e-30)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    qsum = mesh.all_reduce(q.to(torch.int32), ("pod",))
    npods = float(mesh.axis_size(("pod",)))
    return qsum.to(torch.float32) * scale / npods


def int8_psum_grads(grads: PyTree, mesh) -> PyTree:
    """The mean over the pod axis of each rank's block of each gradient
    leaf, int8 on the wire (int32-summed)."""
    return map_with_paths(lambda _, g: _quantize_sum(g.float(), mesh), grads)
