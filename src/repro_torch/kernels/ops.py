"""Lane tiling and the per-leaf entry points of the DMD data passes.

The entry points take a leaf's ring buffer as the reference lays it out,
``(m, stack..., param...)`` with ``stack_dims`` leading stacked axes (one
independent DMD system per stacked layer), view it as ``(m, S, n)`` without
a copy, and hand it to the flat kernels K4-K6 (``kernels/gram_row.py``,
``gram.py``, ``combine.py``). Routing is by device only (see
``kernels/device.py``): CPU tensors take the twins, CUDA tensors the
kernels or raise.

    gram_row  (m, stack..., rest...), (stack..., rest...) -> (stack..., m)
    gram      (m, stack..., rest...)                      -> (stack..., m, m)
    combine   (m, stack..., rest...), (stack..., m)       -> (stack..., rest...)

``flash_attention`` is the attention core of the dense LM (kernel K7,
``kernels/flash_attention.py``), routed the same way.

With ``stack_dims > 0`` they are the local passes of the reference's
``kernels/sharded.py`` (the port's runs them on each rank's block): one
launch over all stacked systems, reading the buffer through its system
stride instead of moving the stack axes first.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import combine as _combine
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import gram_row as _gram_row

LANES = 128                       # lane quantum of the arena layout


def lane_block(block_n: int, n: int) -> int:
    """Clamp the requested n-tile to the leaf: a 128-lane multiple no wider
    than the lane-padded leaf itself (tiny leaves get one 128-lane tile).
    Zero pad lanes contribute zero to every inner product, so padding is
    exact."""
    n_pad = max(-(-max(n, 1) // LANES) * LANES, LANES)
    return max(min(block_n // LANES * LANES, n_pad), LANES)


def _systems(snapshots: torch.Tensor, stack_dims: int
             ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(m, stack..., rest...) -> its (m, S, n) view and the stack shape."""
    if not snapshots.is_contiguous():
        raise ValueError("a ring buffer must be contiguous (its (m, S, n) "
                         "view would otherwise be a copy)")
    m = snapshots.shape[0]
    stack = tuple(snapshots.shape[1:1 + stack_dims])
    n_sys = 1
    for d in stack:
        n_sys *= int(d)
    return snapshots.view(m, n_sys, -1), stack


def gram_row(snapshots: torch.Tensor, p: torch.Tensor, *,
             anchor_first: bool = False, stack_dims: int = 0
             ) -> torch.Tensor:
    """Streaming Gram row <d_p, d_j> of every system (one O(m*n) pass); `p`
    is the snapshot just written, in the buffer's dtype (its slot of the
    buffer is passed as is)."""
    x, stack = _systems(snapshots, stack_dims)
    q = p.reshape(x.shape[1], x.shape[2])
    row = _gram_row.gram_row(x, q, anchor_first=anchor_first)
    return row.reshape(stack + (x.shape[0],))


def gram(snapshots: torch.Tensor, *, anchor_first: bool = False,
         stack_dims: int = 0) -> torch.Tensor:
    """Full fp32 Gram of every system (the recompute pass)."""
    x, stack = _systems(snapshots, stack_dims)
    g = _gram.gram(x, anchor_first=anchor_first)
    return g.reshape(stack + g.shape[1:])


def combine(snapshots: torch.Tensor, c: torch.Tensor, *,
            stack_dims: int = 0) -> torch.Tensor:
    """w = S^T c in fp32, per system, in the param's shape."""
    x, _ = _systems(snapshots, stack_dims)
    w = _combine.combine(x, c.reshape(x.shape[1], x.shape[0]).contiguous())
    return w.reshape(snapshots.shape[1:])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, d), k/v (B, Sk, K, d) -> (B, Sq, H, d): flash-attention
    forward with GQA (kv head h // (H / K)), both positions from 0."""
    return _flash.flash_attention(q, k, v, causal=causal, window=window)
