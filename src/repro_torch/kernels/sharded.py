"""The DMD data passes of sharded and stacked per-leaf buffers, per rank.

A rank holds its block of each leaf's ring buffer, ``(m, stack...,
param...)`` laid out by the plan's ``snapshot_spec``. The flat kernels
(K6 ``gram``, K4 ``gram_row``, K5 ``combine``, through ``kernels/ops.py``)
run on that block as they run on a whole buffer, one launch over the
block's stacked systems, and give the rank's fp32 partials; then ONE
all-reduce (sum) over the axes that shard the contracted dims
(``plan.psum_axes()``) makes the full result, O(stack·m²) for the Gram and
O(stack·m) for its row. The anchor subtraction stays in the kernel and is
exact per block: row 0 of a rank's block IS its block of the anchor row.

``combine`` makes no collective: the coefficients are the same on every
rank holding the same systems, and the output has the param's layout.

Without a mesh on the plan the local computation is the whole
computation (the reference's ``_wrap``), so one code path serves one
device and many.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def psum(x: torch.Tensor, plan) -> torch.Tensor:
    """`x` (a rank's Gram partials of the leaf) summed in place over
    ``plan.psum_axes()``; `x` itself without a mesh."""
    axes = plan.psum_axes()
    if plan.mesh is not None and axes:
        plan.mesh.all_reduce(x, axes)
    return x


def gram(buf: torch.Tensor, plan, *, anchor_first: bool = False
         ) -> torch.Tensor:
    """(m, stack..., param...) block -> (stack..., m, m) fp32 full Gram:
    K6 on the block, then one all-reduce."""
    g = ops.gram(buf, anchor_first=anchor_first, stack_dims=plan.stack_dims)
    return psum(g, plan)


def gram_row(buf: torch.Tensor, q: torch.Tensor, plan, *,
             anchor_first: bool = False) -> torch.Tensor:
    """(m, stack..., param...), (stack..., param...) blocks -> (stack...,
    m): the streaming row <d_q, d_j>, K4 on the block, then one
    all-reduce."""
    r = ops.gram_row(buf, q, anchor_first=anchor_first,
                     stack_dims=plan.stack_dims)
    return psum(r, plan)


def combine(buf: torch.Tensor, c: torch.Tensor, plan) -> torch.Tensor:
    """(m, stack..., param...) block, (stack..., m) -> (stack...,
    param...) fp32 block: K5 on the block, no collective."""
    return ops.combine(buf, c, stack_dims=plan.stack_dims)
