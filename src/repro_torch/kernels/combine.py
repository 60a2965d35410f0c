"""Snapshot combination over a per-leaf ring buffer (kernel K5).

    combine  (m, S, n), (S, m) -> (S, n) fp32,  w_s = S_s^T c_s

The per-leaf route's jump blend: the extrapolated weights are a linear
combination of the m stored snapshots with each system's coefficients
(the anchor is already folded into c by ``dmd_coefficients``). One pass
over the buffer, read as an ``(m, S, n)`` view where it lies.

``combine`` launches the hand-written CUDA kernel (``csrc/flat.cu``
``flat_combine``) on CUDA tensors and the plain PyTorch twin
``combine_ref`` on CPU tensors; every kernel launch adds one to
``LAUNCHES["flat_combine"]``. The wrapper makes the kernel's choices for
each call, in plain Python: whether its loads are 16 bytes wide
(``device.vector_lanes`` of the buffer) and how many CTAs each system gets
(``device.grid_ctas``: the card CTAS_PER_SM deep, one wave).

``combine`` is differentiable in ``c`` (the controller's meta-tuning): when
``c`` requires grad it runs as ``CombineFn``, whose backward
``dc[s, k] = <x[k, s, :], dw[s, :]>`` is a per-leaf Gram-row pass with
``dw`` as the query and no anchor, i.e. K4 (``gram_row.gram_row``); each
such launch also counts under ``gram_row.BWD_LAUNCHES["flat_gram_row_bwd"]``.
The buffer takes no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import device as _device
from repro_torch.kernels import gram_row as _gram_row
from repro_torch.kernels.device import (DTYPES, acc_dtype, check_flat_buffer,
                                        launch, on_cuda, sm_count, stream,
                                        twin_only)

THREADS = 256                    # threads per CTA (flat.cu kThreads)
CTAS_PER_SM = 1                  # CTAs per SM the grid aims for, all systems

# kernel launches since the counter was last set to 0
LAUNCHES = {"flat_combine": 0}


def combine_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(m, S, n), (S, m) -> (S, n) = S^T c per system, in fp32. The m
    products of a lane are summed in snapshot order, one multiply and one
    add each, as the arena twin sums them (same bits on the same
    coefficients)."""
    xf, cf = x.double(), c.double()
    out = cf[:, 0:1] * xf[0]
    for j in range(1, x.shape[0]):
        out = out + cf[:, j:j + 1] * xf[j]
    return out.to(acc_dtype(x))


@_device.opaque("flat_combine")
def combine(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(S, n) fp32 jump blend of every system, one launch for all S.
    ``c`` is contiguous float32 (S, m). Differentiable in ``c``
    (``CombineFn``) when ``c`` requires grad."""
    if torch.is_grad_enabled() and c.requires_grad:
        return CombineFn.apply(x, c)
    return _combine(x, c)


def _combine(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    check_flat_buffer(x)
    m, n_sys, n = x.shape
    if c.shape != (n_sys, m) or c.dtype != torch.float32 \
            or not c.is_contiguous():
        raise ValueError(f"coefficients must be contiguous float32 "
                         f"({n_sys}, {m}), got {tuple(c.shape)} {c.dtype}")
    if not on_cuda(x, c):
        return combine_ref(x, c)
    vec = _device.vector_lanes(x)
    units = n // (16 // x.element_size()) if vec else n
    ctas = _device.grid_ctas(units, n_sys, sm_count(x.device), CTAS_PER_SM,
                             THREADS)
    out = torch.empty((n_sys, n), dtype=torch.float32, device=x.device)
    launch("flat_combine", DTYPES[x.dtype], x.data_ptr(), x.stride(0),
           x.stride(1), c.data_ptr(), out.data_ptr(), m, n, n_sys, ctas,
           int(vec), stream())
    LAUNCHES["flat_combine"] += 1
    return out


class CombineFn(torch.autograd.Function):
    """K5 with a gradient in ``c``: forward is ``_combine`` (K5 on the card,
    the twin on the CPU); backward is K4 with the cotangent ``dw`` as the
    query and no anchor. K4 takes a query of the buffer's dtype, so with a
    bf16 ``snapshot_dtype`` the fp32 cotangent is rounded to bf16 (2^-8
    relative per lane) before the pass; the sums stay fp32. The
    controller's meta-tuning reads only the sign of the knob gradients."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.save_for_backward(x)
        ctx.c_dtype = c.dtype
        if twin_only(x):
            return combine_ref(x, c.detach())
        return _combine(x, c.detach())

    @staticmethod
    def backward(ctx, dw):
        (x,) = ctx.saved_tensors
        q = dw.to(x.dtype).contiguous()
        if twin_only(x):
            dc = _gram_row.gram_row_ref(x, q)
        else:
            dc = _gram_row.gram_row(x, q)
        if x.is_cuda:
            _gram_row.BWD_LAUNCHES["flat_gram_row_bwd"] += 1
        return None, dc.to(ctx.c_dtype)
