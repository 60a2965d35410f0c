"""Snapshot combination over a per-leaf ring buffer (kernel K5).

    combine  (m, S, n), (S, m) -> (S, n) fp32,  w_s = S_s^T c_s

The per-leaf route's jump blend: the extrapolated weights are a linear
combination of the m stored snapshots with each system's coefficients
(the anchor is already folded into c by ``dmd_coefficients``). One pass
over the buffer, read as an ``(m, S, n)`` view where it lies.

``combine`` launches the hand-written CUDA kernel (``csrc/flat.cu``
``flat_combine``) on CUDA tensors and the plain PyTorch twin
``combine_ref`` on CPU tensors; every kernel launch adds one to
``LAUNCHES["flat_combine"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.device import (DTYPES, check_flat_buffer, launch,
                                        on_cuda, stream)

CHUNK = 2048                     # lanes per CTA

# kernel launches since the counter was last set to 0
LAUNCHES = {"flat_combine": 0}


def combine_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(m, S, n), (S, m) -> (S, n) = S^T c per system, in fp32."""
    return torch.einsum("sj,jsn->sn", c.float(), x.float())


def combine(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(S, n) fp32 jump blend of every system, one launch for all S.
    ``c`` is contiguous float32 (S, m)."""
    check_flat_buffer(x)
    m, n_sys, n = x.shape
    if c.shape != (n_sys, m) or c.dtype != torch.float32 \
            or not c.is_contiguous():
        raise ValueError(f"coefficients must be contiguous float32 "
                         f"({n_sys}, {m}), got {tuple(c.shape)} {c.dtype}")
    if not on_cuda(x, c):
        return combine_ref(x, c)
    out = torch.empty((n_sys, n), dtype=torch.float32, device=x.device)
    launch("flat_combine", DTYPES[x.dtype], x.data_ptr(), x.stride(0),
           x.stride(1), c.data_ptr(), out.data_ptr(), m, n, n_sys, CHUNK,
           stream())
    LAUNCHES["flat_combine"] += 1
    return out
