"""Streaming Gram row over a per-leaf ring buffer (kernel K4).

    gram_row  (m, S, n), (S, n) -> (S, m) fp32,  r_sj = <q_s - x_0s, x_js - x_0s>

The per-leaf route's hot pass: after ``record`` writes a snapshot into slot
``slot`` of a leaf's ``(m, *shape)`` buffer, one row of each system's
running (m, m) Gram is refreshed with one O(m*n) pass, the anchor (row 0)
optional. The buffer is read as an ``(m, S, n)`` view where it lies (S
stacked systems, 1 for a plain leaf), and the query is the just-written
slot itself, so nothing is copied.

``gram_row`` launches the hand-written CUDA kernel (``csrc/flat.cu``
``flat_gram_row``) on CUDA tensors and the plain PyTorch twin
``gram_row_ref`` on CPU tensors; every kernel launch adds one to
``LAUNCHES["flat_gram_row"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.device import (DTYPES, check_flat_buffer, launch,
                                        lanes_contiguous, on_cuda, stream)

CHUNK = 2048                     # lanes per CTA (one partial row each)

# kernel launches since the counter was last set to 0
LAUNCHES = {"flat_gram_row": 0}


def gram_row_ref(x: torch.Tensor, q: torch.Tensor, *,
                 anchor_first: bool = False) -> torch.Tensor:
    """(m, S, n), (S, n) -> (S, m) = <d_q, d_j> per system in fp32, with
    d = s - s_0 when anchored (subtracted explicitly)."""
    xf = x.float()
    qf = q.float()
    if anchor_first:
        qf = qf - xf[0]
        xf = xf - xf[:1]
    return torch.einsum("jsn,sn->sj", xf, qf)


def gram_row(x: torch.Tensor, q: torch.Tensor, *,
             anchor_first: bool = False) -> torch.Tensor:
    """One streaming Gram row per system, one launch for all S systems.
    ``q`` is (S, n) in the buffer's dtype with unit lane stride; its
    systems may be strided, so a slot of the buffer (``x[slot]``) goes in
    without a copy."""
    check_flat_buffer(x)
    m, n_sys, n = x.shape
    if q.shape != (n_sys, n) or q.dtype != x.dtype \
            or not lanes_contiguous(q):
        raise ValueError(f"query must be ({n_sys}, {n}) {x.dtype} with unit "
                         f"lane stride, got {tuple(q.shape)} {q.dtype} "
                         f"strides {q.stride()}")
    if not on_cuda(x, q):
        return gram_row_ref(x, q, anchor_first=anchor_first)
    nc = -(-n // CHUNK)
    part = torch.empty((n_sys, nc, m), dtype=torch.float32, device=x.device)
    out = torch.empty((n_sys, m), dtype=torch.float32, device=x.device)
    launch("flat_gram_row", DTYPES[x.dtype], x.data_ptr(), x.stride(0),
           x.stride(1), q.data_ptr(), q.stride(0), part.data_ptr(),
           out.data_ptr(), m, n, n_sys, CHUNK, int(anchor_first), stream())
    LAUNCHES["flat_gram_row"] += 1
    return out
