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
``LAUNCHES["flat_gram_row"]``. The wrapper makes the kernel's choices for
each call, in plain Python, through the helpers of ``kernels/device.py``
that K1 and K5 share: whether its loads are 16 bytes wide
(``vector_lanes``), whether the query is a slot of the buffer
(``query_slot``) and how many CTAs each system gets (``grid_ctas``, the
card CTAS_PER_SM deep); its per-system integer tickets are ``tickets``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import device as _device
from repro_torch.kernels.device import (DTYPES, acc_dtype,
                                        check_flat_buffer, launch,
                                        lanes_contiguous, on_cuda, sm_count,
                                        stream)

THREADS = 256                    # threads per CTA (flat.cu kRowThreads)
CTAS_PER_SM = 1                  # CTAs per SM the grid aims for, all systems

# kernel launches since the counter was last set to 0
LAUNCHES = {"flat_gram_row": 0}
# the launches made as K5's backward (a design counter: a subset of
# LAUNCHES["flat_gram_row"])
BWD_LAUNCHES = {"flat_gram_row_bwd": 0}


def gram_row_ref(x: torch.Tensor, q: torch.Tensor, *,
                 anchor_first: bool = False) -> torch.Tensor:
    """(m, S, n), (S, n) -> (S, m) = <d_q, d_j> per system in fp32, with
    d = s - s_0 when anchored (subtracted explicitly)."""
    xf = x.to(acc_dtype(x))
    qf = q.to(xf.dtype)
    if anchor_first:
        qf = qf - xf[0]
        xf = xf - xf[:1]
    return torch.einsum("jsn,sn->sj", xf, qf)


@_device.opaque("flat_gram_row")
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
    vec = _device.vector_lanes(x, q)
    units = n // (16 // x.element_size()) if vec else n
    ctas = _device.grid_ctas(units, n_sys, sm_count(x.device), CTAS_PER_SM,
                             THREADS)
    part = torch.empty((n_sys, ctas, m), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((n_sys, m), dtype=torch.float32, device=x.device)
    st = stream()
    launch("flat_gram_row", DTYPES[x.dtype], x.data_ptr(), x.stride(0),
           x.stride(1), q.data_ptr(), q.stride(0),
           _device.query_slot(x, q), part.data_ptr(),
           _device.tickets(x.device, st, n_sys).data_ptr(), out.data_ptr(),
           m, n, n_sys, ctas, int(vec), int(anchor_first), st)
    LAUNCHES["flat_gram_row"] += 1
    return out
