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
each call, in plain Python: whether its loads are 16 bytes wide
(``vector_lanes``), whether the query is a slot of the buffer
(``query_slot``) and how many CTAs each system gets (``grid_ctas``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.device import (DTYPES, check_flat_buffer, launch,
                                        lanes_contiguous, on_cuda, sm_count,
                                        stream)

THREADS = 256                    # threads per CTA (flat.cu kRowThreads)
CTAS_PER_SM = 1                  # CTAs per SM the grid aims for, all systems

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


def vector_lanes(x: torch.Tensor, q: torch.Tensor) -> bool:
    """True when every row of ``x`` (m, S, n) and every system of ``q``
    (S, n) starts 16-byte aligned and n is whole 16-byte units (4 fp32 or
    8 bf16 lanes): the kernel then reads 16 bytes per row per step."""
    per = 16 // x.element_size()
    m, n_sys, n = x.shape
    strides = [x.stride(0)] if m > 1 else []
    if n_sys > 1:
        strides += [x.stride(1), q.stride(0)]
    return (n % per == 0 and x.data_ptr() % 16 == 0
            and q.data_ptr() % 16 == 0 and all(s % per == 0 for s in strides))


def query_slot(x: torch.Tensor, q: torch.Tensor) -> int:
    """The slot j for which ``q`` is ``x[j]`` in place (the same addresses:
    its start is row j's and its system stride x's), else -1. The kernel
    then reads that row once, as the query and as row j."""
    off = q.data_ptr() - x.data_ptr()
    row = x.stride(0) * x.element_size()
    if row <= 0 or off % row or not 0 <= off // row < x.shape[0]:
        return -1
    if x.shape[1] > 1 and q.stride(0) != x.stride(1):
        return -1
    return off // row


def grid_ctas(units: int, n_sys: int, sms: int) -> int:
    """CTAs per system: the card CTAS_PER_SM deep over all systems, and no
    more than one per THREADS units (a unit is the lanes one load covers)."""
    fill = -(-CTAS_PER_SM * sms // n_sys)
    return max(1, min(fill, -(-units // THREADS)))


_TICKETS: dict = {}


def _tickets(device: torch.device, st: int, n_sys: int) -> torch.Tensor:
    """The kernel's per-system integer tickets, zero between launches (the
    last CTA of each system resets its own). One buffer per (device,
    stream `st`): launches on one stream run in order, so they never use
    it at the same time."""
    buf = _TICKETS.get((device, st))
    if buf is None or buf.numel() < n_sys:
        buf = torch.zeros(max(n_sys, 64), dtype=torch.int32, device=device)
        _TICKETS[(device, st)] = buf
    return buf


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
    vec = vector_lanes(x, q)
    ctas = grid_ctas(n // (16 // x.element_size()) if vec else n, n_sys,
                     sm_count(x.device))
    part = torch.empty((n_sys, ctas, m), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((n_sys, m), dtype=torch.float32, device=x.device)
    st = stream()
    launch("flat_gram_row", DTYPES[x.dtype], x.data_ptr(), x.stride(0),
           x.stride(1), q.data_ptr(), q.stride(0), query_slot(x, q),
           part.data_ptr(), _tickets(x.device, st, n_sys).data_ptr(),
           out.data_ptr(), m, n, n_sys, ctas, int(vec), int(anchor_first),
           st)
    LAUNCHES["flat_gram_row"] += 1
    return out
