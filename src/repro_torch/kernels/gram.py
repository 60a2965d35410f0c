"""Full snapshot Gram over a per-leaf ring buffer (kernel K6).

    gram  (m, S, n) -> (S, m, m) fp32,  G_s = D_s D_s^T,  D = S - S[0] optional

The per-leaf route's recompute pass: the ``streaming_gram=False`` jump
rebuilds each system's Gram from its buffer with one O(m^2*n) pass. The
buffer is read as an ``(m, S, n)`` view where it lies. Mean-anchored
leaves do not come here: they take ``core/dmd.py::gram_matrix``, as in
the reference.

``gram`` launches the hand-written CUDA kernel (``csrc/flat.cu``
``flat_gram``) on CUDA tensors and the plain PyTorch twin ``gram_ref`` on
CPU tensors; every kernel launch adds one to ``LAUNCHES["flat_gram"]``.
The kernel runs on K4's grid (``grid``: CTAS_PER_SM CTAs per SM over all
systems) with K5's load width rule (``device.vector_lanes(x)``); its
per-system integer tickets are ``device.tickets``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import device as _device
from repro_torch.kernels.device import (DTYPES, check_flat_buffer, launch,
                                        on_cuda, sm_count, stream)

THREADS = 256                    # threads per CTA (gram.cuh kGramThreads)
CTAS_PER_SM = 1                  # its m(m+1)/2 sums fill the registers

# kernel launches since the counter was last set to 0
LAUNCHES = {"flat_gram": 0}


def gram_ref(x: torch.Tensor, *, anchor_first: bool = False
             ) -> torch.Tensor:
    """(m, S, n) -> (S, m, m) = D D^T per system in fp32, with D = S - S[0]
    when anchored (subtracted explicitly). One (m, n) product per system,
    as the reference contracts each leaf."""
    xf = x.float()
    if anchor_first:
        xf = xf - xf[:1]
    return torch.stack([d @ d.T for d in xf.unbind(1)])


def grid(x: torch.Tensor, sms: int) -> tuple[bool, int, int]:
    """The kernel's choices for buffer `x` on a card of `sms` SMs: (16-byte
    loads?, CTAs per system, floats of the partial buffer). Loads are 16
    bytes where ``vector_lanes(x)`` allows, as K5's; the grid is the card
    CTAS_PER_SM deep over all systems, as K4's; one upper triangle
    (m(m+1)/2 floats) per (system, CTA)."""
    m, n_sys, n = x.shape
    vec = _device.vector_lanes(x)
    units = n // (16 // x.element_size()) if vec else n
    ctas = _device.grid_ctas(units, n_sys, sms, CTAS_PER_SM, THREADS)
    return vec, ctas, n_sys * ctas * (m * (m + 1) // 2)


@_device.opaque("flat_gram")
def gram(x: torch.Tensor, *, anchor_first: bool = False) -> torch.Tensor:
    """Full (S, m, m) Gram of every system, one launch for all S."""
    check_flat_buffer(x)
    m, n_sys, n = x.shape
    if not on_cuda(x):
        return gram_ref(x, anchor_first=anchor_first)
    vec, ctas, n_part = grid(x, sm_count(x.device))
    part = torch.empty((n_part,), dtype=torch.float32, device=x.device)
    out = torch.empty((n_sys, m, m), dtype=torch.float32, device=x.device)
    st = stream()
    launch("flat_gram", DTYPES[x.dtype], x.data_ptr(), x.stride(0),
           x.stride(1), part.data_ptr(),
           _device.tickets(x.device, st, n_sys).data_ptr(), out.data_ptr(),
           m, n, n_sys, ctas, int(vec), int(anchor_first), st)
    LAUNCHES["flat_gram"] += 1
    return out
