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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.device import (DTYPES, check_flat_buffer, launch,
                                        on_cuda, stream)

CHUNK = 4096                     # lanes per CTA (one partial Gram each)

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


def gram(x: torch.Tensor, *, anchor_first: bool = False) -> torch.Tensor:
    """Full (S, m, m) Gram of every system, one launch for all S."""
    check_flat_buffer(x)
    m, n_sys, n = x.shape
    if not on_cuda(x):
        return gram_ref(x, anchor_first=anchor_first)
    nc = -(-n // CHUNK)
    part = torch.empty((n_sys, nc, m, m), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((n_sys, m, m), dtype=torch.float32, device=x.device)
    launch("flat_gram", DTYPES[x.dtype], x.data_ptr(), x.stride(0),
           x.stride(1), part.data_ptr(), out.data_ptr(), m, n, n_sys, CHUNK,
           int(anchor_first), stream())
    LAUNCHES["flat_gram"] += 1
    return out
