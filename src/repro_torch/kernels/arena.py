"""Segmented DMD data passes over packed, block-major arenas.

An arena packs every leaf of one schedule group into ONE ``(nb, m, bn)``
snapshot ring buffer: ``bn``-lane blocks, each carrying its ``m`` snapshot
rows contiguously, every system padded to a block multiple so no block
straddles two systems. ``block_sys`` (sorted) maps each block to its
system. Three passes walk the whole arena in one launch each:

  * ``gram_row``  (nb, m, bn), (nb, bn)   -> (n_sys, m)     streaming row
  * ``gram``      (nb, m, bn)             -> (n_sys, m, m)  full recompute
  * ``combine``   (nb, m, bn), (n_sys, m) -> (nb * bn,)     the jump blend

Each pass has a hand-written CUDA kernel (``csrc/arena.cu``) and a plain
PyTorch twin (``*_ref``). The wrappers route by device: CPU tensors take
the twin, CUDA tensors take the kernel or raise. Every kernel launch adds
one to its entry in ``LAUNCHES``. Pad lanes are zero, so padding is exact
in every inner product.

``gram_row`` (K1, every recorded step) makes its kernel's choices for each
call, in plain Python: whether its loads are 16 bytes wide
(``device.vector_lanes``), whether the query is a slot of the buffer
(``device.query_slot`` along the slot axis) and how many CTAs the grid has
(``grid_ctas``: one wave over all blocks, two CTAs per SM where m <= 16);
its per-system integer tickets are ``device.tickets``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import device as _device
from repro_torch.kernels.device import (DTYPES, MAX_M, launch, on_cuda,
                                        resolve_device, sm_count, stream)

CTAS_PER_SM = 2                  # K1's CTAs per SM for m <= 16 (one above)

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"gram_row": 0, "gram": 0, "combine": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class Segments:
    """A bucket's block -> system table, in the form the kernels take:
    ``block_sys`` (nb,) int32 sorted, and ``sys_off`` (n_sys + 1,) int32,
    the first block of each system (system s owns blocks
    ``[sys_off[s], sys_off[s+1])``). Build once per table and device."""
    block_sys: torch.Tensor
    sys_off: torch.Tensor
    n_sys: int

    @classmethod
    def from_block_sys(cls, block_sys, n_sys: int, device="cuda"
                       ) -> "Segments":
        device = resolve_device(device)
        bs = np.asarray(block_sys, np.int32)
        if bs.ndim != 1 or (np.diff(bs) < 0).any():
            raise ValueError("block_sys must be a sorted 1-D table")
        if bs.size and (bs[0] < 0 or bs[-1] >= n_sys):
            raise ValueError(f"block_sys entries outside [0, {n_sys})")
        off = np.searchsorted(bs, np.arange(n_sys + 1)).astype(np.int32)
        return cls(torch.as_tensor(bs, device=device),
                   torch.as_tensor(off, device=device), int(n_sys))


# ---------------------------------------------------------------------------
# Plain PyTorch twins: fp32 contractions, one batched product and one
# segment sum per pass
# ---------------------------------------------------------------------------

def _segment_sum(part: torch.Tensor, block_sys: torch.Tensor,
                 n_sys: int) -> torch.Tensor:
    out = part.new_zeros((n_sys,) + part.shape[1:])
    return out.index_add_(0, block_sys.to(part.device, torch.long), part)


def gram_row_ref(x: torch.Tensor, q: torch.Tensor, block_sys, n_sys: int, *,
                 anchor_first: bool = False) -> torch.Tensor:
    """(nb, m, bn), (nb, bn) -> (n_sys, m) of <d_q, d_j> per system.

    Anchoring uses the partials identity instead of materialising the
    anchored buffer: with qa = q - x0, <qa, x_j - x0> = <qa, x_j> - <qa, x0>,
    so only q is anchored and column 0 of the raw partials is subtracted
    afterwards. Exact on integer-valued data; under rounding it differs from
    explicit anchoring by summation-order effects only."""
    xf = x.float()
    qf = q.float()
    if anchor_first:
        qf = qf - xf[:, 0, :]
    part = torch.bmm(xf, qf.unsqueeze(-1)).squeeze(-1)          # (nb, m)
    if anchor_first:
        part = part - part[:, 0:1]
    return _segment_sum(part, torch.as_tensor(block_sys), n_sys)


def gram_ref(x: torch.Tensor, block_sys, n_sys: int, *,
             anchor_first: bool = False,
             anchor_mean: bool = False) -> torch.Tensor:
    """(nb, m, bn) -> (n_sys, m, m) full Grams, one per system. The anchor
    (row 0, or the per-lane mean over the m rows) is subtracted
    explicitly."""
    if anchor_first and anchor_mean:
        raise ValueError("anchor_first and anchor_mean are exclusive")
    xf = x.float()
    if anchor_first:
        xf = xf - xf[:, 0:1, :]
    if anchor_mean:
        xf = xf - xf.mean(dim=1, keepdim=True)
    part = torch.bmm(xf, xf.transpose(1, 2))                    # (nb, m, m)
    return _segment_sum(part, torch.as_tensor(block_sys), n_sys)


def combine_ref(x: torch.Tensor, c: torch.Tensor, block_sys) -> torch.Tensor:
    """(nb, m, bn), (n_sys, m) -> (nb * bn,) = S^T c, each block with its
    own system's coefficients, in fp32."""
    xf = x.float()
    idx = torch.as_tensor(block_sys).to(x.device, torch.long)
    cb = c.float()[idx]                                         # (nb, m)
    return torch.bmm(cb.unsqueeze(1), xf).reshape(-1)


# ---------------------------------------------------------------------------
# Wrappers: checks, then the kernel (CUDA) or the twin (CPU)
# ---------------------------------------------------------------------------

def _check_buffer(x: torch.Tensor) -> None:
    if x.dim() != 3 or x.dtype not in DTYPES:
        raise ValueError(f"buffer must be (nb, m, bn) float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    nb, m, bn = x.shape
    if nb < 1 or bn < 1 or not 1 <= m <= MAX_M:
        raise ValueError(f"buffer shape {tuple(x.shape)}: need nb, bn >= 1 "
                         f"and 1 <= m <= {MAX_M}")
    if not x.is_contiguous():
        raise ValueError("buffer must be contiguous")


def _check_segments(seg: Segments, nb: int, device: torch.device) -> None:
    if seg.block_sys.shape != (nb,) or seg.sys_off.shape != (seg.n_sys + 1,):
        raise ValueError(f"segment table for {seg.block_sys.shape[0]} blocks "
                         f"and {seg.n_sys} systems does not fit {nb} blocks")
    for t in (seg.block_sys, seg.sys_off):
        if t.dtype != torch.int32 or t.device != device:
            raise ValueError(f"segment tables must be int32 on {device}")


def grid_ctas(nb: int, m: int, sms: int) -> int:
    """K1's grid, one wave: CTAS_PER_SM CTAs per SM where m <= 16 (the
    registers of two fit on an SM), else one; each CTA a contiguous range
    of at least one block."""
    per_sm = CTAS_PER_SM if m <= 16 else 1
    return max(1, min(nb, per_sm * sms))


def gram_row(buf: torch.Tensor, q: torch.Tensor, seg: Segments, *,
             anchor_first: bool = False) -> torch.Tensor:
    """One streaming Gram row per system, one launch for the whole arena.
    ``q`` is (nb, bn) with unit lane stride; its rows may be strided, so a
    slot of the ring buffer itself (``buf[:, slot, :]``) is passed without a
    copy."""
    _check_buffer(buf)
    nb, m, bn = buf.shape
    if q.shape != (nb, bn) or q.dtype != buf.dtype or q.stride(1) != 1:
        raise ValueError(f"query must be ({nb}, {bn}) {buf.dtype} with unit "
                         f"lane stride, got {tuple(q.shape)} {q.dtype} "
                         f"strides {q.stride()}")
    cuda = on_cuda(buf, q, seg.block_sys)
    _check_segments(seg, nb, buf.device)
    if not cuda:
        return gram_row_ref(buf, q, seg.block_sys, seg.n_sys,
                            anchor_first=anchor_first)
    ctas = grid_ctas(nb, m, sm_count(buf.device))
    # one partial per (CTA, system) pair; CTA c's pair with system s is row
    # c + s, so ctas + n_sys rows hold them all
    part = torch.empty((ctas + seg.n_sys, m), dtype=torch.float32,
                       device=buf.device)
    out = torch.empty((seg.n_sys, m), dtype=torch.float32, device=buf.device)
    st = stream()
    launch("arena_gram_row", DTYPES[buf.dtype], buf.data_ptr(),
           q.data_ptr(), q.stride(0),
           _device.query_slot(buf, q, axis=1),
           seg.block_sys.data_ptr(), seg.sys_off.data_ptr(),
           part.data_ptr(),
           _device.tickets(buf.device, st, seg.n_sys).data_ptr(),
           out.data_ptr(), nb, m, bn, seg.n_sys, ctas,
           int(_device.vector_lanes(buf, q)), int(anchor_first), st)
    LAUNCHES["gram_row"] += 1
    return out


def gram(buf: torch.Tensor, seg: Segments, *, anchor_first: bool = False,
         anchor_mean: bool = False) -> torch.Tensor:
    """Full (n_sys, m, m) Gram recompute, one launch for the whole arena
    (the ``streaming_gram=False`` path and mean-anchored buckets)."""
    if anchor_first and anchor_mean:
        raise ValueError("anchor_first and anchor_mean are exclusive")
    _check_buffer(buf)
    nb, m, bn = buf.shape
    cuda = on_cuda(buf, seg.block_sys)
    _check_segments(seg, nb, buf.device)
    if not cuda:
        return gram_ref(buf, seg.block_sys, seg.n_sys,
                        anchor_first=anchor_first, anchor_mean=anchor_mean)
    part = torch.empty((nb, m, m), dtype=torch.float32, device=buf.device)
    out = torch.empty((seg.n_sys, m, m), dtype=torch.float32,
                      device=buf.device)
    anchor = 1 if anchor_first else (2 if anchor_mean else 0)
    launch("arena_gram", DTYPES[buf.dtype], buf.data_ptr(),
            part.data_ptr(), seg.sys_off.data_ptr(), out.data_ptr(), nb, m,
            bn, seg.n_sys, anchor, stream())
    LAUNCHES["gram"] += 1
    return out


def combine(buf: torch.Tensor, c: torch.Tensor, seg: Segments
            ) -> torch.Tensor:
    """(nb * bn,) fp32 jump blend, one launch: block i gets
    ``c[block_sys[i]] . buf[i]``."""
    _check_buffer(buf)
    nb, m, bn = buf.shape
    if c.shape != (seg.n_sys, m) or c.dtype != torch.float32 \
            or not c.is_contiguous():
        raise ValueError(f"coefficients must be contiguous float32 "
                         f"({seg.n_sys}, {m}), got {tuple(c.shape)} "
                         f"{c.dtype}")
    cuda = on_cuda(buf, c, seg.block_sys)
    _check_segments(seg, nb, buf.device)
    if not cuda:
        return combine_ref(buf, c, seg.block_sys)
    out = torch.empty((nb * bn,), dtype=torch.float32, device=buf.device)
    launch("arena_combine", DTYPES[buf.dtype], buf.data_ptr(),
            c.data_ptr(), seg.block_sys.data_ptr(), out.data_ptr(), nb, m,
            bn, stream())
    LAUNCHES["combine"] += 1
    return out
