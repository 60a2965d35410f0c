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
its per-system integer tickets are ``device.tickets``. ``gram`` (K3) runs
on the same grid at GRAM_CTAS_PER_SM (``gram_grid``), with the same load
width rule (``vector_lanes(buf)``) and tickets.

``combine`` is differentiable in ``c`` (the controller's meta-tuning
backpropagates the gate loss through the jump): when ``c`` requires grad it
runs as ``CombineFn``, whose backward ``dc[s, k] = sum over the blocks of
s of <S[i, k, :], dw[i, :]>`` is a Gram-row pass with ``dw`` as the query
and no anchor, i.e. K1 itself. Each such launch also counts under
``BWD_LAUNCHES["gram_row_bwd"]``. The buffer takes no gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import Spec
from repro_torch.kernels import device as _device
from repro_torch.kernels.device import (DTYPES, MAX_M, acc_dtype, launch,
                                        on_cuda, resolve_device, sm_count,
                                        stream, twin_only)

CTAS_PER_SM = 2                  # K1's CTAs per SM for m <= 16 (one above)
GRAM_CTAS_PER_SM = 1             # K3's: its m(m+1)/2 sums fill the registers

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"gram_row": 0, "gram": 0, "combine": 0}
# the gram_row launches made as combine's backward (a design counter: a
# subset of LAUNCHES["gram_row"])
BWD_LAUNCHES = {"gram_row_bwd": 0}


def reset_launches() -> None:
    for counter in (LAUNCHES, BWD_LAUNCHES):
        for k in counter:
            counter[k] = 0


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
    xf = x.to(acc_dtype(x))
    qf = q.to(xf.dtype)
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
    xf = x.to(acc_dtype(x))
    if anchor_first:
        xf = xf - xf[:, 0:1, :]
    if anchor_mean:
        xf = xf - xf.mean(dim=1, keepdim=True)
    part = torch.bmm(xf, xf.transpose(1, 2))                    # (nb, m, m)
    return _segment_sum(part, torch.as_tensor(block_sys), n_sys)


def combine_ref(x: torch.Tensor, c: torch.Tensor, block_sys) -> torch.Tensor:
    """(nb, m, bn), (n_sys, m) -> (nb * bn,) = S^T c, each block with its
    own system's coefficients, in fp32. The m products of a lane are
    summed in snapshot order, one multiply and one add each, as the
    per-leaf twin (``kernels/combine.py``) sums them: the two routes give
    the same bits on the same coefficients."""
    xf = x.double()
    idx = torch.as_tensor(block_sys).to(x.device, torch.long)
    cb = c.double()[idx]                                        # (nb, m)
    out = cb[:, 0:1] * xf[:, 0, :]
    for j in range(1, x.shape[1]):
        out = out + cb[:, j:j + 1] * xf[:, j, :]
    return out.reshape(-1).to(acc_dtype(x))


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


def grid_ctas(nb: int, m: int, sms: int, per_sm: int = CTAS_PER_SM) -> int:
    """K1's grid, one wave: `per_sm` CTAs per SM where m <= 16 (the
    registers of two K1 CTAs fit on an SM), else one; each CTA a contiguous
    range of at least one block. K3 takes it with GRAM_CTAS_PER_SM."""
    per_sm = per_sm if m <= 16 else 1
    return max(1, min(nb, per_sm * sms))


def gram_grid(nb: int, m: int, n_sys: int, sms: int) -> tuple[int, int]:
    """K3's grid and scratch: (CTAs, floats of its partial buffer). The
    grid is K1's at GRAM_CTAS_PER_SM; CTA c's partial for system s (its
    upper triangle, m(m+1)/2 floats) is row c + s, so ctas + n_sys rows
    hold them all."""
    ctas = grid_ctas(nb, m, sms, GRAM_CTAS_PER_SM)
    return ctas, (ctas + n_sys) * (m * (m + 1) // 2)


# ---------------------------------------------------------------------------
# Under a mesh: each rank's block of a bucket, then one all-reduce
# ---------------------------------------------------------------------------

def shard_wrap(mesh, lane_axes: Tuple[str, ...], fn: Callable) -> Callable:
    """The shard contract of the three passes: ``fn`` runs on this rank's
    block (K1 / K3 / K2 on the local blocks), then its output is summed
    over `lane_axes` with ONE all-reduce. No mesh or no sharded lanes: the
    local computation is the global one."""
    if mesh is None or not lane_axes:
        return fn

    def wrapped(*args, **kwargs):
        return mesh.all_reduce(fn(*args, **kwargs), lane_axes)
    return wrapped


def _axis_entry(axes: Tuple[str, ...]):
    """One spec entry for a (possibly multi-axis) set of mesh axes."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def lane_spec(lane_axes: Tuple[str, ...]) -> Spec:
    """Spec of a bucket's flat 1-D lane axis (pack / unpack rows, the
    combine's output)."""
    return Spec(_axis_entry(lane_axes))


def buf_spec(axes: Tuple[str, ...]) -> Spec:
    """Spec of a block-major (n_blocks, m, block_n) ring buffer: the axes
    that shard the flat lane axis shard its leading BLOCK axis (each
    rank's lane count is a block multiple, so shard boundaries are block
    boundaries)."""
    return Spec(_axis_entry(axes), None, None)


def gram_row(buf: torch.Tensor, q: torch.Tensor, seg: Segments, *,
             anchor_first: bool = False, mesh=None,
             lane_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """One streaming Gram row per system of this rank's block, one launch
    (K1). A lane-sharded bucket (`lane_axes`) sums the partial rows with
    one O(n_sys*m) all-reduce; a system-sharded one (each rank owns whole
    systems) needs none, and its rows stay this rank's."""
    return shard_wrap(mesh, lane_axes, _gram_row)(
        buf, q, seg, anchor_first=anchor_first)


@_device.opaque("gram_row")
def _gram_row(buf: torch.Tensor, q: torch.Tensor, seg: Segments, *,
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
         anchor_mean: bool = False, mesh=None,
         lane_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """Full (n_sys, m, m) Grams of this rank's block, one launch (K3), then
    one O(n_sys*m^2) all-reduce over `lane_axes`; a system-sharded
    bucket's Grams stay this rank's."""
    return shard_wrap(mesh, lane_axes, _gram)(
        buf, seg, anchor_first=anchor_first, anchor_mean=anchor_mean)


@_device.opaque("gram")
def _gram(buf: torch.Tensor, seg: Segments, *, anchor_first: bool = False,
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
    ctas, n_part = gram_grid(nb, m, seg.n_sys, sm_count(buf.device))
    part = torch.empty((n_part,), dtype=torch.float32, device=buf.device)
    out = torch.empty((seg.n_sys, m, m), dtype=torch.float32,
                      device=buf.device)
    anchor = 1 if anchor_first else (2 if anchor_mean else 0)
    st = stream()
    launch("arena_gram", DTYPES[buf.dtype], buf.data_ptr(),
           seg.block_sys.data_ptr(), seg.sys_off.data_ptr(),
           part.data_ptr(),
           _device.tickets(buf.device, st, seg.n_sys).data_ptr(),
           out.data_ptr(), nb, m, bn, seg.n_sys, ctas,
           int(_device.vector_lanes(buf)), anchor, st)
    LAUNCHES["gram"] += 1
    return out


@_device.opaque("combine")
def combine(buf: torch.Tensor, c: torch.Tensor, seg: Segments, *,
            mesh=None, lane_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """(nb * bn,) fp32 jump blend of this rank's block, one launch: block i
    gets ``c[block_sys[i]] . buf[i]``. No collective: `c` holds this rank's
    systems, and the output has the bucket's lane layout. Differentiable
    in ``c`` (``CombineFn``) when ``c`` requires grad; under a mesh its
    backward sums the K1 partials over `lane_axes`."""
    if torch.is_grad_enabled() and c.requires_grad:
        return CombineFn.apply(buf, c, seg, mesh, tuple(lane_axes))
    return _combine(buf, c, seg)


def _combine(buf: torch.Tensor, c: torch.Tensor, seg: Segments
             ) -> torch.Tensor:
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


class CombineFn(torch.autograd.Function):
    """K2 with a gradient in ``c``: forward is ``_combine`` (K2 on the card,
    the twin on the CPU); backward is K1 (``gram_row``) with the cotangent
    ``dw`` as the query and no anchor, which sums ``S[i, k, :] . dw[i, :]``
    over each system's blocks. K1 takes a query of the buffer's dtype, so
    with a bf16 ``snapshot_dtype`` the fp32 cotangent is rounded to bf16
    (2^-8 relative per lane) before the pass; the sums stay fp32. The
    controller's meta-tuning reads only the sign of the knob gradients."""

    @staticmethod
    def forward(ctx, buf, c, seg, mesh=None, lane_axes=()):
        ctx.save_for_backward(buf)
        ctx.seg = seg
        ctx.mesh, ctx.lane_axes = mesh, lane_axes
        ctx.c_dtype = c.dtype
        if twin_only(buf):
            return combine_ref(buf, c.detach(), seg.block_sys)
        return _combine(buf, c.detach(), seg)

    @staticmethod
    def backward(ctx, dw):
        (buf,) = ctx.saved_tensors
        nb, _, bn = buf.shape
        seg = ctx.seg
        q = dw.reshape(nb, bn).to(buf.dtype).contiguous()
        if twin_only(buf):
            dc = shard_wrap(ctx.mesh, ctx.lane_axes, gram_row_ref)(
                buf, q, seg.block_sys, seg.n_sys)
        else:
            dc = gram_row(buf, q, seg, mesh=ctx.mesh,
                          lane_axes=ctx.lane_axes)
        if buf.is_cuda:
            BWD_LAUNCHES["gram_row_bwd"] += 1
        return None, dc.to(ctx.c_dtype), None, None, None
