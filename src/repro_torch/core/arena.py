"""Packed leaf arenas: one buffer, one launch, one solve per bucket (§7).

All DMD-managed leaves of one schedule group and dtype are packed into one
bucket with an offset/length table (``ArenaSegment``). Each system (an
unstacked leaf, or one layer of a stacked leaf) is padded to a multiple of
the bucket's ``block_n``, so the segmented kernels of ``kernels/arena.py``
walk the whole bucket in one launch with no block straddling two systems.

State, per bucket key:

    buffers  (n_blocks, m, block_n)  snapshot ring buffer, BLOCK-MAJOR
    grams    (n_sys, m, m) fp32      streaming Grams

Block-major means each ``block_n``-lane block carries its m snapshot rows
contiguously: the kernel tile is the storage tile, and a record writes one
``(n_blocks, 1, block_n)`` slab. Flat ``(N,)`` rows appear only at the pack
and jump boundaries. Both are updated IN PLACE (``record`` writes the slot,
``update_grams`` its Gram row and column): at the paper's MLP the buffer
is 161.5 MB, and a functional update would copy it on every step.

Not ported yet: a mesh (sharded buckets), bucket scope, residency and the
leaf-wise checkpoint views (ROADMAP Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dmd as dmd_math
from repro_torch.core.leafplan import LeafPlan, plan_entries
from repro_torch.core.paths import by_path
from repro_torch.core.schedule import GroupSchedule
from repro_torch.kernels import arena as ka
from repro_torch.kernels.ops import lane_block


@dataclass(frozen=True)
class ArenaSegment:
    """One leaf's slice of a bucket's lane axis: ``n_sys`` consecutive
    systems of ``seg_lanes`` lanes each (``flat_local`` real + zero
    tail)."""
    path: str
    sys_start: int                 # first system index within the bucket
    lane_start: int                # first lane
    n_sys: int                     # DMD systems in this leaf
    flat_local: int                # real lanes per system (unpadded)
    seg_lanes: int                 # padded lanes per system (block multiple)
    shape: Tuple[int, ...]
    stack_dims: int
    param_dtype: str

    @property
    def lanes(self) -> int:
        return self.n_sys * self.seg_lanes


@dataclass(frozen=True)
class ArenaBucket:
    """One packed arena: all leaves of one (group, dtype) class."""
    key: str
    group: int
    sched: GroupSchedule
    block_n: int
    segments: Tuple[ArenaSegment, ...]
    # device copies of the block -> system tables, built once per device
    _device_tables: Dict[str, ka.Segments] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def m(self) -> int:
        return self.sched.m

    @property
    def n_sys(self) -> int:
        return sum(s.n_sys for s in self.segments)

    @property
    def n_lanes(self) -> int:
        return sum(s.lanes for s in self.segments)

    @property
    def n_blocks(self) -> int:
        return self.n_lanes // self.block_n

    def block_sys(self) -> np.ndarray:
        """Block -> system-index table; blocks of one system are
        consecutive."""
        parts = [np.repeat(
            np.arange(s.sys_start, s.sys_start + s.n_sys, dtype=np.int32),
            s.seg_lanes // self.block_n) for s in self.segments]
        return np.concatenate(parts) if parts else np.zeros(0, np.int32)

    def tables_on(self, device: torch.device) -> ka.Segments:
        """The kernels' segment tables on `device`, copied there once."""
        name = str(device)
        if name not in self._device_tables:
            self._device_tables[name] = ka.Segments.from_block_sys(
                self.block_sys(), self.n_sys, device)
        return self._device_tables[name]


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------

def arena_eligible(plan: LeafPlan, cfg) -> bool:
    """A leaf joins an arena unless arenas are off or its route is forced
    to the ``dot_general`` oracle."""
    return bool(cfg.arena) and plan.route != "dot_general"


def build_arenas(plans, cfg) -> Dict[str, ArenaBucket]:
    """LeafPlan tree -> {bucket_key: ArenaBucket}, leaves in tree order.
    Bucket key = (schedule group, param dtype); ``block_n`` is
    ``lane_block(cfg.arena_block_n, widest member)``."""
    grouped: Dict[str, List[LeafPlan]] = {}
    for plan in plan_entries(plans):
        if arena_eligible(plan, cfg):
            grouped.setdefault(f"g{plan.group}-{plan.dtype}", []).append(plan)

    out: Dict[str, ArenaBucket] = {}
    for key in sorted(grouped):
        members = grouped[key]
        block_n = lane_block(int(cfg.arena_block_n),
                             max(p.flat_size for p in members))
        segs: List[ArenaSegment] = []
        sys_i = lane_i = 0
        for plan in members:
            n_sys = int(np.prod(plan.shape[:plan.stack_dims], dtype=np.int64))
            seg_lanes = -(-plan.flat_size // block_n) * block_n
            segs.append(ArenaSegment(
                path=plan.path, sys_start=sys_i, lane_start=lane_i,
                n_sys=n_sys, flat_local=plan.flat_size, seg_lanes=seg_lanes,
                shape=plan.shape, stack_dims=plan.stack_dims,
                param_dtype=plan.dtype))
            sys_i += n_sys
            lane_i += n_sys * seg_lanes
        out[key] = ArenaBucket(key=key, group=members[0].group,
                               sched=members[0].sched, block_n=block_n,
                               segments=tuple(segs))
    return out


def arena_paths(table: Dict[str, ArenaBucket]) -> frozenset:
    return frozenset(s.path for b in table.values() for s in b.segments)


def layout_table(table: Dict[str, ArenaBucket]) -> list:
    """JSON-able rows of the packed layout, one per bucket, with the
    reference's field names (leaf scope, no mesh)."""
    out = []
    for key in sorted(table):
        b = table[key]
        out.append({
            "key": b.key, "group": b.group, "m": b.m, "scope": "leaf",
            "n_solve": b.n_sys, "block_n": b.block_n, "n_sys": b.n_sys,
            "n_lanes": b.n_lanes,
            "segments": [{
                "path": s.path, "sys_start": s.sys_start,
                "lane_start": s.lane_start, "n_sys": s.n_sys,
                "flat_local": s.flat_local, "seg_lanes": s.seg_lanes,
                "shape": list(s.shape), "stack_dims": s.stack_dims,
                "param_dtype": s.param_dtype,
            } for s in b.segments],
        })
    return out


def snapshot_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.snapshot_dtype)


def init_arena_buffers(table: Dict[str, ArenaBucket], cfg,
                       device) -> Dict[str, torch.Tensor]:
    return {key: torch.zeros((b.n_blocks, b.m, b.block_n),
                             dtype=snapshot_dtype(cfg), device=device)
            for key, b in table.items()}


def init_arena_grams(table: Dict[str, ArenaBucket], device
                     ) -> Dict[str, torch.Tensor]:
    return {key: torch.zeros((b.n_sys, b.m, b.m), dtype=torch.float32,
                             device=device)
            for key, b in table.items()}


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------

def _pack_leaf(x: torch.Tensor, seg: ArenaSegment, dtype) -> torch.Tensor:
    """(stack..., rest...) -> (n_sys * seg_lanes,) zero-padded."""
    x = x.to(dtype).reshape(seg.n_sys, seg.flat_local)
    if seg.seg_lanes != seg.flat_local:
        x = F.pad(x, (0, seg.seg_lanes - seg.flat_local))
    return x.reshape(-1)


def _unpack_leaf(row: torch.Tensor, seg: ArenaSegment) -> torch.Tensor:
    """(N,) -> the leaf's shape (a view where the layout allows)."""
    x = row[seg.lane_start:seg.lane_start + seg.lanes]
    x = x.reshape(seg.n_sys, seg.seg_lanes)[:, :seg.flat_local]
    return x.reshape(seg.shape)


def pack_row(bucket: ArenaBucket, params_by_path: Dict[str, torch.Tensor],
             dtype) -> torch.Tensor:
    """Current params -> one (N,) arena row (the `record` gather)."""
    return torch.cat([_pack_leaf(params_by_path[s.path], s, dtype)
                      for s in bucket.segments])


def _unpack_row(bucket: ArenaBucket, row: torch.Tensor
                ) -> List[torch.Tensor]:
    """One (N,) arena row -> per-leaf tensors (uncast)."""
    return [_unpack_leaf(row, s) for s in bucket.segments]


# ---------------------------------------------------------------------------
# record / streaming-Gram update (one launch per bucket)
# ---------------------------------------------------------------------------

def _bucket_slot(bucket: ArenaBucket, slot) -> int:
    """The bucket's write position: a per-group slot vector is indexed by
    the bucket's group; a scalar applies to every bucket."""
    if np.ndim(slot) == 1:
        return int(slot[bucket.group])
    return int(slot)


def record(arenas: Dict[str, torch.Tensor], params,
           slot, table: Dict[str, ArenaBucket], cfg
           ) -> Dict[str, torch.Tensor]:
    """Write the current params into each bucket's snapshot row `slot`, in
    place. Buckets with a negative slot (not recording) are skipped."""
    leaves = by_path(params)
    dtype = snapshot_dtype(cfg)
    for key, buf in arenas.items():
        b = table[key]
        s = _bucket_slot(b, slot)
        if s < 0:
            continue
        buf[:, s, :] = pack_row(b, leaves, dtype).view(b.n_blocks, b.block_n)
    return arenas


def update_grams(agrams: Dict[str, torch.Tensor],
                 arenas: Dict[str, torch.Tensor], slot, cfg,
                 table: Dict[str, ArenaBucket]) -> Dict[str, torch.Tensor]:
    """Streaming-Gram maintenance: ONE segmented gram_row launch per bucket
    gives every system's row, then one row+column write per bucket. The
    just-written slot of the ring buffer is the query, read in place."""
    for key, g in agrams.items():
        b = table[key]
        s = _bucket_slot(b, slot)
        if s < 0:
            continue
        buf = arenas[key]
        row = ka.gram_row(buf, buf[:, s, :], b.tables_on(buf.device),
                          anchor_first=cfg.anchor == "first")
        dmd_math.set_gram_row(g, row, s)
    return agrams


# ---------------------------------------------------------------------------
# The jump: one batched solve per group, one combine launch per bucket
# ---------------------------------------------------------------------------

def jump(cfg, table: Dict[str, ArenaBucket], params,
         arenas: Dict[str, torch.Tensor],
         agrams: Optional[Dict[str, torch.Tensor]], relax,
         groups: Optional[frozenset] = None
         ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """DMD jump over every bucket of the jumping groups.

    Returns ({path: new leaf (param dtype)}, [per-leaf mean rank]). Per
    group: concatenate the buckets' (n_sys, m, m) Grams, make ONE
    ``dmd_coefficients`` call, split the coefficient rows back per bucket,
    ONE segmented combine launch per bucket, then unpack per leaf. A bucket
    without a carried Gram (``agrams`` None or missing the key) gets the
    one-launch full recompute: the ``streaming_gram=False`` path, and the
    only Gram path for ``anchor="mean"``. `relax` is a scalar or a
    per-group vector."""
    leaves = by_path(params)
    per_group = np.ndim(relax) == 1
    updates: Dict[str, torch.Tensor] = {}
    ranks: List[torch.Tensor] = []
    by_gi: Dict[int, List[ArenaBucket]] = {}
    for key in sorted(table):
        by_gi.setdefault(table[key].group, []).append(table[key])

    for gi in sorted(by_gi):
        if groups is not None and gi not in groups:
            continue
        buckets = by_gi[gi]
        grams = []
        for b in buckets:
            g = agrams.get(b.key) if agrams is not None else None
            if g is None:
                buf = arenas[b.key]
                g = ka.gram(buf, b.tables_on(buf.device),
                            anchor_first=cfg.anchor == "first",
                            anchor_mean=cfg.anchor == "mean")
            grams.append(g)
        gcat = grams[0] if len(grams) == 1 else torch.cat(grams)
        sched = buckets[0].sched
        c, info = dmd_math.dmd_coefficients(
            gcat, s=sched.s, tol=cfg.tol, mode=cfg.mode, anchor=cfg.anchor,
            affine=cfg.affine, trust_region=cfg.trust_region,
            relax=float(relax[gi]) if per_group else float(relax),
            energy=sched.energy, atol=cfg.atol, ridge=sched.ridge)
        ofs = 0
        for b in buckets:
            cb = c[ofs:ofs + b.n_sys].contiguous()
            rb = info["rank"][ofs:ofs + b.n_sys]
            ofs += b.n_sys
            buf = arenas[b.key]
            flat = ka.combine(buf, cb, b.tables_on(buf.device))
            # a non-finite BUFFER poisons the combine even under
            # c = e_last (0 * inf = NaN): never leave params less finite
            # than the last snapshot
            flat = torch.where(torch.isfinite(flat), flat,
                               buf[:, -1, :].reshape(-1).float())
            for seg, leaf in zip(b.segments, _unpack_row(b, flat)):
                updates[seg.path] = leaf.to(leaves[seg.path].dtype)
                ranks.append(rb[seg.sys_start:seg.sys_start + seg.n_sys]
                             .float().mean())
    return updates, ranks
