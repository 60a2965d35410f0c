"""Packed leaf arenas: one buffer, one launch, one solve per bucket (§7).

All DMD-managed leaves of one schedule group and dtype are packed into one
bucket with an offset/length table (``ArenaSegment``). Each system (an
unstacked leaf, or one layer of a stacked leaf) is padded to a multiple of
the bucket's ``block_n``, so the segmented kernels of ``kernels/arena.py``
walk the whole bucket in one launch with no block straddling two systems.

The accelerator's state is the reference's two-route wrapper
``{"__arena__": {bucket_key: ...}, "leaf": per-leaf tree}`` whenever a
bucket exists (``make_state`` / ``split_state``); the per-leaf tree holds
None at every packed path and the ``core/snapshots.py`` state elsewhere.

State, per bucket key:

    buffers  (n_blocks, m, block_n)  snapshot ring buffer, BLOCK-MAJOR
    grams    (n_sys, m, m) fp32      streaming Grams

Block-major means each ``block_n``-lane block carries its m snapshot rows
contiguously: the kernel tile is the storage tile, and a record writes one
``(n_blocks, 1, block_n)`` slab. Flat ``(N,)`` rows appear only at the pack
and jump boundaries. Both are updated IN PLACE (``record`` writes the slot,
``update_grams`` its Gram row and column): at the paper's MLP the buffer
is 161.5 MB, and a functional update would copy it on every step.

Parameter residency (``dmd.arena_native``, DESIGN.md §7): while
``Trainer.fit`` runs, the packed params (and elementwise optimizer
moments) live in their bucket's contiguous ``(N,)`` flat buffer, in the
same wrapper layout, ``{"__arena__": {key: (N,) flat}, "leaf": tree with
None}``. ``tree_resident`` / ``tree_leafwise`` convert; ``tree_leafwise``
also gives the model's forward its per-leaf VIEWS of the flat buffer
(slice + reshape, no copy), so gradients come back as one flat buffer
with zero pad lanes. With resident params ``record`` is one copy of the
flat buffer into the ring slot per bucket, and ``jump`` returns whole
flat rows per bucket (the caller writes them into the resident buffer).

Bucket scope (``dmd.scope="bucket"``, DESIGN.md §9): each bucket is ONE
Koopman system over its concatenated state. The same kernels run with
the bucket's all-zeros block table (``scope_block_sys``, n_sys 1): K1 and
K3 then sum every block into one (1, m) row / (1, m, m) Gram, the
segment-sum of the per-system ones (pad lanes are zero and every segment
shares the bucket's slot schedule), the jump solves one system per bucket
(``gram_lead``) and K2 broadcasts its one coefficient row to every block.

Checkpoints are written leaf-wise in both scopes: ``buffers_leafwise`` /
``grams_leafwise`` unpack the buckets into the per-leaf layout of
``arena=False`` (a bucket-scoped Gram cannot be split, so K3 rebuilds the
per-system Grams from the buffers) and ``buffers_from_leafwise`` /
``grams_from_leafwise`` pack it back (segment-summed in bucket scope), so
the on-disk format depends neither on ``dmd.arena`` nor on the scope.

Not ported yet: a mesh (sharded buckets; ROADMAP Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dmd as dmd_math
from repro_torch.core.leafplan import LeafPlan, plan_entries
from repro_torch.core.paths import by_path, fill_paths, map_with_paths
from repro_torch.core.schedule import GroupSchedule
from repro_torch.kernels import arena as ka
from repro_torch.kernels.ops import lane_block

ARENA_KEY = "__arena__"


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
    # and scope
    _device_tables: Dict[Tuple[str, bool], ka.Segments] = field(
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

    # ---- dmd.scope (DESIGN.md §9) -----------------------------------------
    def bucket_scoped(self, scope: str) -> bool:
        """True when this bucket carries ONE shared Koopman system under
        `scope` ("leaf" or "bucket"; anything else raises)."""
        if scope not in ("leaf", "bucket"):
            raise ValueError(f"unknown dmd.scope {scope!r}")
        return scope == "bucket"

    def gram_lead(self, scope: str) -> int:
        """Leading dim of the carried Gram stack, and the bucket's share of
        the group's batched coefficient solve, under `scope`."""
        return 1 if self.bucket_scoped(scope) else self.n_sys

    def scope_block_sys(self, scope: str) -> np.ndarray:
        """The block -> system table the kernels walk under `scope`: bucket
        scope maps every block to system 0."""
        if self.bucket_scoped(scope):
            return np.zeros(self.n_blocks, np.int32)
        return self.block_sys()

    def scope_n_sys(self, scope: str) -> int:
        """The system count the kernels see under `scope`."""
        return 1 if self.bucket_scoped(scope) else self.n_sys

    def tables_on(self, device: torch.device, scope: str = "leaf"
                  ) -> ka.Segments:
        """The kernels' segment tables under `scope` on `device`, copied
        there once per device and scope."""
        key = (str(device), self.bucket_scoped(scope))
        if key not in self._device_tables:
            self._device_tables[key] = ka.Segments.from_block_sys(
                self.scope_block_sys(scope), self.scope_n_sys(scope), device)
        return self._device_tables[key]


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


def layout_table(table: Dict[str, ArenaBucket], scope: str = "leaf"
                 ) -> list:
    """JSON-able rows of the packed layout, one per bucket, with the
    reference's field names (no mesh). `scope` stamps each bucket's DMD
    granularity and its solve share (``n_solve``)."""
    out = []
    for key in sorted(table):
        b = table[key]
        out.append({
            "key": b.key, "group": b.group, "m": b.m,
            "scope": "bucket" if b.bucket_scoped(scope) else "leaf",
            "n_solve": b.gram_lead(scope), "block_n": b.block_n,
            "n_sys": b.n_sys,
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


# ---------------------------------------------------------------------------
# State: the {"__arena__": ..., "leaf": ...} wrapper
# ---------------------------------------------------------------------------

def is_arena_state(x) -> bool:
    return isinstance(x, dict) and ARENA_KEY in x


def make_state(arenas: Dict[str, torch.Tensor], leaf) -> dict:
    return {ARENA_KEY: arenas, "leaf": leaf}


def split_state(x) -> Tuple[Dict[str, torch.Tensor], object]:
    return x[ARENA_KEY], x["leaf"]


def snapshot_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.snapshot_dtype)


def init_arena_buffers(table: Dict[str, ArenaBucket], cfg,
                       device) -> Dict[str, torch.Tensor]:
    return {key: torch.zeros((b.n_blocks, b.m, b.block_n),
                             dtype=snapshot_dtype(cfg), device=device)
            for key, b in table.items()}


def init_arena_grams(table: Dict[str, ArenaBucket], device,
                     scope: str = "leaf") -> Dict[str, torch.Tensor]:
    """Zeroed Gram stacks: (n_sys, m, m) per bucket in leaf scope, the one
    (1, m, m) shared-operator Gram in bucket scope."""
    return {key: torch.zeros((b.gram_lead(scope), b.m, b.m),
                             dtype=torch.float32, device=device)
            for key, b in table.items()}


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------

def _pack_leaf(x: torch.Tensor, seg: ArenaSegment, dtype,
              lead: int = 0) -> torch.Tensor:
    """(lead..., stack..., rest...) -> (lead..., n_sys * seg_lanes)
    zero-padded."""
    lead_shape = tuple(x.shape[:lead])
    x = x.to(dtype).reshape(lead_shape + (seg.n_sys, seg.flat_local))
    if seg.seg_lanes != seg.flat_local:
        x = F.pad(x, (0, seg.seg_lanes - seg.flat_local))
    return x.reshape(lead_shape + (-1,))


def _unpack_leaf(row: torch.Tensor, seg: ArenaSegment) -> torch.Tensor:
    """(lead..., N) -> (lead..., *leaf shape) (a view where the layout
    allows)."""
    lead = tuple(row.shape[:-1])
    x = row[..., seg.lane_start:seg.lane_start + seg.lanes]
    x = x.reshape(lead + (seg.n_sys, seg.seg_lanes))[..., :seg.flat_local]
    return x.reshape(lead + seg.shape)


def pack_row(bucket: ArenaBucket, params_by_path: Dict[str, torch.Tensor],
             dtype) -> torch.Tensor:
    """Current params -> one (N,) arena row (the `record` gather)."""
    return torch.cat([_pack_leaf(params_by_path[s.path], s, dtype)
                      for s in bucket.segments])


def _unpack_row(bucket: ArenaBucket, row: torch.Tensor
                ) -> List[torch.Tensor]:
    """(lead..., N) arena rows -> per-leaf tensors (uncast)."""
    return [_unpack_leaf(row, s) for s in bucket.segments]


# ---------------------------------------------------------------------------
# Parameter residency: params / moments live in the bucket's flat buffer
# ---------------------------------------------------------------------------

def tree_resident(table: Dict[str, ArenaBucket], tree) -> dict:
    """Move every packed leaf of a params-shaped `tree` into its bucket's
    contiguous ``(N,)`` flat buffer, in that leaf's own dtype (param dtype
    for params, fp32 for moments), pad lanes zero; packed paths of the
    ``leaf`` subtree become None. Inverse: ``tree_leafwise``."""
    leaves = by_path(tree)
    arenas = {key: pack_row(table[key], leaves,
                            leaves[table[key].segments[0].path].dtype)
              for key in sorted(table)}
    packed = arena_paths(table)
    return make_state(arenas, map_with_paths(
        lambda path, x: None if path in packed else x, tree))


def tree_leafwise(table: Dict[str, ArenaBucket], wrapper) -> object:
    """Resident wrapper -> per-leaf tree whose packed leaves are VIEWS of
    the flat buffers (slice + reshape; no copy where the segment has no
    padding inside a stacked leaf). Also the model's view of resident
    params: gradients of a loss of these views flow back into the flat
    buffer, zero at the pad lanes."""
    arenas, leaf = split_state(wrapper)
    views: Dict[str, torch.Tensor] = {}
    for key, row in arenas.items():
        for seg, x in zip(table[key].segments, _unpack_row(table[key], row)):
            views[seg.path] = x
    return fill_paths(leaf, views)


def unwrap_resident(table: Dict[str, ArenaBucket], tree):
    """An optimizer state (a resident wrapper, a NamedTuple of fields that
    may be wrappers, or anything else) with every wrapper expanded by
    ``tree_leafwise``."""
    if is_arena_state(tree):
        return tree_leafwise(table, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(unwrap_resident(table, f) for f in tree))
    return tree


# ---------------------------------------------------------------------------
# Leaf-wise views (the checkpoint format)
# ---------------------------------------------------------------------------

def buffers_leafwise(table: Dict[str, ArenaBucket],
                     arenas: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """{path: (m, *shape) buffer}: the per-leaf layout an ``arena=False``
    run carries, copied out of the block-major buffers (re-slabbed to
    snapshot-major (m, N) first)."""
    out = {}
    for key, buf in arenas.items():
        b = table[key]
        slab = buf.transpose(0, 1).reshape(b.m, b.n_lanes)
        for seg, x in zip(b.segments, _unpack_row(b, slab)):
            out[seg.path] = x
    return out


def grams_leafwise(table: Dict[str, ArenaBucket],
                   agrams: Dict[str, torch.Tensor], cfg=None,
                   arenas: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """{path: (stack..., m, m) Gram}: each leaf's systems of its bucket's
    (n_sys, m, m) Grams (views). A bucket-scoped (1, m, m) Gram cannot be
    split per leaf, so under ``cfg.scope="bucket"`` one K3 launch per
    bucket rebuilds the per-system Grams from the snapshot buffers
    (`arenas`, required then) with the bucket's real table;
    ``grams_from_leafwise`` sums them back. Mid-window, anchor="first"
    rows recomputed against the current anchor differ from the streamed
    ones of the previous window (which the next window overwrites)."""
    scope = cfg.scope if cfg is not None else "leaf"
    out = {}
    for key, g in agrams.items():
        b = table[key]
        if b.bucket_scoped(scope):
            if arenas is None:
                raise ValueError(
                    "bucket-scoped Grams need the snapshot buffers to "
                    "rebuild the leaf-wise form: pass cfg and arenas")
            buf = arenas[key]
            g = ka.gram(buf, b.tables_on(buf.device),
                        anchor_first=cfg.anchor == "first",
                        anchor_mean=cfg.anchor == "mean")
        for seg in b.segments:
            out[seg.path] = g[seg.sys_start:seg.sys_start + seg.n_sys] \
                .reshape(seg.shape[:seg.stack_dims] + (b.m, b.m))
    return out


def buffers_from_leafwise(table: Dict[str, ArenaBucket],
                          by_path_: Dict[str, torch.Tensor], cfg
                          ) -> Dict[str, torch.Tensor]:
    """Inverse of ``buffers_leafwise``: per-leaf (m, *shape) buffers
    packed into new block-major buffers in ``cfg.snapshot_dtype``, pad
    lanes zero."""
    dtype = snapshot_dtype(cfg)
    out = {}
    for key, b in table.items():
        slab = torch.cat([_pack_leaf(by_path_[s.path], s, dtype, lead=1)
                          for s in b.segments], dim=1)
        out[key] = slab.reshape(b.m, b.n_blocks, b.block_n) \
            .transpose(0, 1).contiguous()
    return out


def grams_from_leafwise(table: Dict[str, ArenaBucket],
                        by_path_: Dict[str, torch.Tensor],
                        scope: str = "leaf") -> Dict[str, torch.Tensor]:
    """Inverse of ``grams_leafwise``: new (n_sys, m, m) fp32 Grams; a
    bucket-scoped bucket sums them into its (1, m, m) Gram (exact on
    integer data: zero pads, one slot schedule), so checkpoints of either
    scope restore into the other."""
    out = {}
    for key, b in table.items():
        g = torch.cat([by_path_[s.path].float().reshape(s.n_sys, b.m, b.m)
                       for s in b.segments])
        out[key] = (g.sum(dim=0, keepdim=True) if b.bucket_scoped(scope)
                    else g)
    return out


def restream_grams(agrams: Dict[str, torch.Tensor],
                   arenas: Dict[str, torch.Tensor],
                   table: Dict[str, ArenaBucket], cfg, step: int
                   ) -> Dict[str, torch.Tensor]:
    """Rewrite the rows of a bucket-scoped Gram that the stream wrote in
    the current window before `step` (the next step to run), with K1 on
    the same buffer rows, in the order the stream wrote them, in place.

    A restored bucket Gram is the sum of K3's per-system recompute (the
    checkpoint is leaf-wise), which rounds differently from the K1 rows
    the uninterrupted run carries. Only the current window's entries reach
    the next jump (every later record rewrites its row and column), and
    K1's entry (i, j) depends only on slots i, j and the anchor: replaying
    slots 0..k of the window (k the slot of step - 1) gives the carried
    bits back, so a resumed run equals an uninterrupted one. A window
    that just jumped, or has not started, needs nothing. Leaf scope
    restores its Grams as they were written."""
    for key, g in agrams.items():
        b = table[key]
        if not b.bucket_scoped(cfg.scope):
            continue
        k = b.sched.slot(step - 1)
        if k < 0 or b.sched.should_apply(step - 1):
            continue
        buf = arenas[key]
        segs = b.tables_on(buf.device, cfg.scope)
        for s in range(k + 1):
            row = ka.gram_row(buf, buf[:, s, :], segs,
                              anchor_first=cfg.anchor == "first")
            dmd_math.set_gram_row(g, row, s)
    return agrams


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
           slot, table: Dict[str, ArenaBucket], cfg,
           group: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Write the current params into each bucket's snapshot row `slot`, in
    place: with resident params (the wrapper) one copy of the flat buffer
    per bucket, else the pack gather of every leaf. Buckets with a negative
    slot (not recording) or outside `group` (when given) are skipped."""
    resident = is_arena_state(params)
    flat = split_state(params)[0] if resident else None
    leaves = None if resident else by_path(params)
    dtype = snapshot_dtype(cfg)
    for key, buf in arenas.items():
        b = table[key]
        s = _bucket_slot(b, slot)
        if s < 0 or (group is not None and b.group != group):
            continue
        row = flat[key] if resident else pack_row(b, leaves, dtype)
        buf[:, s, :].copy_(row.view(b.n_blocks, b.block_n))
    return arenas


def update_grams(agrams: Dict[str, torch.Tensor],
                 arenas: Dict[str, torch.Tensor], slot, cfg,
                 table: Dict[str, ArenaBucket],
                 group: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Streaming-Gram maintenance: ONE segmented gram_row launch per bucket
    gives every system's row (the one bucket row in bucket scope), then
    one row+column write per bucket. The just-written slot of the ring
    buffer is the query, read in place. `slot` and `group` follow
    ``record``."""
    for key, g in agrams.items():
        b = table[key]
        s = _bucket_slot(b, slot)
        if s < 0 or (group is not None and b.group != group):
            continue
        buf = arenas[key]
        row = ka.gram_row(buf, buf[:, s, :],
                          b.tables_on(buf.device, cfg.scope),
                          anchor_first=cfg.anchor == "first")
        dmd_math.set_gram_row(g, row, s)
    return agrams


# ---------------------------------------------------------------------------
# The jump: one batched solve per group, one combine launch per bucket
# ---------------------------------------------------------------------------

def relax_at(relax, gi: int):
    """Group `gi`'s relax from a scalar or a per-group vector: a tensor
    stays a tensor (it may carry a gradient), a host value becomes a
    float."""
    if np.ndim(relax) == 1:
        relax = relax[gi]
    return relax if isinstance(relax, torch.Tensor) else float(relax)


def jump(cfg, table: Dict[str, ArenaBucket], params,
         arenas: Dict[str, torch.Tensor],
         agrams: Optional[Dict[str, torch.Tensor]], relax,
         groups: Optional[frozenset] = None, s_vec=None, ridge_vec=None,
         resident: bool = False
         ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """DMD jump over every bucket of the jumping groups.

    Returns ({path: new leaf (param dtype)}, [per-leaf mean rank]); with
    ``resident=True`` the updates stay flat and are keyed by bucket
    ({bucket_key: (N,) new resident row}), with no unpack. Per group:
    concatenate the buckets' (n_sys, m, m) Grams, make ONE
    ``dmd_coefficients`` call, split the coefficient rows back per bucket,
    ONE segmented combine launch per bucket. A bucket without a carried
    Gram (``agrams`` None or missing the key) gets the one-launch full
    recompute: the ``streaming_gram=False`` path, and the only Gram path
    for ``anchor="mean"``. `relax` is a scalar or a per-group vector;
    `s_vec` / `ridge_vec` (controller mode) are per-group tensors of the
    adapted horizon and the meta-tuned ridge. A tensor `relax` or
    `ridge_vec` that requires grad makes the result differentiable in it
    (the combine's backward is K1). In bucket scope each bucket is ONE
    system of the group's solve (its table's zeros broadcast the one
    coefficient row in K2) and every segment reports the bucket's rank."""
    scope = cfg.scope
    leaves = None if resident else by_path(params)
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
                g = ka.gram(buf, b.tables_on(buf.device, scope),
                            anchor_first=cfg.anchor == "first",
                            anchor_mean=cfg.anchor == "mean")
            grams.append(g)
        gcat = grams[0] if len(grams) == 1 else torch.cat(grams)
        sched = buckets[0].sched
        c, info = dmd_math.dmd_coefficients(
            gcat, s=sched.s, tol=cfg.tol, mode=cfg.mode,
            clamp_eigs=cfg.clamp_eigs, anchor=cfg.anchor,
            affine=cfg.affine, trust_region=cfg.trust_region,
            relax=relax_at(relax, gi),
            energy=sched.energy, atol=cfg.atol, ridge=sched.ridge,
            s_dyn=None if s_vec is None else s_vec[gi],
            ridge_dyn=None if ridge_vec is None else ridge_vec[gi])
        ofs = 0
        for b in buckets:
            lead = b.gram_lead(scope)
            cb = c[ofs:ofs + lead].contiguous()
            rb = info["rank"][ofs:ofs + lead]
            ofs += lead
            buf = arenas[b.key]
            flat = ka.combine(buf, cb, b.tables_on(buf.device, scope))
            # a non-finite BUFFER poisons the combine even under
            # c = e_last (0 * inf = NaN): never leave params less finite
            # than the last snapshot (read in place: a copy of that row is
            # params-sized, at an LM's width gigabytes)
            rows = flat.view(b.n_blocks, b.block_n)
            flat = torch.where(torch.isfinite(rows), rows,
                               buf[:, -1, :].float()).reshape(-1)
            if b.bucket_scoped(scope):
                seg_ranks = [rb.float().mean()] * len(b.segments)
            else:
                seg_ranks = [rb[seg.sys_start:seg.sys_start + seg.n_sys]
                             .float().mean() for seg in b.segments]
            ranks.extend(seg_ranks)
            if resident:
                updates[b.key] = flat.to(
                    getattr(torch, b.segments[0].param_dtype))
                continue
            for seg, leaf in zip(b.segments, _unpack_row(b, flat)):
                updates[seg.path] = leaf.to(leaves[seg.path].dtype)
    return updates, ranks
