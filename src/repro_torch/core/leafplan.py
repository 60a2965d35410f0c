"""LeafPlan: the per-leaf DMD dispatch table.

One frozen record per selected param leaf, built once from the full param
tree (global shapes) and the mesh: the leaf's path, shape, stack axes,
kernel route, schedule group and, under a mesh, its partition specs (the
param's, its ring buffer's and its Gram's) and the axes its Gram partials
are summed over (``psum_axes``). The arena (``core/arena.py``) buckets
leaves from these records.

Routes, as the reference names them: ``pallas_flat`` for a leaf with no
stack axes that no mesh axis shards (the flat kernels K4-K6 on its
``(m, n)`` view), ``pallas_shard_map`` for a stacked or sharded leaf (the
same kernels on each rank's block, then one all-reduce of the partials:
``kernels/sharded.py``), ``dot_general`` for the plain contractions.

``plan_summary`` and ``plan_records`` are the reference's export views of
the table (the audit's ``AUDIT_torch_*.json`` carries the records); the
specs print as the reference's ``PartitionSpec``s print. Without a mesh
every leaf is unsharded: one None per axis, no ``psum_axes``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import schedule as sched_mod
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.core.schedule import GroupSchedule
from repro_torch.distributed.sharding import Spec, full_spec, spec_for_path
from repro_torch.kernels.ops import lane_block

PyTree = Any

ROUTES = ("pallas_flat", "pallas_shard_map", "dot_general")


def dtype_name(dtype) -> str:
    """Dtype spelled as the reference spells it (``"float32"``)."""
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class LeafPlan:
    """Per-leaf dispatch record. Route names are the reference's, so a
    plan table reads the same in both packages."""
    path: str                     # normalised param path ("/l0/w")
    shape: Tuple[int, ...]        # param shape (stack dims included)
    dtype: str                    # param dtype name
    stack_dims: int               # leading per-layer batch axes
    flat_size: int                # flattened size per stacked layer
    route: str                    # one of ROUTES
    anchor_ok: bool               # streaming row update valid
    block_n: int                  # per-leaf n-tile (128-lane multiple)
    group: int = 0                # schedule-group index
    sched: Optional[GroupSchedule] = None
    sharded: bool = False         # a non-stack dim sharded on a >1 axis
    param_spec: Spec = Spec()     # full-length spec of the param
    snapshot_spec: Spec = Spec()  # spec of its (m, *shape) ring buffer
    gram_spec: Spec = Spec()      # spec of its (stack..., m, m) Gram
    mesh: Any = field(default=None, repr=False, compare=False)

    @property
    def m(self) -> int:
        if self.sched is None:
            raise ValueError(f"plan for {self.path} has no schedule")
        return self.sched.m

    @property
    def stack_spec_entries(self) -> Tuple[Any, ...]:
        ent = tuple(self.param_spec)
        k = self.stack_dims
        return (ent[:k] + (None,) * (k - len(ent)))[:k]

    def psum_axes(self) -> Tuple[str, ...]:
        """Mesh axes the rank-local Gram partials are summed over: every
        axis sharding a contracted (non-stack) dim of the leaf."""
        axes: List[str] = []
        for e in tuple(self.param_spec)[self.stack_dims:]:
            if e is None:
                continue
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None and a not in axes:
                    axes.append(a)
        return tuple(axes)


def default_block_n(flat_size: int, cap: int = 2048) -> int:
    """Largest useful n-tile for a leaf: a 128-lane multiple no wider than
    the lane-padded leaf."""
    return lane_block(cap, flat_size)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _is_sharded(entries, mesh) -> bool:
    if mesh is None:
        return False
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for e in entries:
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None and sizes.get(a, 1) > 1:
                return True
    return False


def _resolve_route(cfg, stack_dims: int, sharded: bool = False) -> str:
    forced = cfg.kernel_route
    if forced not in ("auto",) + ROUTES:
        raise ValueError(f"unknown dmd.kernel_route {forced!r}")
    auto = ("pallas_shard_map" if (stack_dims > 0 or sharded)
            else "pallas_flat")
    if forced == "auto":
        return auto
    if forced == "pallas_flat" and (stack_dims > 0 or sharded):
        return auto            # flattening a stacked/sharded leaf is invalid
    return forced


def build_plans(params: PyTree, cfg, stack_dims: Optional[dict] = None,
                mesh=None) -> PyTree:
    """params -> tree of LeafPlan | None (None = excluded by a group rule).

    ``stack_dims`` maps normalised paths to their count of leading stacked
    axes; None means no leaf is stacked (plain MLPs). `params` are the
    FULL leaves (or tensors of their shapes on the meta device): under a
    `mesh` the specs are resolved against the global shapes, whatever
    block of them a rank holds. Only ``mesh.axis_names`` and
    ``mesh.devices.shape`` are read."""
    groups = sched_mod.resolve_groups(cfg)
    if stack_dims is None:
        # guessing zero for a scan-stacked tree would silently merge
        # per-layer trajectories into one Gram: refuse loudly instead
        if isinstance(params, dict) and any(
                k.startswith("seg") and k[3:].isdigit() for k in params):
            raise ValueError(
                "params look segment-stacked (top-level 'seg<i>' keys) but "
                "no stack_dims annotation was given")
        stack_dims = {}

    def one(path, leaf):
        gi = sched_mod.group_for_leaf(cfg, path, leaf.dim(), leaf.numel())
        if gi is None:
            return None
        nstack = int(stack_dims.get(path, 0))
        if not 0 <= nstack < leaf.dim() + 1:
            raise ValueError(
                f"stack_dims {nstack} out of range for {path} "
                f"{tuple(leaf.shape)}")
        flat_size = _prod(leaf.shape[nstack:])
        shape = tuple(int(d) for d in leaf.shape)
        pspec = full_spec(spec_for_path(path, leaf.dim(), mesh, shape)
                          if mesh is not None else Spec(), leaf.dim())
        ent = tuple(pspec)
        sharded = _is_sharded(ent[nstack:], mesh)
        return LeafPlan(
            path=path, shape=shape,
            dtype=dtype_name(leaf.dtype), stack_dims=nstack,
            flat_size=flat_size, route=_resolve_route(cfg, nstack, sharded),
            anchor_ok=cfg.anchor in ("none", "first"),
            block_n=default_block_n(flat_size), group=gi, sched=groups[gi],
            sharded=sharded, param_spec=pspec, snapshot_spec=Spec(None, *ent),
            gram_spec=Spec(*((ent[:nstack] + (None,) * (nstack - len(ent))
                              )[:nstack]), None, None),
            mesh=mesh)

    return map_with_paths(one, params)


def plan_entries(plans: PyTree) -> List[LeafPlan]:
    """Flat list of the selected leaves' plans, in the reference's tree
    order."""
    return [p for _, p in leaves_with_paths(plans)
            if isinstance(p, LeafPlan)]


def param_spec(plan: LeafPlan) -> str:
    """The leaf's PartitionSpec as the reference prints it
    (``PartitionSpec(None, 'data', 'model')``)."""
    return str(plan.param_spec)


def plan_summary(plans: PyTree) -> Dict[str, Tuple[str, int]]:
    """{path: (route, stack_dims)}: the regression-pin view of the table."""
    return {p.path: (p.route, p.stack_dims) for p in plan_entries(plans)}


def plan_records(plans: PyTree) -> List[dict]:
    """JSON-able rows of the dispatch table, the reference's keys (the
    audit's export)."""
    return [{
        "path": p.path, "shape": list(p.shape), "dtype": p.dtype,
        "stack_dims": p.stack_dims, "flat_size": p.flat_size,
        "route": p.route, "anchor_ok": p.anchor_ok, "sharded": p.sharded,
        "block_n": p.block_n, "group": p.group,
        "m": (p.sched.m if p.sched is not None else None),
        "s": (p.sched.s if p.sched is not None else None),
        "phase": (p.sched.phase if p.sched is not None else None),
        "param_spec": param_spec(p),
        "psum_axes": list(p.psum_axes()),
    } for p in plan_entries(plans)]
