"""LeafPlan: the per-leaf DMD dispatch table, without a mesh.

One frozen record per selected param leaf, built once from the real param
tree: the leaf's path, shape, stack axes, kernel route and schedule group.
The arena (``core/arena.py``) buckets leaves from these records.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from repro_torch.core import schedule as sched_mod
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.core.schedule import GroupSchedule
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

    @property
    def m(self) -> int:
        if self.sched is None:
            raise ValueError(f"plan for {self.path} has no schedule")
        return self.sched.m


def default_block_n(flat_size: int, cap: int = 2048) -> int:
    """Largest useful n-tile for a leaf: a 128-lane multiple no wider than
    the lane-padded leaf."""
    return lane_block(cap, flat_size)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _resolve_route(cfg, stack_dims: int) -> str:
    forced = cfg.kernel_route
    if forced not in ("auto",) + ROUTES:
        raise ValueError(f"unknown dmd.kernel_route {forced!r}")
    auto = "pallas_shard_map" if stack_dims > 0 else "pallas_flat"
    if forced == "auto":
        return auto
    if forced == "pallas_flat" and stack_dims > 0:
        return auto            # flattening a stacked leaf is invalid
    return forced


def build_plans(params: PyTree, cfg, stack_dims: Optional[dict] = None
                ) -> PyTree:
    """params -> tree of LeafPlan | None (None = excluded by a group rule).

    ``stack_dims`` maps normalised paths to their count of leading stacked
    axes; None means no leaf is stacked (plain MLPs)."""
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
        return LeafPlan(
            path=path, shape=tuple(int(d) for d in leaf.shape),
            dtype=dtype_name(leaf.dtype), stack_dims=nstack,
            flat_size=flat_size, route=_resolve_route(cfg, nstack),
            anchor_ok=cfg.anchor in ("none", "first"),
            block_n=default_block_n(flat_size), group=gi, sched=groups[gi])

    return map_with_paths(one, params)


def plan_entries(plans: PyTree) -> List[LeafPlan]:
    """Flat list of the selected leaves' plans, in the reference's tree
    order."""
    return [p for _, p in leaves_with_paths(plans)
            if isinstance(p, LeafPlan)]
