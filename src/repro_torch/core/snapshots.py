"""Per-leaf snapshot ring buffers and their streaming Grams.

The per-leaf route of the DMD accelerator (``DMDConfig(arena=False)``, the
``dot_general`` oracle, and every leaf an arena does not take). Each
selected leaf gets its own buffer ``(m_leaf, *shape)``, snapshot axis
first, with ``m_leaf`` from the leaf's schedule group, and, when streaming,
its own fp32 Gram ``(stack..., m_leaf, m_leaf)``, one per stacked system.
Trees mirror the param tree; excluded leaves and leaves served by an arena
are None.

Routing follows ``plan.route``, as in the reference: ``pallas_flat`` and
``pallas_shard_map`` take the flat kernels K4-K6 through ``kernels/ops.py``
(the same call without a mesh: a stacked leaf is one launch over its
systems), ``dot_general`` takes the plain contractions of
``core/dmd.py``. Write positions are a scalar slot (every leaf) or the
per-group slot vector indexed by ``plan.group``; negative slots skip the
leaf, and ``group=`` restricts a call to one schedule group.

Under a mesh each rank holds its block of every buffer (the plan's
``snapshot_spec``) and of every Gram (``gram_spec``): the data passes run
on the block and sum their partials over the leaf's ``psum_axes`` with one
all-reduce (``kernels/sharded.py``), so a Gram whose stack dims no axis
shards is the same on every rank.

Buffers and Grams are updated IN PLACE (``record`` writes the slot,
``update_grams`` a Gram row and column): at the paper's MLP the largest
buffer is 149.5 MB, and a functional update would copy it on every step.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dmd as dmd_math
from repro_torch.core.leafplan import LeafPlan
from repro_torch.core.paths import by_path, leaves_with_paths, map_with_paths
from repro_torch.kernels import sharded

PyTree = Any
KERNEL_ROUTES = ("pallas_flat", "pallas_shard_map")


def _leaf_slot(plan: LeafPlan, slot) -> int:
    """Per-leaf write position: a per-group vector is indexed by the plan's
    schedule group; a scalar applies to every leaf."""
    if np.ndim(slot) == 1:
        return int(slot[plan.group])
    return int(slot)


def _live(tree: PyTree, plans: PyTree, slot, group: Optional[int]
          ) -> Iterator[Tuple[str, LeafPlan, torch.Tensor, int]]:
    """(path, plan, leaf, slot) for every leaf of `tree` that this call
    writes: selected, in `group` (when given), with a slot >= 0."""
    plan_of = by_path(plans)
    for path, leaf in leaves_with_paths(tree):
        plan = plan_of.get(path)
        if plan is None or (group is not None and plan.group != group):
            continue
        s = _leaf_slot(plan, slot)
        if s >= 0:
            yield path, plan, leaf, s


def init_buffers(params: PyTree, cfg, plans: PyTree, device,
                 skip_paths=frozenset()) -> PyTree:
    """Zeroed ``(plan.m, *shape)`` buffer per selected leaf on `device`, in
    ``cfg.snapshot_dtype``; None for excluded leaves and for `skip_paths`
    (the leaves a packed arena serves)."""
    dtype = getattr(torch, cfg.snapshot_dtype)
    plan_of = by_path(plans)

    def make(path, leaf):
        plan = plan_of.get(path)
        if plan is None or path in skip_paths:
            return None
        return torch.zeros((plan.m,) + tuple(leaf.shape), dtype=dtype,
                           device=device)
    return map_with_paths(make, params)


def record(buffers: PyTree, params: PyTree, slot, plans: PyTree,
           group: Optional[int] = None) -> PyTree:
    """Write the current params into each buffer's row `slot`, cast to the
    buffer's dtype, in place."""
    p_of = by_path(params)
    for path, _, buf, s in _live(buffers, plans, slot, group):
        buf[s].copy_(p_of[path])
    return buffers


def init_grams(buffers: PyTree, plans: PyTree) -> PyTree:
    """Zeroed fp32 ``(stack..., m, m)`` Gram per buffer; None where the
    buffer is None."""
    plan_of = by_path(plans)

    def make(path, buf):
        plan = plan_of[path]
        shape = tuple(buf.shape[1:1 + plan.stack_dims]) + (plan.m, plan.m)
        return torch.zeros(shape, dtype=torch.float32, device=buf.device)
    return map_with_paths(make, buffers)


def _stream_gram_row(plan: LeafPlan, buf: torch.Tensor, slot: int, cfg
                     ) -> torch.Tensor:
    """One leaf's streaming row ``<d_p, d_j>``, p being the snapshot just
    written into `slot` (so ``buf[slot]`` is the query, read in place),
    dispatched by the plan's route."""
    q = buf[slot]
    if plan.route in KERNEL_ROUTES:
        return sharded.gram_row(buf, q, plan,
                                anchor_first=cfg.anchor == "first")
    return sharded.psum(dmd_math.gram_row_matrix(
        buf, q, anchor=cfg.anchor, stack_dims=plan.stack_dims,
        upcast=cfg.gram_upcast), plan)


def update_grams(grams: PyTree, buffers: PyTree, slot, cfg, plans: PyTree,
                 group: Optional[int] = None) -> PyTree:
    """Streaming-Gram maintenance after ``record``: refresh row and column
    `slot` of every running Gram with one O(m*n) pass per leaf, in place.
    `slot` and `group` follow the ``record`` conventions. At every
    window-complete point this equals the full recompute (DESIGN.md §2)."""
    g_of = by_path(grams)
    for path, plan, buf, s in _live(buffers, plans, slot, group):
        dmd_math.set_gram_row(g_of[path], _stream_gram_row(plan, buf, s, cfg),
                              s)
    return grams


def recompute_grams(grams: PyTree, buffers: PyTree, cfg, plans: PyTree
                    ) -> PyTree:
    """Rebuild the Grams that are all zero while their buffer is not (a
    checkpoint written without streaming Grams restores zeros; the next
    jump would otherwise solve on a Gram with zeroed rows). The staleness
    of every leaf is read in one device-to-host copy; each stale leaf then
    takes one ``gram_matrix`` pass. Returns a new tree. Under a mesh a
    leaf is stale where it is on any rank (every rank then rebuilds it,
    one all-reduce of the partials each), so all ranks make the same
    collectives."""
    b_of = by_path(buffers)
    live = [(path, g, b_of[path]) for path, g in leaves_with_paths(grams)
            if b_of.get(path) is not None]
    if not live:
        return grams
    plan_of = by_path(plans)
    stale = torch.stack([(~g.any()) & b.any() for _, g, b in live]).int()
    mesh = plan_of[live[0][0]].mesh
    if mesh is not None:
        mesh.all_reduce(stale, mesh.axis_names,
                        op=torch.distributed.ReduceOp.MAX)
    stale = stale.tolist()  # lint: allow-host-sync (once per restore)
    fresh = {path: sharded.psum(dmd_math.gram_matrix(
        b, anchor=cfg.anchor, stack_dims=plan_of[path].stack_dims,
        upcast=cfg.gram_upcast), plan_of[path])
        for flag, (path, _, b) in zip(stale, live) if flag}
    return map_with_paths(lambda path, g: fresh.get(path, g), grams)
