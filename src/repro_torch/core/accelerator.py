"""DMDAccelerator: the paper's Algorithm 1 as a training-loop component.

    acc = DMDAccelerator(cfg, device="cuda")
    buffers = acc.init(params)               # also builds the plan table
    grams = acc.init_grams(buffers)          # streaming Grams (or None)
    # after every optimizer step:
    if acc.should_record(step):
        buffers, grams = acc.record(buffers, params, acc.slots(step), grams)
    if acc.should_apply(step):               # some group's window closed
        params, stats = acc.apply(params, buffers, grams=grams, step=step)

Only the packed-arena route is ported (``core/arena.py``): one segmented
kernel launch per bucket per recorded step and one batched coefficient
solve per group per jump. A leaf the arena would not take (``arena=False``
or ``kernel_route="dot_general"``) raises ``NotImplementedError``: the
per-leaf route is still to port (ROADMAP Queue 1). The schedule is the
group table of ``core/schedule.py``; per-group queries take ``group=``
(default 0).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import arena as arena_mod
from repro_torch.core import leafplan, schedule as sched_mod
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.kernels.ops import resolve_device

PyTree = Any


class DMDAccelerator:
    def __init__(self, cfg, *, stack_dims: Optional[dict] = None,
                 device="cuda"):
        """`stack_dims` maps param paths to their stacked leading axes
        (None: no stacked leaves). State lives on `device`."""
        if cfg.scope != "leaf":
            raise NotImplementedError(
                f"dmd.scope={cfg.scope!r} is not ported yet (ROADMAP "
                "Queue 1: eig mode and bucket scope); use scope='leaf'")
        if cfg.enabled and cfg.mode != "matpow":
            raise NotImplementedError(
                f"dmd.mode={cfg.mode!r} is not ported yet (ROADMAP Queue 1: "
                "eig mode and bucket scope); use mode='matpow'")
        self.cfg = cfg
        self.stack_dims = stack_dims
        self.device = resolve_device(device)
        self.groups = sched_mod.resolve_groups(cfg)
        self.n_groups = len(self.groups)
        self._plans = None
        self._plans_key = None
        self._arena = None

    @property
    def streaming(self) -> bool:
        """Streaming-Gram engine active? (anchor="mean" has no one-pass row
        update, so it keeps the recompute path.)"""
        return (self.cfg.enabled and self.cfg.streaming_gram
                and self.cfg.anchor in ("none", "first"))

    # ---- the dispatch tables ----------------------------------------------
    def plans_for(self, params: PyTree) -> PyTree:
        """LeafPlan tree for `params`, cached by path, shape and dtype."""
        key = tuple((p, tuple(x.shape), str(x.dtype))
                    for p, x in leaves_with_paths(params))
        if self._plans is None or self._plans_key != key:
            plans = leafplan.build_plans(params, self.cfg, self.stack_dims)
            if self.cfg.enabled:
                for plan in leafplan.plan_entries(plans):
                    if not arena_mod.arena_eligible(plan, self.cfg):
                        raise NotImplementedError(
                            f"{plan.path}: the per-leaf DMD route "
                            f"(arena={self.cfg.arena}, route={plan.route}) "
                            "is not ported yet (ROADMAP Queue 1: the "
                            "per-leaf DMD route)")
            self._plans = plans
            self._plans_key = key
            self._arena = None
        return self._plans

    def arena_for(self, params: PyTree) -> Dict[str, arena_mod.ArenaBucket]:
        """The bucket table for `params` (built once per plan table)."""
        self.plans_for(params)
        if self._arena is None:
            self._arena = (arena_mod.build_arenas(self._plans, self.cfg)
                           if self.cfg.enabled else {})
        return self._arena

    def plan_table(self, params: Optional[PyTree] = None) -> str:
        """Human-readable dispatch table: route, schedule group, m, s,
        phase, shape and each leaf's bucket and lane offset."""
        if params is None:
            if self._plans is None:
                raise ValueError("no plans built yet: pass params")
        else:
            self.plans_for(params)
        seg_of = {s.path: (b.key, s.lane_start)
                  for b in (self._arena or {}).values() for s in b.segments}
        rows = [("path", "route", "group", "m", "s", "phase", "stack",
                 "shape", "flat_n", "arena", "off")]
        for p in leafplan.plan_entries(self._plans):
            akey, aoff = seg_of.get(p.path, ("-", "-"))
            rows.append((p.path, p.route, p.sched.name, str(p.m),
                         str(p.sched.s), str(p.sched.phase),
                         str(p.stack_dims), "x".join(map(str, p.shape)),
                         str(p.flat_size), akey, str(aoff)))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths))
                         .rstrip() for r in rows)

    # ---- schedule ---------------------------------------------------------
    def slot(self, step: int, group: int = 0) -> int:
        return self.groups[group].slot(step)

    def slots(self, step: int) -> np.ndarray:
        """(n_groups,) per-group slot vector (negative: not recording)."""
        return sched_mod.slots_array(self.groups, step)

    def should_record(self, step: int) -> bool:
        return self.cfg.enabled and any(
            g.should_record(step) for g in self.groups)

    def should_apply(self, step: int) -> bool:
        return self.cfg.enabled and bool(self.apply_groups(step))

    def apply_groups(self, step: int) -> Tuple[int, ...]:
        """Indices of the groups whose window closes at `step`."""
        if not self.cfg.enabled:
            return ()
        return tuple(i for i, g in enumerate(self.groups)
                     if g.should_apply(step))

    def round_index(self, step: int, group: int = 0) -> int:
        return self.groups[group].round_index(step)

    def relax_for_round(self, round_idx: int, group: int = 0) -> float:
        return self.groups[group].relax_for_round(round_idx)

    def relax_vector(self, step: int) -> np.ndarray:
        """(n_groups,) relax factors at `step`, each group annealed on its
        own round counter."""
        return np.asarray([g.relax_for_round(g.round_index(step))
                           for g in self.groups], np.float32)

    def reset_groups(self, groups: Optional[Sequence[int]] = None
                     ) -> Tuple[int, ...]:
        """Of the jumped groups (None = all), those whose optimizer moments
        reset afterwards."""
        src = range(self.n_groups) if groups is None else groups
        return tuple(g for g in src if self.groups[g].reset_opt)

    # ---- state ------------------------------------------------------------
    def init(self, params: PyTree) -> Optional[Dict[str, torch.Tensor]]:
        """Zeroed ring buffers, {bucket_key: (n_blocks, m, block_n)}."""
        if not self.cfg.enabled:
            return None
        return arena_mod.init_arena_buffers(self.arena_for(params), self.cfg,
                                            self.device)

    def init_grams(self, buffers) -> Optional[Dict[str, torch.Tensor]]:
        """Zeroed streaming Grams, {bucket_key: (n_sys, m, m)} fp32, or None
        when not streaming."""
        if buffers is None or not self.streaming:
            return None
        if self._arena is None:
            raise ValueError("init_grams before init: no bucket table yet")
        return arena_mod.init_arena_grams(self._arena, self.device)

    @torch.no_grad()
    def record(self, buffers, params: PyTree, slot, grams=None):
        """Write params into each bucket's row `slot` (a scalar, or the
        per-group vector from ``slots(step)``; negative entries are
        skipped) and, with `grams`, refresh the streaming Gram rows. Both
        are updated in place; returns (buffers, grams)."""
        if buffers is None:
            return None, None
        if self.n_groups > 1 and np.ndim(slot) != 1:
            raise ValueError(
                f"{self.n_groups} schedule groups need the per-group slot "
                "vector: pass acc.slots(step), not a scalar slot")
        table = self.arena_for(params)
        arena_mod.record(buffers, params, slot, table, self.cfg)
        if grams is not None:
            arena_mod.update_grams(grams, buffers, slot, self.cfg, table)
        return buffers, grams

    @torch.no_grad()
    def apply(self, params: PyTree, buffers, round_idx: int = 0, grams=None,
              groups: Optional[Tuple[int, ...]] = None,
              step: Optional[int] = None) -> Tuple[PyTree, dict]:
        """The jump. Two idioms:

          * ``apply(params, buffers, round_idx, grams=...)``: every group
            jumps, relaxed at `round_idx`.
          * ``apply(params, buffers, grams=..., step=step)``: only
            ``apply_groups(step)`` jump, each at its own round's relax.
            `groups` overrides the mask.

        Returns new params (the jumped leaves replaced; `params` is not
        modified) and {"mean_rank": ...}."""
        if buffers is None:
            return params, {}
        if not self.streaming:
            grams = None
        table = self.arena_for(params)
        if step is not None:
            if groups is None:
                groups = self.apply_groups(step)
            relax = self.relax_vector(step)
        else:
            relax = np.asarray([self.relax_for_round(round_idx, g)
                                for g in range(self.n_groups)], np.float32)
        gset = None if groups is None else frozenset(int(g) for g in groups)
        updates, ranks = arena_mod.jump(self.cfg, table, params, buffers,
                                        grams, relax, groups=gset)
        new_params = map_with_paths(lambda p, x: updates.get(p, x), params)
        mean_rank = (torch.stack(ranks).mean() if ranks
                     else torch.zeros((), device=self.device))
        return new_params, {"mean_rank": mean_rank}
