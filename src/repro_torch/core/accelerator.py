"""DMDAccelerator: the paper's Algorithm 1 as a training-loop component.

    acc = DMDAccelerator(cfg, device="cuda")
    buffers = acc.init(params)               # also builds the plan table
    grams = acc.init_grams(buffers)          # streaming Grams (or None)
    # after every optimizer step:
    if acc.should_record(step):
        buffers, grams = acc.record(buffers, params, acc.slots(step), grams)
    if acc.should_apply(step):               # some group's window closed
        params, stats = acc.apply(params, buffers, grams=grams, step=step)

Two routes, as in the reference. With ``cfg.arena`` (the default) every
leaf is packed into a block-major arena bucket (``core/arena.py``): one
segmented kernel launch per bucket per recorded step and one batched
coefficient solve per group per jump. With ``arena=False``, or with the
route forced to ``kernel_route="dot_general"``, every leaf keeps its own
``(m, *shape)`` buffer (``core/snapshots.py``) and jumps alone
(``dmd_leaf_jump``): the flat kernels K4-K6 per leaf, or the plain
contractions of ``core/dmd.py`` on the ``dot_general`` route. The state is
the per-leaf tree when no leaf is packed, else the two-route wrapper
``{"__arena__": {bucket: ...}, "leaf": per-leaf tree}``. The schedule is
the group table of ``core/schedule.py``; per-group queries take ``group=``
(default 0). With arena-resident params (``core/arena.py``, the
Trainer's layout) ``record`` copies each bucket's flat buffer into its
ring slot and ``jump_tree`` returns the resident wrapper with new flat
rows. The loss-gated controller's per-group state comes from
``init_controller`` (``core/controller.py``); ``jump_tree`` takes its
adapted horizons and ridges as ``s_vec`` / ``ridge_vec``. Checkpoints
are written in the per-leaf layout: ``state_leafwise`` unpacks the
arenas and the resident params and moments, ``state_arenaize`` packs a
restored state back.

``cfg.mode`` is "matpow" or "eig" (the paper's classic DMD: one host
eigendecomposition per jump, ``core/dmd.py``). ``cfg.scope="bucket"``
(DESIGN.md §9) makes each arena bucket ONE Koopman system: the streaming
update writes its (1, m, m) Gram, a jump solves one system per bucket and
K2 broadcasts one coefficient row; per-leaf-route leaves keep their own
solves in either scope. ``spectrum_table`` prints each bucket's Koopman
eigenvalues (leaf scope sums its per-system Grams first, so the two
scopes read alike).

Under a mesh (``DMDAccelerator(cfg, mesh=...)``, DESIGN.md §6) the plan
table is built once from the FULL params (``plans_for`` with the full
tree; afterwards any tree of the same paths, such as a rank's blocks,
maps to it) and carries each leaf's specs; every state tensor is a rank's
block. Buckets and per-leaf buffers run their data passes on the block
and sum the partials with one all-reduce (``kernels/sharded.py``, the
reference's ``pallas_shard_map`` route); the jump solves on the mesh's
Grams, broadcasts the coefficients from the first rank, and combines each
rank's block with no collective.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import arena as arena_mod
from repro_torch.core import dmd, leafplan, schedule as sched_mod
from repro_torch.core import snapshots as snap
from repro_torch.core.paths import (by_path, fill_paths, leaves_with_paths,
                                    map_with_paths)
from repro_torch.distributed.sharding import (Spec, gather_full, local_shard,
                                              param_specs)
from repro_torch.kernels import sharded
from repro_torch.kernels.device import resolve_device

PyTree = Any


@dataclass
class LeafJump:
    """Result of one leaf's DMD jump: the new leaf and its mean rank."""
    params: torch.Tensor
    rank: torch.Tensor


def dmd_leaf_jump(cfg, plan: leafplan.LeafPlan, p: torch.Tensor,
                  buf: torch.Tensor, gram: Optional[torch.Tensor], relax,
                  s_dyn=None, ridge_dyn=None) -> LeafJump:
    """One leaf of the DMD jump: coefficients from `gram` (the carried
    streaming Gram; recomputed from the buffer when None) and one combine
    pass, both routed by the leaf's plan. The horizon, energy target and
    ridge are the leaf's group's; in controller mode `s_dyn` (the adapted
    horizon, capped by the group's s) and `ridge_dyn` (the meta-tuned
    ridge) replace them. The result is cast to the param's dtype. Under a
    mesh `p` and `buf` are the rank's blocks: a Gram sharded over stack
    axes is gathered for the solve, the coefficients are broadcast from
    the mesh's first rank (unless they carry a gradient) and each rank
    keeps its systems' rows."""
    nstack = plan.stack_dims
    kernel = plan.route in snap.KERNEL_ROUTES
    if gram is None:
        if kernel and plan.anchor_ok:
            gram = sharded.gram(buf, plan, anchor_first=cfg.anchor == "first")
        else:
            gram = sharded.psum(dmd.gram_matrix(
                buf, anchor=cfg.anchor, stack_dims=nstack,
                upcast=cfg.gram_upcast), plan)
    mesh = plan.mesh
    sys_sharded = mesh is not None and any(
        e is not None for e in plan.stack_spec_entries)
    if sys_sharded:
        gram = gather_full(gram, plan.gram_spec, mesh)
    sched = plan.sched
    c, info = dmd.dmd_coefficients(
        gram, s=sched.s, tol=cfg.tol, mode=cfg.mode,
        clamp_eigs=cfg.clamp_eigs, anchor=cfg.anchor, affine=cfg.affine, trust_region=cfg.trust_region, relax=relax,
        energy=sched.energy, atol=cfg.atol, ridge=sched.ridge, s_dyn=s_dyn,
        ridge_dyn=ridge_dyn)
    rank = info["rank"]
    if mesh is not None and not c.requires_grad:
        c = mesh.broadcast(c.contiguous())
    if sys_sharded:
        c = local_shard(c, Spec(*plan.stack_spec_entries, None), mesh)
        rank = local_shard(rank, Spec(*plan.stack_spec_entries), mesh)
    if kernel:
        w = sharded.combine(buf, c, plan)
    else:
        w = dmd.combine_snapshots(buf, c, stack_dims=nstack,
                                  upcast=cfg.gram_upcast)
    # even c = e_last cannot save a non-finite BUFFER (0 * inf = NaN): never
    # leave params less finite than the last snapshot (the last ring row,
    # as the reference does, not the just-written slot)
    w = torch.where(torch.isfinite(w), w, buf[-1].to(w.dtype))
    return LeafJump(w.to(p.dtype), rank.float().mean())


def jump_tree(cfg, plans: PyTree, params: PyTree, buffers: PyTree,
              grams: Optional[PyTree], relax,
              groups: Optional[frozenset] = None,
              arena: Optional[Dict[str, arena_mod.ArenaBucket]] = None,
              s_vec=None, ridge_vec=None
              ) -> Tuple[PyTree, torch.Tensor]:
    """Whole-tree DMD jump: returns (new params, the mean over the jumped
    leaves of each leaf's mean rank). The arena route serves the packed
    leaves (`arena` is the accelerator's bucket table); every other
    selected leaf of a jumping group takes ``dmd_leaf_jump``. `groups`
    (None: all) masks the jump to those schedule groups; `relax` is a
    scalar or a per-group vector. `grams` None means no carried Grams
    (recompute). `s_vec` / `ridge_vec` (controller mode) are per-group
    tensors of adapted horizons and meta-tuned ridges. Resident params
    (the arena wrapper) come back as a wrapper whose jumped buckets are new
    flat rows; `params` itself is not modified."""
    resident = arena_mod.is_arena_state(params)
    pres: Dict[str, torch.Tensor] = {}
    if resident:
        pres, params = arena_mod.split_state(params)
    updates: Dict[str, torch.Tensor] = {}
    arena_updates: Dict[str, torch.Tensor] = {}
    ranks = []
    if arena_mod.is_arena_state(buffers):
        if not arena:
            raise ValueError(
                "buffers are arena-packed but no bucket table was given: "
                "pass arena=acc.arena_for(params)")
        arenas, buffers = arena_mod.split_state(buffers)
        agrams = None
        if grams is not None:
            agrams, grams = arena_mod.split_state(grams)
        arena_updates, ranks = arena_mod.jump(
            cfg, arena, params, arenas, agrams, relax, groups=groups,
            s_vec=s_vec, ridge_vec=ridge_vec, resident=resident)
        if not resident:
            updates, arena_updates = arena_updates, {}
    p_of = by_path(params)
    g_of = by_path(grams) if grams is not None else {}
    plan_of = by_path(plans)
    for path, buf in leaves_with_paths(buffers):
        plan = plan_of[path]
        if groups is not None and plan.group not in groups:
            continue
        jump = dmd_leaf_jump(
            cfg, plan, p_of[path], buf, g_of.get(path),
            arena_mod.relax_at(relax, plan.group),
            s_dyn=None if s_vec is None else s_vec[plan.group],
            ridge_dyn=None if ridge_vec is None else ridge_vec[plan.group])
        updates[path] = jump.params
        ranks.append(jump.rank)
    new_params = map_with_paths(lambda path, x: updates.get(path, x), params)
    if resident:
        new_params = arena_mod.make_state({**pres, **arena_updates},
                                          new_params)
    mean_rank = (torch.stack(ranks).mean() if ranks
                 else torch.zeros((), dtype=torch.float32))
    return new_params, mean_rank


class DMDAccelerator:
    def __init__(self, cfg, *, stack_dims: Optional[dict] = None,
                 device="cuda", mesh=None):
        """`stack_dims` maps param paths to their stacked leading axes
        (None: no stacked leaves). State lives on `device`; under `mesh`
        (``launch/mesh.py``) each state tensor is this rank's block."""
        self.cfg = cfg
        self.mesh = mesh
        self.param_specs = {}       # {path: Spec} of every param (mesh)
        self.stack_dims = stack_dims
        self.device = resolve_device(device)
        self.groups = sched_mod.resolve_groups(cfg)
        self.n_groups = len(self.groups)
        self._plans = None
        self._plans_key = None
        self._arena = None

    @property
    def controller_on(self) -> bool:
        """Loss-gated jump controller active (``core/controller.py``)?"""
        ccfg = self.cfg.controller
        return bool(self.cfg.enabled and ccfg is not None and ccfg.enabled)

    def init_controller(self):
        """Fresh per-group ControllerState on the accelerator's device, or
        None when the controller is off."""
        if not self.controller_on:
            return None
        from repro_torch.core import controller as ctrl_mod
        return ctrl_mod.init_state(self.groups, device=self.device)

    @property
    def scope(self) -> str:
        """The DMD system granularity (DESIGN.md §9): "leaf" (one operator
        per leaf or stacked layer) or "bucket" (one shared Koopman operator
        per arena bucket; the jump's solve batch is n_buckets)."""
        return self.cfg.scope

    @property
    def arena_on(self) -> bool:
        """Packed-arena route active? Off (``dmd.arena=False``) is the
        per-leaf route everywhere."""
        return bool(self.cfg.enabled and self.cfg.arena)

    @property
    def streaming(self) -> bool:
        """Streaming-Gram engine active? (anchor="mean" has no one-pass row
        update, so it keeps the recompute path.)"""
        return (self.cfg.enabled and self.cfg.streaming_gram
                and self.cfg.anchor in ("none", "first"))

    # ---- the dispatch tables ----------------------------------------------
    def plans_for(self, params: PyTree) -> PyTree:
        """LeafPlan tree for `params`, cached by path, shape and dtype. The
        resident wrapper maps to the plan table it was packed with. Under a
        mesh the table is built from the first tree given, which must be
        the full params; the cache is keyed by path and dtype, so a rank's
        blocks map to the same table."""
        if arena_mod.is_arena_state(params):
            if self._plans is None:
                raise ValueError("resident params but no plan table yet")
            return self._plans
        key = tuple((p, () if self.mesh is not None else tuple(x.shape),
                     str(x.dtype)) for p, x in leaves_with_paths(params))
        if self._plans is None or self._plans_key != key:
            self._plans = leafplan.build_plans(params, self.cfg,
                                               self.stack_dims,
                                               mesh=self.mesh)
            if self.mesh is not None:
                self.param_specs = param_specs(params, self.mesh)
            self._plans_key = key
            self._arena = None
        return self._plans

    def arena_for(self, params: PyTree) -> Dict[str, arena_mod.ArenaBucket]:
        """The bucket table for `params` (built once per plan table). The
        resident wrapper maps to the table it was packed with."""
        if arena_mod.is_arena_state(params):
            if self._arena is None:
                raise ValueError("resident params but no bucket table yet")
            return self._arena
        self.plans_for(params)
        if self._arena is None:
            self._arena = (arena_mod.build_arenas(self._plans, self.cfg,
                                                  self.mesh)
                           if self.cfg.enabled else {})
        return self._arena

    def plan_table(self, params: Optional[PyTree] = None) -> str:
        """Human-readable dispatch table, the reference's columns: route,
        schedule group, m, s, phase, the group's energy target ("-" while
        it is unset), stack dims, shape, flat size, block_n, each leaf's
        bucket and lane offset, `resident` ("y" for packed leaves with
        ``dmd.arena_native``, "n" packed without, "-" per leaf), the
        leaf's PartitionSpec and psum axes, its DMD `scope`
        ("bucket" when its bucket fits one shared operator); then
        `n_solve`, the systems its bucket (or the leaf alone) adds to the
        jump's solve."""
        if params is None:
            if self._plans is None:
                raise ValueError("no plans built yet: pass params")
        else:
            self.arena_for(params)
        if self._arena is None and self.cfg.enabled:
            self._arena = arena_mod.build_arenas(self._plans, self.cfg,
                                                 self.mesh)
        native = bool(self.cfg.arena_native)
        seg_of = {}
        for b in (self._arena or {}).values():
            sc = "bucket" if b.bucket_scoped(self.scope) else "leaf"
            for s in b.segments:
                seg_of[s.path] = (b.key, str(s.lane_start), sc,
                                  str(b.gram_lead(self.scope)))
        rows = [("path", "route", "group", "m", "s", "phase", "energy",
                 "stack", "shape", "flat_n", "block_n", "arena", "off",
                 "resident", "spec", "psum", "scope", "n_solve")]
        for p in leafplan.plan_entries(self._plans):
            n_leaf = str(int(np.prod(p.shape[:p.stack_dims],
                                     dtype=np.int64)))
            akey, aoff, asc, nsol = seg_of.get(p.path,
                                               ("-", "-", "leaf", n_leaf))
            energy = (f"{p.sched.energy:.3f}" if p.sched.energy > 0
                      else "-")
            res = "-" if akey == "-" else ("y" if native else "n")
            rows.append((p.path, p.route, p.sched.name, str(p.m),
                         str(p.sched.s), str(p.sched.phase), energy,
                         str(p.stack_dims), "x".join(map(str, p.shape)),
                         str(p.flat_size), str(p.block_n), akey, aoff, res,
                         leafplan.param_spec(p),
                         ",".join(p.psum_axes()) or "-", asc, nsol))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths))
                         .rstrip() for r in rows)

    def spectrum_table(self, buffers, grams=None) -> str:
        """Per-bucket Koopman spectrum, the convergence diagnostic
        (DESIGN.md §9): for every arena bucket the DMD eigenvalue
        magnitudes of the operator the next jump would fit, on the host in
        float64 (``dmd.dmd_eigenvalues_from_gram``) from the carried Gram,
        or from K3's recompute under the scope's table when none is
        carried. In leaf scope the bucket's per-system Grams are summed
        first, the operator bucket scope would fit, so both scopes read
        alike. Off the hot path: one device-to-host copy per bucket."""
        from repro_torch.kernels import arena as ka

        if self._plans is None:
            raise ValueError("spectrum_table before init: no plan table yet")
        table = self._arena or {}
        rows = [("bucket", "scope", "m", "rank", "|lam|max", "|lam|min",
                 "decay/step", "eigs")]
        agrams = (arena_mod.split_state(grams)[0]
                  if arena_mod.is_arena_state(grams) else None)
        arenas = (arena_mod.split_state(buffers)[0]
                  if arena_mod.is_arena_state(buffers) else {})
        for key in sorted(table):
            b = table[key]
            g = agrams.get(key) if agrams is not None else None
            if g is None:
                buf = arenas[key]
                g = ka.gram(buf, b.tables_on(buf.device, self.scope),
                            anchor_first=self.cfg.anchor == "first",
                            anchor_mean=self.cfg.anchor == "mean",
                            **b.shard_kw())
            if b.sys_axes:
                g = gather_full(g, b.gram_spec(), b.mesh)
            g = g.detach().cpu().numpy()  # lint: allow-host-sync (diagnostic)
            g = g.astype(np.float64)
            if not b.bucket_scoped(self.scope):
                g = g.sum(axis=0, keepdims=True)
            lam = dmd.dmd_eigenvalues_from_gram(g[0], tol=self.cfg.tol)
            mag = np.abs(lam)
            scope = "bucket" if b.bucket_scoped(self.scope) else "leaf"
            if mag.size == 0:
                rows.append((key, scope, str(b.m), "0", "-", "-", "-", "-"))
                continue
            # decay/step: the slowest mode's per-step magnitude ratio
            top = np.sort(mag)[::-1][:4]
            rows.append((key, scope, str(b.m), str(mag.size),
                         f"{mag.max():.4f}", f"{mag.min():.4f}",
                         f"{mag.max():.4f}",
                         " ".join(f"{v:.3f}" for v in top)))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        return "\n".join("  ".join(v.ljust(w) for v, w in zip(r, widths))
                         for r in rows)

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

    # ---- layouts ----------------------------------------------------------
    def params_leafwise(self, params: PyTree) -> PyTree:
        """Params with arena-resident leaves expanded back to per-leaf
        tensors (views of the flat buffers); identity for per-leaf params.
        The layout the Trainer's publish hook hands out."""
        if arena_mod.is_arena_state(params):
            return arena_mod.tree_leafwise(self.arena_for(params), params)
        return params

    def state_leafwise(self, state):
        """TrainState -> the same state in the per-leaf layout of
        ``dmd.arena=False``: resident params and moments expanded, arena
        buffers and Grams unpacked per leaf. Checkpoints are always
        written in this form, so the format does not depend on the arena
        or residency. No-op when nothing is packed."""
        if state is None:
            return state
        if arena_mod.is_arena_state(state.params):
            table = self.arena_for(state.params)
            state = state._replace(
                params=self.params_leafwise(state.params),
                opt_state=arena_mod.unwrap_resident(table, state.opt_state))
        if not arena_mod.is_arena_state(state.dmd_buffers):
            return state
        table = self.arena_for(state.params)
        arenas, leaf = arena_mod.split_state(state.dmd_buffers)
        bufs = fill_paths(leaf, arena_mod.buffers_leafwise(table, arenas))
        grams = state.dmd_gram
        if arena_mod.is_arena_state(grams):
            agrams, lgrams = arena_mod.split_state(grams)
            # bucket scope: K3 rebuilds the per-system Grams from the
            # buffers (the summed one cannot be split)
            grams = fill_paths(lgrams, arena_mod.grams_leafwise(
                table, agrams, self.cfg, arenas))
        return state._replace(dmd_buffers=bufs, dmd_gram=grams)

    def state_arenaize(self, state):
        """Inverse of ``state_leafwise`` for the DMD state: a restored
        per-leaf state packed into the arenas this accelerator runs with
        (the Grams only when streaming, summed per bucket in bucket scope,
        where ``arena.restream_grams`` then rewrites the current window's
        rows as the stream wrote them). No-op when arenas are off or the
        state is already packed; params stay per leaf (``Trainer.fit``
        makes them resident)."""
        if state is None or state.dmd_buffers is None \
                or arena_mod.is_arena_state(state.dmd_buffers) \
                or not self.arena_on:
            return state
        table = self.arena_for(state.params)
        if not table:
            return state
        paths = arena_mod.arena_paths(table)

        def strip(tree):
            return map_with_paths(lambda p, x: None if p in paths else x,
                                  tree)

        bufs = arena_mod.make_state(arena_mod.buffers_from_leafwise(
            table, by_path(state.dmd_buffers), self.cfg),
            strip(state.dmd_buffers))
        grams = state.dmd_gram
        if grams is not None and self.streaming:
            agrams = arena_mod.grams_from_leafwise(table, by_path(grams),
                                                   self.scope)
            arena_mod.restream_grams(agrams, arena_mod.split_state(bufs)[0],
                                     table, self.cfg, int(state.step))
            grams = arena_mod.make_state(agrams, strip(grams))
        return state._replace(dmd_buffers=bufs, dmd_gram=grams)

    # ---- state ------------------------------------------------------------
    def init(self, params: PyTree) -> Optional[PyTree]:
        """Zeroed snapshot state: the per-leaf buffer tree
        (``core/snapshots.py``) when no leaf is packed, else
        ``{"__arena__": {bucket_key: (n_blocks, m, block_n)}, "leaf":
        per-leaf tree with None at the packed paths}``."""
        if not self.cfg.enabled:
            return None
        plans = self.plans_for(params)
        table = self.arena_for(params)
        leaf = snap.init_buffers(params, self.cfg, plans, self.device,
                                 skip_paths=arena_mod.arena_paths(table))
        if not table:
            return leaf
        return arena_mod.make_state(
            arena_mod.init_arena_buffers(table, self.cfg, self.device), leaf)

    def init_grams(self, buffers) -> Optional[PyTree]:
        """Zeroed streaming Grams mirroring `buffers`, or None when not
        streaming: (n_sys, m, m) fp32 per bucket ((1, m, m) in bucket
        scope), (stack..., m, m) fp32 per per-leaf buffer."""
        if buffers is None or not self.streaming:
            return None
        if self._plans is None:
            raise ValueError("init_grams before init: no plan table yet")
        if not arena_mod.is_arena_state(buffers):
            return snap.init_grams(buffers, self._plans)
        leaf = arena_mod.split_state(buffers)[1]
        return arena_mod.make_state(
            arena_mod.init_arena_grams(self._arena, self.device, self.scope),
            snap.init_grams(leaf, self._plans))

    @torch.no_grad()
    def record(self, buffers, params: PyTree, slot, grams=None):
        """Write params into each buffer's row `slot` (a scalar, or the
        per-group vector from ``slots(step)``; negative entries are
        skipped) and, with `grams`, refresh the streaming Gram rows. Both
        are updated in place; returns (buffers, grams)."""
        if buffers is None:
            return None, None
        if self.n_groups > 1 and np.ndim(slot) != 1:
            raise ValueError(
                f"{self.n_groups} schedule groups need the per-group slot "
                "vector: pass acc.slots(step), not a scalar slot")
        plans = self.plans_for(params)
        leaf, lgrams = buffers, grams
        p_leaf = params
        if arena_mod.is_arena_state(buffers):
            table = self.arena_for(params)
            arenas, leaf = arena_mod.split_state(buffers)
            arena_mod.record(arenas, params, slot, table, self.cfg)
            if grams is not None:
                agrams, lgrams = arena_mod.split_state(grams)
                arena_mod.update_grams(agrams, arenas, slot, self.cfg, table)
            if arena_mod.is_arena_state(params):
                # resident: the per-leaf route only sees the leaf subtree
                p_leaf = arena_mod.split_state(params)[1]
        snap.record(leaf, p_leaf, slot, plans)
        if lgrams is not None:
            snap.update_grams(lgrams, leaf, slot, self.cfg, plans)
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
        if step is not None:
            if groups is None:
                groups = self.apply_groups(step)
            relax = self.relax_vector(step)
        else:
            relax = np.asarray([self.relax_for_round(round_idx, g)
                                for g in range(self.n_groups)], np.float32)
        gset = None if groups is None else frozenset(int(g) for g in groups)
        new_params, mean_rank = jump_tree(
            self.cfg, self.plans_for(params), params, buffers, grams, relax,
            groups=gset, arena=self.arena_for(params))
        return new_params, {"mean_rank": mean_rank.to(self.device)}
