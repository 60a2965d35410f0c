"""Seeded violations: named mutations that each break ONE audited
invariant, so that the audit is known to bite. Each flips exactly the pass
the reference names for it (``expect_fail``):

  drop-donation     every step rebinds its state to fresh tensors instead
                    of writing it in place -> donation-alias fails (state
                    storage lost, ring- and Gram-shaped copies)
  misalign-arena    shift one ArenaSegment's lane_start off the block grid
                    -> arena-layout fails (alignment and contiguity)
  force-pack        expand resident params leaf-wise inside record_update,
                    the non-resident record route: the pack gather's
                    bucket-sized concatenate reappears -> arena-residency
                    fails
  force-leaf-solves a bucket-scope build whose dmd_step still solves one
                    system per leaf -> solve-budget fails (host eigh rows
                    over the one-per-bucket budget)
  overlap-groups    two match-everything group rules with distinct phases
                    -> schedule-conflict fails (overlap)
  force-recompile   the serve engine's prompt buckets degraded to exact
                    lengths: every novel steady-state length builds a
                    fresh prefill program -> serve-compile fails (steady
                    compiles > 0, registry above its ceiling)

  force-allgather   (needs --mesh) gather every lane-sharded ring to
                    full inside record_update, a buffer-sized all-gather
                    -> collective-budget fails (record_update makes an
                    all-gather beside its Gram-row all-reduces)
  force-gather-model (needs --mesh; the port's own) the steps gather every
                    param to full over "model" too and the model runs as on
                    one device, the compute before tensor parallelism ->
                    collective-budget fails (param blocks all-gathered over
                    "model")

Mutations compose with ``build_context`` at its seams: ``config``
rewrites the ArchConfig before anything is built, ``donate`` and
``step_kw`` feed ``audit_step_fns``, ``wrap_fns`` replaces entry points, ``post`` edits the
static tables after the build, and ``serve`` / ``serve_cfg`` attach and
rewrite the serving build (``serve/audit.py::attach_serve``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional


@dataclass(frozen=True)
class Mutation:
    name: str
    doc: str
    expect_fail: str                     # the pass this mutation must trip
    donate: bool = True
    config: Optional[Callable] = None    # acfg -> acfg
    wrap_fns: Optional[Callable] = None  # (acc, fns) -> fns
    post: Optional[Callable] = None      # ctx -> None
    serve: bool = False                  # attach the serving build
    serve_cfg: Optional[Callable] = None  # ServeConfig -> ServeConfig
    needs_mesh: bool = False             # only a sharded build has it
    step_kw: Optional[Dict] = None       # audit_step_fns keywords


_REGISTRY: Dict[str, Mutation] = {}


def _register(m: Mutation) -> Mutation:
    _REGISTRY[m.name] = m
    return m


def get(name: str) -> Mutation:
    if name not in _REGISTRY:
        raise KeyError(f"unknown mutation {name!r}; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_mutations():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------

_register(Mutation(
    name="drop-donation",
    doc="every step rebinds its state to fresh tensors (no write in place)",
    expect_fail="donation-alias",
    donate=False))


def _misalign_arena(ctx) -> None:
    for key in sorted(ctx.arena):
        b = ctx.arena[key]
        if not b.segments:
            continue
        seg = dataclasses.replace(b.segments[-1],
                                  lane_start=b.segments[-1].lane_start + 1)
        ctx.arena[key] = dataclasses.replace(
            b, segments=b.segments[:-1] + (seg,))
        return
    raise ValueError("misalign-arena: no arena segments in this config "
                     "(dmd.arena off or every leaf excluded)")


def _force_allgather_fns(acc, fns):
    from repro_torch.core import arena as arena_mod

    inner = fns["record_update"]

    def record_update(buffers, grams, params, slots):
        if arena_mod.is_arena_state(buffers):
            table = acc.arena_for(params)
            for key, buf in arena_mod.split_state(buffers)[0].items():
                b = table[key]
                if b.lane_axes:
                    # every rank's block of the ring, to every rank (flat
                    # and left in pieces, so that only the collective, not
                    # a new ring-shaped tensor or a pack, gives it away)
                    acc.mesh.all_gather(buf.reshape(-1),
                                        b.sys_axes + b.lane_axes)
        return inner(buffers, grams, params, slots)

    return {**fns, "record_update": record_update}


_register(Mutation(
    name="force-allgather",
    doc="gather every lane-sharded ring to full inside record_update (a "
        "buffer-sized all-gather)",
    expect_fail="collective-budget",
    wrap_fns=_force_allgather_fns,
    needs_mesh=True))


_register(Mutation(
    name="force-gather-model",
    doc="gather every param to full over 'model' too and run the model as "
        "on one device (the compute before tensor parallelism)",
    expect_fail="collective-budget",
    step_kw={"tp_compute": False},
    needs_mesh=True))


_register(Mutation(
    name="misalign-arena",
    doc="shift one ArenaSegment.lane_start off the 128-lane block grid",
    expect_fail="arena-layout",
    post=_misalign_arena))


def _force_pack_fns(acc, fns):
    from repro_torch.core import arena as arena_mod

    def record_update(buffers, grams, params, slots):
        if not arena_mod.is_arena_state(params):
            raise ValueError(
                "force-pack needs a RESIDENT build (dmd.arena_native on "
                "with a resident-capable optimizer): the audited state has "
                "per-leaf params, there is nothing to force back")
        # per-leaf views of the flat buckets: record takes the pack route
        # and gathers every bucket's row with a concatenate
        params = arena_mod.tree_leafwise(acc.arena_for(params), params)
        return acc.record(buffers, params, slots, grams)

    return dict(fns, record_update=record_update)


_register(Mutation(
    name="force-pack",
    doc="expand resident params leaf-wise inside record_update (the pack "
        "gather resurfaces)",
    expect_fail="arena-residency",
    wrap_fns=_force_pack_fns))


def _bucket_scope_config(acfg):
    return dataclasses.replace(
        acfg, dmd=dataclasses.replace(acfg.dmd, scope="bucket"))


def _force_leaf_solves_fns(acc, fns):
    import torch

    from repro_torch.core.accelerator import jump_tree
    from repro_torch.train.step import assign_

    # the silent per-leaf fallback in one seam: the build is bucket scope
    # (budget: one solve per bucket) but the jump solves one system per
    # leaf, its Grams recomputed under the leaf-scope tables. Only the
    # ungated build mutates: one tripped target is all the audit needs.
    if acc.controller_on:
        return fns
    leaf_cfg = dataclasses.replace(acc.cfg, scope="leaf")

    @torch.no_grad()
    def dmd_step(state, relax, groups=None):
        new_params, mean_rank = jump_tree(
            leaf_cfg, acc.plans_for(state.params), state.params,
            state.dmd_buffers, None, relax, groups=groups,
            arena=acc.arena_for(state.params))
        assign_(state.params, new_params)
        return state, {"mean_rank": mean_rank}

    return dict(fns, dmd_step=dmd_step)


_register(Mutation(
    name="force-leaf-solves",
    doc="bucket-scope build whose jump still solves one system per leaf "
        "(the silent per-leaf fallback)",
    expect_fail="solve-budget",
    config=_bucket_scope_config,
    wrap_fns=_force_leaf_solves_fns))


def _overlap_groups(acfg):
    from repro_torch.core.schedule import DMDGroupRule
    rules = (DMDGroupRule(name="overlap-a", path_regex="", phase=0),
             DMDGroupRule(name="overlap-b", path_regex="", phase=1))
    return dataclasses.replace(
        acfg, dmd=dataclasses.replace(acfg.dmd, groups=rules))


_register(Mutation(
    name="overlap-groups",
    doc="two match-everything group rules with distinct phases",
    expect_fail="schedule-conflict",
    config=_overlap_groups))


def _force_recompile_serve_cfg(scfg):
    # exact-length prompt "buckets": each novel steady-state length builds
    # a fresh prefill program
    return dataclasses.replace(scfg, force_recompile=True)


_register(Mutation(
    name="force-recompile",
    doc="serve engine with exact-length prompt buckets (a fresh prefill "
        "program per novel steady-state length)",
    expect_fail="serve-compile",
    serve=True,
    serve_cfg=_force_recompile_serve_cfg))
