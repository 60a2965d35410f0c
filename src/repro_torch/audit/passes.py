"""The audit's ten passes, the reference's restated for eager torch.

Each pass is a function over an ``AuditContext`` (recorded steps and the
static plan / schedule / arena tables), registered under the reference's
name with the reference's ``info`` keys, in the reference's report order:

  donation-alias            every state tensor keeps its storage; no new
                            ring- or Gram-shaped tensor outside a kernel
  collective-budget         no c10d op on one device; under a mesh the
                            record_update all-reduces exactly the
                            analytic Gram-row bytes, no target
                            all-gathers a ring-buffer-shaped tensor, and
                            none a param block over "model"
  trace-budget              recorded ops and kernel calls within the pins
                            (``audit/pins.py``)
  solve-budget              host-solve rows per jump within the dmd.scope
                            budget (bucket scope: one per bucket)
  dtype-flow                no silent fp32<->bf16 casts of Grams or rings
  host-callback-in-hot-loop no host sync in train_step / record_update
  arena-layout              offset table, alignment and eligibility
  arena-residency           resident params: no bucket-sized 1-D gather in
                            the record arm
  schedule-conflict         overlapping rules, phase-residue collisions,
                            controller clamps
  serve-compile             the serve registry within its bucket ceiling,
                            zero steady builds, nothing dropped, decode
                            over the slot table in place

Where the reference reads a jaxpr equation, these read a recorded op
(``audit/ops.py``); the info key keeps the reference's name (``eqns``
counts recorded ops). Kernel calls are single opaque ops on either
device, so the counts are the same on the CPU and the card.
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.audit import ops as ops_mod
from repro_torch.audit.registry import Violation, register_pass
from repro_torch.core.leafplan import ROUTES

# the reference's floor of the psum budget (its slack multiplies the
# analytic bytes, which are 0 without a mesh)
PSUM_FLOOR = 4096


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


# the ops that copy a tensor whole
_COPIES = ("clone", "_to_copy", "copy")


def _fresh_shaped(t, shapes, copies_only: bool = False) -> List[str]:
    """Shape strings of the new tensors of `shapes` that ops outside the
    kernels made in target `t` (a kernel's outputs are the kernel's), or
    with `copies_only` those that whole-tensor copies made."""
    return [m.shape for o in t.ops if o.kind in ("aten", "transfer")
            and (not copies_only or o.name.split(".")[1] in _COPIES)
            for m in o.fresh_outputs if m.shape in shapes]


# ---------------------------------------------------------------------------
# donation-alias
# ---------------------------------------------------------------------------

@register_pass(
    "donation-alias",
    "every ring/Gram/param/moment tensor keeps its storage; no new "
    "ring-shaped tensor and no Gram copy outside a kernel")
def donation_alias(ctx):
    """The eager form of the reference's donation audit: a step must write
    its state in place (``train/step.py::assign_``), so that the addresses
    a CUDA graph captures stay valid. ``alias_count`` counts the state
    tensors whose storage the call kept: all of them for the fused step
    and the gated jump, at least the rings and Grams for the others.
    Outside the kernels no op may make a new tensor of a ring's shape (an
    O(m·n) copy) nor copy a Gram whole (the reference's Gram-shaped
    copy); O(n_sys·m²) arithmetic on a Gram (the affine shift, the
    finiteness test of the solve) is not a copy."""
    vs: List[Violation] = []
    info: Dict[str, object] = {}
    for name, t in sorted(ctx.targets.items()):
        if name in ("train_step", "dmd_step_gated"):
            expect, exact = t.n_state_leaves, True
        else:
            expect, exact = t.n_dmd_leaves, False
        ac = t.alias_count
        info[f"{name}.alias_count"] = ac
        info[f"{name}.alias_expected"] = (("==" if exact else ">=")
                                          + str(expect))
        if ac != expect if exact else ac < expect:
            lost = sorted(k for k, p in t.storage_before.items()
                          if t.storage_after.get(k) != p)
            vs.append(Violation(
                "donation-alias", name,
                f"{ac} state tensors kept their storage, expected "
                f"{'==' if exact else '>='} {expect}: rebound {lost[:4]}"))
        if not t.donated:
            vs.append(Violation(
                "donation-alias", name,
                "the step rebinds its state to fresh tensors instead of "
                f"writing it in place ({ac} of {t.n_state_leaves} kept)"))
        buf_copies = _fresh_shaped(t, t.buffer_shapes)
        gram_copies = _fresh_shaped(t, t.gram_shapes, copies_only=True)
        info[f"{name}.dmd_copies"] = len(buf_copies) + len(gram_copies)
        if buf_copies:
            vs.append(Violation(
                "donation-alias", name,
                f"{len(buf_copies)} new ring-shaped tensor(s) outside the "
                f"kernels: {sorted(set(buf_copies))[:4]}"))
        if gram_copies:
            vs.append(Violation(
                "donation-alias", name,
                f"{len(gram_copies)} Gram-shaped copy op(s): "
                f"{sorted(set(gram_copies))[:4]}"))
    return vs, info


# ---------------------------------------------------------------------------
# collective-budget
# ---------------------------------------------------------------------------

def record_allreduce_bytes(ctx) -> int:
    """The analytic all-reduce bytes of one ``record_update`` under the
    mesh: each lane-sharded bucket sums its (n_sys, m) fp32 Gram rows once
    (a system-sharded one, its rank's n_sys rows), each lane-sharded
    per-leaf plan its (stack..., m) row once. 0 without a mesh."""
    from repro_torch.core.arena import arena_paths
    from repro_torch.core.leafplan import plan_entries

    if ctx.mesh is None:
        return 0
    sizes = dict(zip(ctx.mesh.axis_names, ctx.mesh.devices.shape))
    total = 0
    for b in ctx.arena.values():
        if b.lane_axes:
            total += b.scope_n_sys(ctx.cfg.scope) * b.m * 4
    packed = arena_paths(ctx.arena)
    for p in plan_entries(ctx.plans):
        if p.path in packed or not p.psum_axes():
            continue
        n_sys = 1
        for d, e in zip(p.shape[:p.stack_dims], p.stack_spec_entries):
            shards = _prod(sizes.get(a, 1) for a in (
                () if e is None else (e if isinstance(e, tuple) else (e,))))
            n_sys *= d // shards
        total += n_sys * p.m * 4
    return total


@register_pass(
    "collective-budget",
    "no collective on one device; under a mesh record_update all-reduces "
    "exactly the analytic Gram-row bytes, no target all-gathers a "
    "ring-buffer-shaped tensor, and none a param block over 'model'")
def collective_budget(ctx):
    """On one device any c10d op recorded in a step is a violation. Under
    a mesh (the collectives each target made through it, ``ctx.mesh``):
    ``record_update`` makes all-reduces only, whose bytes equal the
    analytic O(n_sys*m) Gram-row sums of the lane-sharded buckets and
    leaves, no target all-gathers a tensor of a ring buffer's shape (a
    data pass must sum Gram partials, never gather a buffer), and, where
    the mesh's "model" axis is larger than one, no target all-gathers a
    param block over "model" (the compute is tensor-parallel: a rank
    reads its "model" block of each param; heads moved between layouts
    are activations, recorded under their sites). The psum budget and the
    smallest ring are reported as the reference reports them."""
    vs: List[Violation] = []
    info: Dict[str, object] = {}
    want = record_allreduce_bytes(ctx)
    info["psum_budget_bytes"] = PSUM_FLOOR + want
    first = ctx.targets.get("train_step",
                            next(iter(ctx.targets.values()), None))
    buf_bytes = [ops_mod.shape_bytes(s)
                 for s in (first.buffer_shapes if first else ())]
    info["min_buffer_bytes"] = min(buf_bytes) if buf_bytes else None
    if ctx.mesh is not None:
        info["record_allreduce_bytes_analytic"] = want
        for name, t in sorted(ctx.targets.items()):
            counts: Dict[str, List[int]] = {}
            for c in t.collectives:
                n = counts.setdefault(c["kind"], [0, 0])
                n[0] += 1
                n[1] += c["bytes"]
            info[f"{name}.collectives"] = counts
            shapes = {ops_mod.shape_str_of(c["dtype"], c["shape"])
                      for c in t.collectives if c["kind"] == "all_gather"}
            hits = sorted(shapes & set(t.buffer_shapes))
            if hits:
                vs.append(Violation(
                    "collective-budget", name,
                    f"all-gather of a ring-buffer-shaped tensor {hits}: a "
                    "sharded data pass must sum Gram partials, never "
                    "gather a buffer"))
            model = sorted({c["what"] for c in t.collectives
                            if c["kind"] == "all_gather"
                            and "model" in c["axes"]
                            and str(c.get("what") or "").startswith(
                                "param:")})
            info[f"{name}.model_param_gathers"] = len(model)
            if model:
                vs.append(Violation(
                    "collective-budget", name,
                    f"{len(model)} param block(s) all-gathered over "
                    f"'model' ({model[:3]}): the compute over 'model' must "
                    "be tensor-parallel, each rank on its own block"))
            if name != "record_update":
                continue
            other = sorted(k for k in counts if k != "all_reduce")
            got = counts.get("all_reduce", [0, 0])[1]
            if other or got != want:
                vs.append(Violation(
                    "collective-budget", name,
                    f"record_update made {counts}: want all-reduces only, "
                    f"{want} bytes"))
        return vs, info
    for name, t in sorted(ctx.targets.items()):
        coll = t.recording.collectives
        counts: Dict[str, List[int]] = {}
        for o in coll:
            c = counts.setdefault(o.name, [0, 0])
            c[0] += 1
            c[1] += sum(ops_mod.shape_bytes(m.shape) for m in o.inputs)
        info[f"{name}.collectives"] = counts
        if coll:
            vs.append(Violation(
                "collective-budget", name,
                f"{len(coll)} collective(s) on one device: "
                f"{sorted(counts)[:4]}"))
    return vs, info


# ---------------------------------------------------------------------------
# trace-budget
# ---------------------------------------------------------------------------

@register_pass(
    "trace-budget",
    "recorded op / kernel-call counts within the pinned ceilings")
def trace_budget(ctx):
    """``eqns`` is the count of recorded ops (``Recording.count``: aten
    ops and opaque kernel and host-solve calls, views and transfers
    apart), ``launches`` the kernel calls among them; ``device_launches``
    the kernels the wrappers' counters saw launch (0 on the CPU). The
    pins gate the real builds: a mutated build (``--mutate``) is a
    different program by design, seeded to trip its own pass, and reports
    its counts as info."""
    from repro_torch.audit import pins

    vs: List[Violation] = []
    info: Dict[str, object] = {}
    for name, t in sorted(ctx.targets.items()):
        rec = t.recording
        n, launches = rec.count, len(rec.kernel_calls)
        info[f"{name}.eqns"] = n
        info[f"{name}.launches"] = launches
        info[f"{name}.device_launches"] = dict(sorted(t.launches.items()))
        pin = pins.trace_ceiling(ctx.config_key, name)
        if ctx.mutate:
            info[f"{name}.pin"] = f"not applied (mutated: {ctx.mutate})"
            continue
        if pin is None:
            info[f"{name}.pin"] = "none (unpinned config: counts are info)"
            continue
        info[f"{name}.pin"] = dict(pin)
        if "eqns" in pin and n > pin["eqns"]:
            vs.append(Violation(
                "trace-budget", name,
                f"{n} recorded ops > pinned ceiling {pin['eqns']} for "
                f"{ctx.config_key}: step growth (see repro_torch/audit/"
                "pins.py for the bump procedure)"))
        if "launches" in pin and launches > pin["launches"]:
            vs.append(Violation(
                "trace-budget", name,
                f"{launches} kernel calls > pinned ceiling "
                f"{pin['launches']} for {ctx.config_key}"))
    return vs, info


# ---------------------------------------------------------------------------
# solve-budget
# ---------------------------------------------------------------------------

# the targets that run the jump's coefficient solves
_SOLVE_TARGETS = ("dmd_step", "dmd_step_gated")


def solve_budget_rows(ctx) -> int:
    """The analytic per-jump solve budget: the systems one full jump may
    solve under ``cfg.scope``. Leaf scope: one per packed system and one
    per unpacked per-leaf system; bucket scope: one per bucket."""
    from repro_torch.core.arena import arena_paths
    from repro_torch.core.leafplan import plan_entries

    scope = ctx.cfg.scope
    total = sum(b.gram_lead(scope) for b in ctx.arena.values())
    packed = arena_paths(ctx.arena)
    for p in plan_entries(ctx.plans):
        if p.path in packed:
            continue
        total += _prod(p.shape[:p.stack_dims]) if p.stack_dims else 1
    return total


def _batch_rows(shape: str) -> int:
    dims = [int(d) for d in shape.split("[", 1)[1].rstrip("]").split(",")
            if d]
    return _prod(dims[:-2]) if len(dims) >= 2 else 1


@register_pass(
    "solve-budget",
    "host-solve rows (POD eigh / eig host step) per jump within the "
    "dmd.scope budget — bucket scope: one per bucket")
def solve_budget(ctx):
    """Counts the BATCH rows of the host solves the jump ran, where
    ``core/dmd.py`` makes them: ``_lag_eigh`` (the POD basis both modes
    share, "eigh") and eig mode's host step ("eig") are opaque ops whose
    input stack's leading dims are the systems solved. A silent fallback
    to per-leaf solves under ``scope="bucket"`` keeps the op count and
    only the rows give it away."""
    vs: List[Violation] = []
    info: Dict[str, object] = {}
    budget = solve_budget_rows(ctx)
    info["solve_budget_rows"] = budget
    info["scope"] = ctx.cfg.scope
    for name in _SOLVE_TARGETS:
        t = ctx.targets.get(name)
        if t is None:
            continue
        rows = {"host.eigh": 0, "host.eig": 0}
        for o in t.ops:
            if o.name in rows and o.inputs:
                rows[o.name] += _batch_rows(o.inputs[0].shape)
        ne, nc = rows["host.eigh"], rows["host.eig"]
        info[f"{name}.eigh_rows"] = ne
        info[f"{name}.callback_rows"] = nc
        for kind, n in (("POD eigh", ne), ("eig host-callback", nc)):
            if n > budget:
                vs.append(Violation(
                    "solve-budget", name,
                    f"{n} {kind} rows > per-jump solve budget {budget} "
                    f"(scope={info['scope']}): the jump batches more "
                    "coefficient systems than the scope allows — a "
                    "bucket-scoped bucket fell back to per-leaf solves"))
    return vs, info


# ---------------------------------------------------------------------------
# dtype-flow
# ---------------------------------------------------------------------------

def _twin(shape: str, dtype: str) -> str:
    return dtype + "[" + shape.split("[", 1)[1]


def _converts(t) -> List[tuple]:
    """(result shape, operand shape) of every dtype-changing copy outside
    the kernels (their twins' per-tile upcasts are inside the spans)."""
    out = []
    for o in t.ops:
        if o.kind not in ("aten", "transfer"):
            continue
        base = o.name.split(".")[1]
        if base in ("_to_copy", "copy") and o.inputs and o.outputs:
            src, dst = o.inputs[0], o.outputs[0]
        elif base == "copy_" and len(o.inputs) >= 2:
            src, dst = o.inputs[1], o.inputs[0]
        else:
            continue
        if src.dtype != dst.dtype:
            out.append((dst.shape, src.shape))
    return out


@register_pass(
    "dtype-flow",
    "no silent fp32<->bf16 casts on Gram or snapshot-buffer tensors")
def dtype_flow(ctx):
    import torch

    vs: List[Violation] = []
    info: Dict[str, object] = {}
    snap = getattr(torch, ctx.cfg.snapshot_dtype)
    snap_bf16 = snap == torch.bfloat16
    upcast_ok = bool(ctx.cfg.gram_upcast)
    info["snapshot_dtype"] = str(snap).removeprefix("torch.")
    info["gram_upcast"] = upcast_ok
    for name, t in sorted(ctx.targets.items()):
        converts = _converts(t)
        info[f"{name}.converts"] = len(converts)
        for res, opnd in converts:
            if opnd in t.gram_shapes and res == _twin(opnd, "bf16"):
                vs.append(Violation(
                    "dtype-flow", name,
                    f"Gram tensor downcast {opnd} -> {res}: Grams must "
                    "stay fp32 (accumulated inner products)"))
            if opnd not in t.buffer_shapes:
                continue
            if not snap_bf16 and res == _twin(opnd, "bf16"):
                vs.append(Violation(
                    "dtype-flow", name,
                    f"snapshot buffer downcast {opnd} -> {res} with "
                    "snapshot_dtype=float32 (silent precision loss)"))
            if snap_bf16 and not upcast_ok and res == _twin(opnd, "f32"):
                vs.append(Violation(
                    "dtype-flow", name,
                    f"whole-buffer upcast {opnd} -> {res} with "
                    "gram_upcast=False: the bf16 path must accumulate in "
                    "f32 WITHOUT materializing an f32 buffer copy"))
    return vs, info


# ---------------------------------------------------------------------------
# host-callback-in-hot-loop
# ---------------------------------------------------------------------------

@register_pass(
    "host-callback-in-hot-loop",
    "no host sync in train_step / record_update (the jump whitelisted)")
def host_callback_in_hot_loop(ctx):
    """Counts the host syncs each step made (``Recording.syncs``: scalar
    reads, data-dependent shapes, copies from the card to the host,
    also inside opaque calls). The whitelist is ``dmd_step`` in EVERY
    mode, not only eig mode as in the reference: the port's jump reads
    its Grams back for the host eigh (``core/dmd.py::_lag_eigh``) in
    every mode, a deliberate deviation (ROADMAP Queue 3), and the gated
    jump reads its accept flags once."""
    vs: List[Violation] = []
    info: Dict[str, object] = {}
    for name, t in sorted(ctx.targets.items()):
        syncs = t.recording.syncs
        info[f"{name}.callbacks"] = len(syncs)
        if not syncs:
            continue
        if name.startswith("dmd_step"):
            info[f"{name}.whitelist"] = (
                "the jump's host solve (core/dmd.py::_lag_eigh, and eig "
                "mode's _host_eig_step) and the gate's one flag read")
            continue
        vs.append(Violation(
            "host-callback-in-hot-loop", name,
            f"{len(syncs)} host sync(s) in a hot-loop step "
            f"({sorted({o.name for o in syncs})[:4]}): each stalls the "
            "host on the device and breaks a CUDA-graph capture"))
    return vs, info


# ---------------------------------------------------------------------------
# arena-layout
# ---------------------------------------------------------------------------

@register_pass(
    "arena-layout",
    "128-lane alignment, no system-straddling blocks, offset table "
    "consistent with the LeafPlan pytree, eligibility partition exact")
def arena_layout(ctx):
    from repro_torch.core.arena import arena_eligible, arena_paths
    from repro_torch.core.leafplan import plan_entries

    vs: List[Violation] = []
    info: Dict[str, object] = {}
    entries = plan_entries(ctx.plans)
    by_path = {p.path: p for p in entries}
    packed = arena_paths(ctx.arena)
    info["n_leaves"] = len(entries)
    info["n_packed"] = len(packed)
    info["n_buckets"] = len(ctx.arena)

    # eligibility partition: packed iff eligible; every excluded leaf
    # keeps a valid per-leaf plan
    for p in entries:
        elig = arena_eligible(p, ctx.cfg, ctx.mesh)
        if elig and p.path not in packed:
            vs.append(Violation(
                "arena-layout", p.path,
                "arena-eligible leaf missing from every ArenaBucket "
                "(pays per-leaf dispatch it shouldn't)"))
        if not elig and p.path in packed:
            vs.append(Violation(
                "arena-layout", p.path,
                f"ineligible leaf packed into an arena (route={p.route}, "
                f"anchor={ctx.cfg.anchor}, sharded=False) — the "
                "dot_general route and non-leading sharded stack dims "
                "cannot run the segmented kernels"))
        if p.path not in packed:
            if p.route not in ROUTES:
                vs.append(Violation("arena-layout", p.path,
                                    f"unknown per-leaf route {p.route!r}"))
            if p.sched is None or p.m < 2:
                vs.append(Violation(
                    "arena-layout", p.path,
                    f"per-leaf plan has no usable window (m={p.m})"))
            if p.route != "dot_general" and p.block_n % 128 != 0:
                vs.append(Violation(
                    "arena-layout", p.path,
                    f"per-leaf block_n={p.block_n} is not a 128-lane "
                    "multiple"))

    seen: Dict[str, str] = {}
    for key in sorted(ctx.arena):
        b = ctx.arena[key]
        where = f"arena[{key}]"
        if b.block_n <= 0 or b.block_n % 128 != 0:
            vs.append(Violation(
                "arena-layout", where,
                f"block_n={b.block_n} is not a positive 128-lane multiple"))
        sys_cursor = lane_cursor = 0
        for s in b.segments:
            seg_where = f"{where}:{s.path}"
            if s.path in seen:
                vs.append(Violation(
                    "arena-layout", seg_where,
                    f"leaf packed twice (also in {seen[s.path]})"))
            seen[s.path] = key
            plan = by_path.get(s.path)
            if plan is None:
                vs.append(Violation(
                    "arena-layout", seg_where,
                    "segment has no LeafPlan (stale offset table)"))
            elif (tuple(s.shape) != tuple(plan.shape)
                  or s.stack_dims != plan.stack_dims
                  or s.param_dtype != plan.dtype
                  or b.group != plan.group):
                vs.append(Violation(
                    "arena-layout", seg_where,
                    "segment disagrees with the LeafPlan table "
                    f"(shape {tuple(s.shape)} vs {tuple(plan.shape)}, "
                    f"stack {s.stack_dims} vs {plan.stack_dims}, dtype "
                    f"{s.param_dtype} vs {plan.dtype}, group {b.group} "
                    f"vs {plan.group})"))
            if s.sys_start != sys_cursor:
                vs.append(Violation(
                    "arena-layout", seg_where,
                    f"sys_start={s.sys_start}, expected {sys_cursor} "
                    "(non-contiguous system packing)"))
            if s.lane_start != lane_cursor:
                vs.append(Violation(
                    "arena-layout", seg_where,
                    f"lane_start={s.lane_start}, expected {lane_cursor} "
                    "(offset table out of step with segment lengths)"))
            if b.block_n > 0 and s.lane_start % b.block_n != 0:
                vs.append(Violation(
                    "arena-layout", seg_where,
                    f"lane_start={s.lane_start} not aligned to "
                    f"block_n={b.block_n}: a block would straddle the "
                    "previous system"))
            if b.block_n > 0 and s.seg_lanes % b.block_n != 0:
                vs.append(Violation(
                    "arena-layout", seg_where,
                    f"seg_lanes={s.seg_lanes} not a block_n={b.block_n} "
                    "multiple (block straddles the next system)"))
            want = _prod(s.local_shape[s.stack_dims:])
            if s.flat_local != want:
                vs.append(Violation(
                    "arena-layout", seg_where,
                    f"flat_local={s.flat_local} != prod(local_shape"
                    f"[stack:])={want}"))
            if s.seg_lanes < s.flat_local:
                vs.append(Violation(
                    "arena-layout", seg_where,
                    f"seg_lanes={s.seg_lanes} < flat_local="
                    f"{s.flat_local}: lanes would be truncated"))
            n_sys_want = _prod(s.local_shape[:s.stack_dims]) or 1
            if s.n_sys != n_sys_want:
                vs.append(Violation(
                    "arena-layout", seg_where,
                    f"n_sys={s.n_sys} != prod(stack shape)={n_sys_want}"))
            sys_cursor += s.n_sys
            lane_cursor += s.n_sys * s.seg_lanes
        if lane_cursor != b.n_lanes_local:
            vs.append(Violation(
                "arena-layout", where,
                f"segment lanes sum to {lane_cursor} but the bucket "
                f"carries n_lanes_local={b.n_lanes_local}"))
    return vs, info


# ---------------------------------------------------------------------------
# arena-residency
# ---------------------------------------------------------------------------

# the record arm lives in the data passes: the fused step and
# record_update (the jump legitimately builds bucket-sized rows)
_RESIDENCY_TARGETS = ("train_step", "record_update")
_PACK_OPS = ("cat", "concat", "gather", "index_select")


@register_pass(
    "arena-residency",
    "resident params: record is one copy per bucket — no bucket-sized 1-D "
    "pack concatenate/gather in the data passes")
def arena_residency(ctx):
    """With arena-native residency (``dmd.arena_native``) the params LIVE
    in the flat (N,) buckets, so recording a snapshot is one copy per
    bucket: a bucket-sized 1-D ``cat``, ``gather`` or ``index_select`` in
    a data pass means the pack route (``core/arena.py::pack_row``) came
    back and one full gather per record is paid silently."""
    from repro_torch.core import arena as arena_mod
    from repro_torch.train.step import RESIDENT_OPTIMIZERS

    vs: List[Violation] = []
    info: Dict[str, object] = {}
    resident = bool(ctx.state is not None and arena_mod.is_arena_state(
        getattr(ctx.state, "params", None)))
    native = bool(ctx.cfg.arena_native)
    info["resident"] = resident
    info["arena_native"] = native
    if not resident:
        opt = getattr(getattr(ctx.acfg, "optimizer", None), "name", None)
        info["optimizer"] = opt
        if native and ctx.arena and opt in RESIDENT_OPTIMIZERS:
            vs.append(Violation(
                "arena-residency", "state",
                f"arena_native on, optimizer {opt!r} supports residency "
                "and buckets exist, but the audited TrainState is NOT "
                "resident — the audit ran a layout training never runs "
                "(targets.py must apply state_resident)"))
        return vs, info
    if not ctx.arena:
        return vs, info

    floor = min(b.n_lanes_local for b in ctx.arena.values())
    info["min_bucket_lanes"] = floor

    def is_pack(o) -> bool:
        if o.kind != "aten" or o.name.split(".")[1] not in _PACK_OPS:
            return False
        dims = [d for d in o.outputs[0].shape.split("[", 1)[1]
                .rstrip("]").split(",") if d] if o.outputs else []
        return len(dims) == 1 and int(dims[0]) >= floor

    for name in _RESIDENCY_TARGETS:
        t = ctx.targets.get(name)
        if t is None:
            continue
        n = sum(1 for o in t.ops if is_pack(o))
        info[f"{name}.pack_ops"] = n
        if n:
            vs.append(Violation(
                "arena-residency", name,
                f"{n} bucket-sized 1-D concatenate/gather op(s) recorded "
                "with RESIDENT params: record must be one copy per bucket "
                "(the pack route leaked back in — core/arena.py::record "
                "resident branch)"))
    return vs, info


# ---------------------------------------------------------------------------
# schedule-conflict
# ---------------------------------------------------------------------------

@register_pass(
    "schedule-conflict",
    "no overlapping group rules, no phase-residue collisions between "
    "staggered groups, resolved table within clamps")
def schedule_conflict(ctx):
    from repro_torch.core.leafplan import plan_entries
    from repro_torch.core.schedule import jump_collisions, rules_for_config

    vs: List[Violation] = []
    info: Dict[str, object] = {}
    groups = list(ctx.groups)
    info["n_groups"] = len(groups)

    for g in groups:
        where = f"group[{g.index}:{g.name}]"
        if g.m < 2:
            vs.append(Violation("schedule-conflict", where,
                                f"m={g.m}: DMD needs >= 2 snapshots"))
        if g.s < 1:
            vs.append(Violation("schedule-conflict", where,
                                f"s={g.s}: horizon must be >= 1"))
        if min(g.warmup_steps, g.cooldown_steps, g.phase) < 0:
            vs.append(Violation(
                "schedule-conflict", where,
                f"negative schedule field (warmup={g.warmup_steps}, "
                f"cooldown={g.cooldown_steps}, phase={g.phase})"))
        if g.cycle != g.m + g.cooldown_steps:
            vs.append(Violation(
                "schedule-conflict", where,
                f"cycle={g.cycle} != m+cooldown={g.m + g.cooldown_steps}"))
        if not (0.0 <= g.energy <= 1.0):
            vs.append(Violation(
                "schedule-conflict", where,
                f"energy={g.energy} outside [0, 1]"))
        ridge = float(g.ridge)
        if not (ridge >= 0.0 and math.isfinite(ridge)):
            vs.append(Violation(
                "schedule-conflict", where,
                f"ridge={ridge} must be finite and >= 0"))

    # the controller's clamps: an unsatisfiable gate or an empty or
    # out-of-range shrink ladder is a config bug the first jump would hit
    ccfg = ctx.cfg.controller
    if ccfg is not None and ccfg.enabled:
        rmax = float(ccfg.ridge_max)
        levels = tuple(ccfg.shrink_levels or ())
        info["controller"] = {
            "accept_tol": float(ccfg.accept_tol), "ridge_max": rmax,
            "shrink_levels": [float(f) for f in levels],
            "meta_lr": float(ccfg.meta_lr),
            "val_gate": bool(ccfg.val_gate),
        }
        if float(ccfg.accept_tol) <= -1.0:
            vs.append(Violation(
                "schedule-conflict", "controller",
                f"accept_tol={ccfg.accept_tol} <= -1: the gate can never "
                "accept a positive-loss jump (every round rolls back)"))
        if not levels:
            vs.append(Violation(
                "schedule-conflict", "controller",
                "shrink_levels is empty: the SCALED branch has no rungs"))
        for f in levels:
            if not 0.0 < float(f) < 1.0:
                vs.append(Violation(
                    "schedule-conflict", "controller",
                    f"shrink_levels entry {f} outside (0, 1)"))
        if not (rmax >= 0.0 and math.isfinite(rmax)):
            vs.append(Violation(
                "schedule-conflict", "controller",
                f"ridge_max={rmax} must be finite and >= 0"))
        mlr = float(ccfg.meta_lr)
        if not (0.0 <= mlr <= 1.0):
            vs.append(Violation(
                "schedule-conflict", "controller",
                f"meta_lr={mlr} outside [0, 1] (EMA step)"))
        for g in groups:
            ridge = float(g.ridge)
            if rmax > 0 and ridge > rmax:
                vs.append(Violation(
                    "schedule-conflict", f"group[{g.index}:{g.name}]",
                    f"ridge={ridge} above controller.ridge_max={rmax}: the "
                    "meta-tuner would clamp it down on the first round",
                    severity="warning"))

    # overlapping non-exclude rules: first match wins, so the second rule
    # is dead for every shared leaf
    rules = [r for r in rules_for_config(ctx.cfg) if not r.exclude]
    overlaps = 0
    for p in plan_entries(ctx.plans):
        ndim, size = len(p.shape), _prod(p.shape)
        hits = [r.name for r in rules if r.matches(p.path, ndim, size)]
        if len(hits) > 1:
            overlaps += 1
            vs.append(Violation(
                "schedule-conflict", p.path,
                f"{len(hits)} group rules match one leaf "
                f"({', '.join(hits)}): all but the first are dead here"))
    info["overlapping_leaves"] = overlaps

    # member counts: a rule-defined group no leaf selects is dead config
    members = [0] * len(groups)
    for p in plan_entries(ctx.plans):
        if p.group is not None and 0 <= p.group < len(groups):
            members[p.group] += 1
    info["group_members"] = members
    for g, n in zip(groups, members):
        if n == 0 and g.index > 0:
            vs.append(Violation(
                "schedule-conflict", f"group[{g.index}:{g.name}]",
                "group rule matches no leaf (dead group)",
                severity="warning"))

    # phase-residue collisions: an error only between groups that declared
    # distinct phases (they opted into staggering)
    pairs = jump_collisions(groups)
    info["jump_collisions"] = [list(p) for p in pairs]
    for ia, ib in pairs:
        a, b = groups[ia], groups[ib]
        if a.phase != b.phase:
            ra = (a.warmup_steps + a.phase + a.cycle - 1) % a.cycle
            rb = (b.warmup_steps + b.phase + b.cycle - 1) % b.cycle
            vs.append(Violation(
                "schedule-conflict",
                f"group[{a.index}:{a.name}]+group[{b.index}:{b.name}]",
                f"declared distinct phases ({a.phase} vs {b.phase}) but "
                f"jump residues collide (r={ra} mod {a.cycle} meets "
                f"r={rb} mod {b.cycle}, gcd={math.gcd(a.cycle, b.cycle)})"
                " — the stagger never takes effect"))
    return vs, info


# ---------------------------------------------------------------------------
# serve-compile
# ---------------------------------------------------------------------------

@register_pass(
    "serve-compile",
    "serve engine builds <= bucket ceiling, zero steady builds, decode "
    "over the slot table in place")
def serve_compile(ctx):
    """The serving engine's registry contract, over ``ctx.serve``
    (``serve/audit.py::attach_serve``):

      * the program registry never exceeds the analytic bucket ceiling
        (1 decode + prefill per prompt x batch bucket + insert per batch
        bucket + the ParamStore's landing copy);
      * ZERO programs built after ``mark_steady()`` (``force-recompile``'s
        exact-length "buckets" are the seeded violation);
      * no request dropped, and every slot-table cache tensor kept its
        storage over the whole workload.

    Over the ``serve_decode`` target (one recorded decode step): every
    slot-table cache tensor keeps its storage and no op makes a new
    tensor of a cache's shape."""
    vs: List[Violation] = []
    info: Dict[str, object] = {}
    s = ctx.serve
    if not s:
        info["note"] = ("no serving build attached — run the CLI with "
                        "--serve")
        return vs, info
    info.update(s)
    if int(s["n_programs"]) > int(s["max_programs"]):
        vs.append(Violation(
            "serve-compile", "registry",
            f"{s['n_programs']} programs exceed the bucket ceiling "
            f"{s['max_programs']} ({s['n_prompt_buckets']} prompt x "
            f"{s['n_batch_buckets']} batch buckets): some shape is not "
            "bucketed"))
    if int(s["steady_compiles"]) > 0:
        vs.append(Violation(
            "serve-compile", "registry",
            f"{s['steady_compiles']} compiles AFTER warmup: steady state "
            "must serve entirely from the warm program registry"))
    if int(s.get("dropped", 0)) > 0:
        vs.append(Violation(
            "serve-compile", "engine",
            f"{s['dropped']} requests dropped during the audit workload"))
    if "table_kept" in s and s["table_kept"] < s["table_leaves"]:
        vs.append(Violation(
            "serve-compile", "engine",
            f"only {s['table_kept']} of {s['table_leaves']} slot-table "
            "cache tensors kept their storage over the workload"))

    t = ctx.targets.get("serve_decode")
    if t is not None:
        copies = _fresh_shaped(t, t.buffer_shapes)
        info["decode_cache_copies"] = len(copies)
        if copies:
            vs.append(Violation(
                "serve-compile", "serve_decode",
                f"{len(copies)} cache-shaped new tensor(s) in decode (e.g. "
                f"{copies[0]}): the slot-table KV update is not in place"))
        ac = t.alias_count
        info["decode_alias_count"] = ac
        if ac < t.n_dmd_leaves:
            vs.append(Violation(
                "serve-compile", "serve_decode",
                f"only {ac} of {t.n_dmd_leaves} slot-table cache tensors "
                "kept their storage across decode"))
    return vs, info
