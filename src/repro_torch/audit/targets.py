"""Audit targets: one config -> the recorded steps and the static tables
every pass reads.

For an ``--arch`` (and ``--reduced``) this builds the entry points the
Trainer runs, through ``train/step.py::audit_step_fns``, on a state made
as ``Trainer.fit`` makes it (resident where the config says so), fills
the snapshot window with real training steps, and records each entry
point once (after one warm-up call, so that per-device caches are built
before the recording) with ``ops.record``:

  * ``train_step``      the fused step (record and streaming Gram inside),
  * ``dmd_step``        the plain (ungated) jump, every group,
  * ``dmd_step_gated``  the loss-gated controller variant (a
                        controller-enabled clone of the config),
  * ``record_update``   record and Gram maintenance alone.

A target holds the recorded ops and the storage pointer of every state
tensor before and after the call, in place of the reference's jaxpr and
HLO. The static tables are the LeafPlan tree, the ArenaBucket table and
the GroupSchedule table; their ``*_records`` views feed the JSON report.
``mutate=`` applies a named seeded violation (``audit/mutations.py``).

``device`` (default ``"cuda"``) is where the steps run; the op counts do
not depend on it (``audit/ops.py``).

``mesh_shape`` (CLI ``--mesh DxM``) audits the sharded build on this
rank's blocks: the caller has joined a process group of as many ranks
(``audit/__main__.py`` spawns them), every rank builds and records the
same targets, and each target also keeps the collectives it made through
the mesh (``launch/mesh.py::record_collectives``) for the collective
budget.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch

from repro_torch.audit import ops as ops_mod
from repro_torch.core.paths import keystr_leaves

PyTree = Any

# The reduced builds, the reference's: the CLI and the tests audit the
# SAME programs, or their pins diverge.
REDUCED_OVERRIDES = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=128,
                         n_heads=2, n_kv_heads=1, head_dim=16)
REDUCED_BATCH, REDUCED_SEQ = 4, 16

# pollutant-mlp --reduced: a softsign MLP of the same family, small enough
# for the tests (the paper's sizes stay the default)
REDUCED_MLP_SIZES = (6, 16, 32, 40)

# the train-step targets record at the first step from AUDIT_STEP on at
# which every group records (the reference traces step 5, where its record
# arm is in the program whatever the slot; here the host slot vector picks
# the arm, so the audited step must record)
AUDIT_STEP = 5
MLP_BATCH_ROWS = 8


@dataclass(frozen=True)
class AuditTarget:
    """One recorded call of one entry point."""
    name: str
    ops: Tuple[ops_mod.Op, ...]
    launches: Dict[str, int]        # kernel launches by wrapper counter
    donated: bool                   # built to write its state in place
    storage_before: Dict[str, int]  # state leaf -> storage pointer
    storage_after: Dict[str, int]   # the returned state's, same leaves
    n_state_leaves: int             # leaves that must keep their storage
    n_dmd_leaves: int               # ring + Gram leaves among them
    buffer_shapes: FrozenSet[str]   # shape strings (``ops.shape_str``)
    gram_shapes: FrozenSet[str]
    collectives: Tuple[dict, ...] = ()   # made through the mesh

    @property
    def recording(self) -> ops_mod.Recording:
        return ops_mod.Recording(list(self.ops), dict(self.launches))

    @property
    def alias_count(self) -> int:
        """State leaves whose storage the call kept."""
        return sum(1 for k, p in self.storage_before.items()
                   if self.storage_after.get(k) == p)


@dataclass
class AuditContext:
    arch: str
    reduced: bool
    mutate: Optional[str]
    acfg: Any
    acc: Any                        # DMDAccelerator (plans and arena built)
    plans: PyTree
    arena: Dict[str, Any]           # {key: ArenaBucket}
    groups: Tuple[Any, ...]         # the resolved GroupSchedule table
    state: Any                      # TrainState the targets ran on
    targets: Dict[str, AuditTarget] = field(default_factory=dict)
    # the serve build's registry counts (serve/audit.py::attach_serve), or
    # None when none was attached (--serve)
    serve: Optional[Dict[str, Any]] = None
    device: str = "cpu"
    mesh: Any = None                # launch/mesh.py::Mesh, or None

    @property
    def cfg(self):
        return self.acfg.dmd

    @property
    def config_key(self) -> str:
        return (self.arch + ("-reduced" if self.reduced else "")
                + ("-mesh" if self.mesh is not None else ""))

    def meta(self) -> Dict[str, Any]:
        return {"reduced": self.reduced,
                "mesh": ("x".join(map(str, self.mesh.devices.shape))
                         if self.mesh is not None else None),
                "mutate": self.mutate,
                "config_key": self.config_key,
                "device": self.device,
                "torch": torch.__version__}

    def tables(self) -> Dict[str, Any]:
        """The static tables as JSON-able records."""
        from repro_torch.core import arena as arena_mod
        from repro_torch.core import leafplan, schedule as sched_mod
        return {"plans": leafplan.plan_records(self.plans),
                "arena": arena_mod.layout_table(self.arena,
                                                scope=self.cfg.scope),
                "groups": sched_mod.schedule_records(self.groups)}


def _state_leaves(state: PyTree) -> Dict[str, torch.Tensor]:
    """{key string: tensor} of the state whose storage a step must keep:
    params, moments, the step counter, rings and Grams. The controller's
    (n_groups,) vectors are left out: the gated jump runs eagerly and
    rebinds them, and no captured graph holds their addresses."""
    return {k: t for k, t in keystr_leaves(state)
            if isinstance(t, torch.Tensor) and not k.startswith(
                ".controller")}


def _storage(leaves: Dict[str, torch.Tensor]) -> Dict[str, int]:
    return {k: t.untyped_storage().data_ptr() for k, t in leaves.items()}


def record_target(name: str, fn: Callable, args, kwargs, state_in: PyTree,
                  state_of: Callable, donated: bool = True
                  ) -> Tuple[AuditTarget, Any]:
    """Record ``fn(*args, **kwargs)`` as the target `name`. `state_in` is
    the state the call must update in place; ``state_of(output)`` picks
    the state it returned. Returns (the target, the call's output)."""
    from repro_torch.launch.mesh import record_collectives

    leaves = _state_leaves(state_in)
    before = _storage(leaves)
    with record_collectives() as coll:
        out, rec = ops_mod.record(fn, *args, **kwargs)
    after = _storage(_state_leaves(state_of(out)))
    bufs = frozenset(ops_mod.shape_str(t) for k, t in leaves.items()
                     if "dmd_buffers" in k)
    grams = frozenset(ops_mod.shape_str(t) for k, t in leaves.items()
                      if "dmd_gram" in k)
    n_dmd = sum(1 for k in leaves if "dmd_buffers" in k or "dmd_gram" in k)
    return AuditTarget(
        name=name, ops=tuple(rec.ops), launches=rec.launches,
        donated=donated, storage_before=before, storage_after=after,
        n_state_leaves=len(leaves), n_dmd_leaves=n_dmd,
        buffer_shapes=bufs, gram_shapes=grams,
        collectives=tuple(coll)), out


def serve_target(name: str, decode: Callable, params, dstate: dict
                 ) -> Tuple[AuditTarget, dict]:
    """AuditTarget of one serving decode step (``ServeEngine._decode``):
    the slot table's caches are the state, every cache leaf must keep its
    storage and no op may make a new tensor of a cache's shape (the
    reference pins the same on its compiled decode). Returns (the target,
    the new decode state)."""
    target, out = record_target(
        name, decode, (params, dstate), {}, {"caches": dstate["caches"]},
        lambda d: {"caches": d["caches"]})
    leaves = _state_leaves({"caches": dstate["caches"]})
    shapes = frozenset(ops_mod.shape_str(t) for t in leaves.values()
                       if t.is_floating_point())
    return dataclasses.replace(target, n_dmd_leaves=len(leaves),
                               buffer_shapes=shapes), out


def adhoc_context(arch: str, acfg, targets: Dict[str, AuditTarget], *,
                  plans=None, arena=None, groups=(), state=None,
                  reduced: bool = False, device: str = "cpu", mesh=None
                  ) -> AuditContext:
    """A partial AuditContext over caller-built targets: the tests and
    ``chip_smoke.py`` run single passes over it. ``arch`` doubles as the
    pin key (``AuditContext.config_key``)."""
    return AuditContext(
        arch=arch, reduced=reduced, mutate=None,
        acfg=acfg, acc=None, plans=plans, arena=dict(arena or {}),
        groups=tuple(groups), state=state, targets=dict(targets),
        device=device, mesh=mesh)


def _build_model_and_config(arch: str, reduced_flag: bool, device):
    """(model, acfg, example batch) for one audit build: the reference's
    builds, the batch drawn from a generator seeded with 0."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import (DMDConfig, OptimizerConfig,
                                          TrainConfig)

    gen = torch.Generator().manual_seed(0)
    acfg = get_config(arch)
    if acfg.model.family == "mlp":
        from repro_torch.configs.pollutant_mlp import PAPER_SIZES
        from repro_torch.models.mlp_net import MLPModel
        sizes = REDUCED_MLP_SIZES if reduced_flag else PAPER_SIZES
        batch = {"x": torch.randn((MLP_BATCH_ROWS, sizes[0]), generator=gen),
                 "y": torch.randn((MLP_BATCH_ROWS, sizes[-1]),
                                  generator=gen)}
        return MLPModel(sizes), acfg, _on(batch, device)

    from repro_torch.models.transformer import LanguageModel
    if reduced_flag:
        mc = reduced(acfg.model, **REDUCED_OVERRIDES)
        acfg = dataclasses.replace(
            acfg, model=mc,
            dmd=DMDConfig(enabled=True, m=4, s=10, tol=1e-4,
                          warmup_steps=4, cooldown_steps=2,
                          arena=acfg.dmd.arena),
            optimizer=OptimizerConfig(name="adam", lr=3e-3,
                                      schedule="constant"),
            parallel=dataclasses.replace(acfg.parallel, grad_accum=1,
                                         remat="none"),
            train=TrainConfig(global_batch=REDUCED_BATCH,
                              seq_len=REDUCED_SEQ))
    mc = acfg.model
    # the reference's target: kv-SP when reduced, its rule otherwise, and
    # LanguageModel's default remat ("none")
    model = LanguageModel(mc, head_tp=False if reduced_flag else None,
                          chunk_k=min(16 if reduced_flag else 1024,
                                      acfg.train.seq_len), device=device)
    b, s = acfg.train.global_batch, acfg.train.seq_len
    toks = torch.randint(1, mc.vocab_size, (b, s + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mc.mrope_sections:
        batch["positions"] = torch.arange(s).expand(b, 3, s)
    return model, acfg, _on(batch, device)


def _on(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def _init_state(model, acfg, acc, device):
    """A fresh TrainState (params from a generator seeded with 0: the
    MLP draws on the host, an LM on `device`), in the layout
    ``Trainer.fit`` runs with (resident where the config says); under the
    accelerator's mesh, this rank's blocks."""
    from repro_torch.core.paths import map_with_paths
    from repro_torch.models.mlp_net import MLPModel
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import state_resident

    on = "cpu" if isinstance(model, MLPModel) else device
    params = model.init(torch.Generator(device=on).manual_seed(0))
    params = map_with_paths(lambda _, x: x.to(device), params)
    if acc.mesh is not None:
        from repro_torch.distributed.sharding import shard_tree
        acc.plans_for(params)                 # the table, from full shapes
        params = shard_tree(params, acc.param_specs, acc.mesh)
    opt = make_optimizer(acfg.optimizer)
    bufs = acc.init(params) if acfg.dmd.enabled else None
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device),
                       bufs, acc.init_grams(bufs), acc.init_controller())
    return state_resident(acc, acfg, state)


def audit_slots(acc) -> np.ndarray:
    """The slot vector of the first step from AUDIT_STEP on at which every
    schedule group records."""
    horizon = AUDIT_STEP + sum(g.warmup_steps + g.phase + g.cycle
                               for g in acc.groups)
    for step in range(AUDIT_STEP, horizon + 1):
        slots = acc.slots(step)
        if (slots >= 0).all():
            return slots
    raise ValueError("no step at which every schedule group records")


def _fill_window(fns, acc, state, batch):
    """Train through one window, each step recording into the next slot
    of every group, so the jumps solve on a real trajectory."""
    m = max(g.m for g in acc.groups)
    for j in range(m):
        slots = np.asarray([j % g.m for g in acc.groups], np.int64)
        state, _ = fns["train_step"](state, batch, slots)
    return state


def _record_steps(ctx, fns, acc, state, batch, donated, gated: bool):
    """Warm up and record the build's entry points into ``ctx.targets``;
    returns the state they left."""
    slots = audit_slots(acc)
    relax = np.ones((acc.n_groups,), np.float32)
    state = _fill_window(fns, acc, state, batch)

    def rec(name, fn, args, kwargs, state_in, state_of):
        fn(*args, **kwargs)                               # warm-up
        target, out = record_target(name, fn, args, kwargs, state_in,
                                    state_of, donated)
        ctx.targets[name] = target
        return out

    if gated:
        state, _ = rec("dmd_step_gated", fns["dmd_step"],
                       (state, relax, batch), {"groups": None}, state,
                       lambda o: o[0])
        return state
    state, _ = rec("train_step", fns["train_step"], (state, batch, slots),
                   {}, state, lambda o: o[0])
    state, _ = rec("dmd_step", fns["dmd_step"], (state, relax),
                   {"groups": None}, state, lambda o: o[0])
    if state.dmd_buffers is not None:
        bufs, grams = rec(
            "record_update", fns["record_update"],
            (state.dmd_buffers, state.dmd_gram, state.params, slots), {},
            {"dmd_buffers": state.dmd_buffers, "dmd_gram": state.dmd_gram},
            lambda o: {"dmd_buffers": o[0], "dmd_gram": o[1]})
        state = state._replace(dmd_buffers=bufs, dmd_gram=grams)
    return state


def build_context(arch: str, *, reduced: bool = False,
                  mesh_shape: Optional[Tuple[int, ...]] = None,
                  mutate: Optional[str] = None, serve: bool = False,
                  device="cuda") -> AuditContext:
    """Build, run and record every audit target and static table of one
    config on `device`.

    ``serve=True`` (CLI ``--serve``) also drives a serving engine through
    a warm-up and a steady wave and attaches its registry counts
    (``ctx.serve``) and its recorded decode (the ``serve_decode``
    target) for the serve-compile pass. ``mesh_shape`` audits the sharded
    build on this rank of a process group of as many ranks."""
    from repro_torch.kernels.device import resolve_device

    dev = resolve_device(device)
    mesh = None
    if mesh_shape:
        from repro_torch.launch.mesh import Mesh
        mesh = Mesh(mesh_shape, device=dev)
    model, acfg, batch = _build_model_and_config(arch, reduced, dev)
    return context_for(arch, model, acfg, batch, reduced=reduced,
                       mutate=mutate, serve=serve, device=dev, mesh=mesh)


def context_for(arch: str, model, acfg, batch, *, reduced: bool = False,
                mutate: Optional[str] = None, serve: bool = False,
                device="cuda", mesh=None) -> AuditContext:
    """``build_context`` for a caller-built model, config and batch on
    `device` (a bespoke model's audit); `arch` is the pin key. Under
    `mesh` the state is this rank's blocks and `batch` the global
    batch."""
    from repro_torch.audit import mutations as mut_mod
    from repro_torch.configs.base import DMDControllerConfig
    from repro_torch.train.step import audit_step_fns

    dev = torch.device(device)
    mutation = mut_mod.get(mutate) if mutate else None
    if mutation is not None and mutation.config is not None:
        acfg = mutation.config(acfg)
    donate = mutation.donate if mutation is not None else True
    step_kw = dict(mutation.step_kw or {}) if mutation is not None else {}

    if mutation is not None and mutation.needs_mesh and mesh is None:
        raise ValueError(f"{mutate} needs --mesh (a sharded build): on one "
                         "device there is nothing to gather")
    acc, fns = audit_step_fns(model, acfg, donate=donate, device=dev,
                              mesh=mesh, **step_kw)
    if mutation is not None and mutation.wrap_fns is not None:
        fns = mutation.wrap_fns(acc, fns)
    state = _init_state(model, acfg, acc, dev)
    plans = acc.plans_for(state.params)
    arena = acc.arena_for(state.params)
    ctx = AuditContext(
        arch=arch, reduced=reduced, mutate=mutate,
        acfg=acfg, acc=acc, plans=plans, arena=dict(arena),
        groups=acc.groups, state=state, device=dev.type, mesh=mesh)
    ctx.state = _record_steps(ctx, fns, acc, state, batch, donate, False)

    # the gated (controller) variant: a controller-enabled clone
    gated_acfg = dataclasses.replace(
        acfg, dmd=dataclasses.replace(
            acfg.dmd, controller=DMDControllerConfig(enabled=True,
                                                     eval_rows=4)))
    gacc, gfns = audit_step_fns(model, gated_acfg, donate=donate,
                                device=dev, mesh=mesh, **step_kw)
    if mutation is not None and mutation.wrap_fns is not None:
        gfns = mutation.wrap_fns(gacc, gfns)
    gstate = _init_state(model, gated_acfg, gacc, dev)
    _record_steps(ctx, gfns, gacc, gstate, batch, donate, True)

    if serve or (mutation is not None and mutation.serve):
        from repro_torch.serve.audit import attach_serve
        attach_serve(ctx, mutate=(mutation.serve_cfg
                                  if mutation is not None else None))
    if mutation is not None and mutation.post is not None:
        mutation.post(ctx)
    return ctx
