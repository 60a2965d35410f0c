"""The train step and the DMD jump step, over a TrainState updated in place.

``train_step(state, batch, slots)`` (``make_train_step``):

  * gradient of the model's loss (microbatch accumulation in fp32 when
    ``grad_accum > 1``), the optimizer update (in place, chunk by chunk,
    for the elementwise optimizers: ``Optimizer.update_``),
  * the DMD record fused in: with the per-group slot vector ``slots``
    (``acc.slots(step)``; a group whose entry is negative does not record)
    each recording bucket copies its params into the ring slot and, with
    the streaming Gram, refreshes that slot's Gram row and column (K1 per
    bucket, K4 per leaf on ``arena=False``),
  * the step counter advances.

Every tensor of the state is written IN PLACE (``copy_`` of the new value,
computed out of place with the reference's arithmetic), so the addresses
never change. That is what lets ``Trainer.fit`` capture a step as one CUDA
graph and replay it: the counterpart of the reference's jitted, donated
step. The slot vector is a host value that selects the graph (one graph
per distinct slot vector: the plain step and one per record slot); the
step counter, the lr and the bias corrections are device tensors inside
the graph. Nothing in a step reads a value back to the host.

``dmd_step`` (``make_dmd_step``) is the jump, masked to the schedule
groups whose window closed; it runs eagerly. Without the controller it is
the paper's jump plus the optimizer-moment reset. With the controller it
is the loss-gated jump: one candidate at the controller's adapted
horizon, then the gate on the held-out batch, a shrinkage line search over
``shrink_levels`` and the bit-exact rollback (DESIGN.md §5). The
reference decides its gate with ``lax.cond``s on device values; here every
candidate loss (the full jump and each rung of the ladder) is computed
first and the accept flags are read back in ONE host read per jump step,
then the first accepted candidate is written into the state. A rejected
jump never touches the state, so the rollback is exact by construction.
With ``meta_lr > 0`` the candidate is computed with autograd on (its
relax scale and ridge as leaves), and one backward from its gate loss
gives the knob gradients: the combine's backward is K1 (arena) or K4 (per
leaf).

Arena-native residency (``dmd.arena_native``): ``Trainer.fit`` converts
the state with ``state_resident`` on entry and ``state_unresident`` on
exit. Resident params are the wrapper ``{"__arena__": {bucket: (N,)
flat}, "leaf": ...}``; the model sees per-leaf views of the flat buffers
(``arena.tree_leafwise``), the optimizer updates the flat buffers, and
``record`` is one copy per bucket. Only optimizers whose moment updates
are elementwise can be resident (``RESIDENT_OPTIMIZERS``).

Under a mesh (``make_train_step(..., mesh=)``, ``launch/mesh.py``) each
rank holds its block of every param, moment, ring buffer and Gram (the
state of record), laid out by the path rules and the plan table. The
step's batch is the global one; each rank takes its rows
(``launch/inputs.py::shard_batch``: split over ``("pod", "data")``, or
replicated where those axes do not divide it). The forward all-gathers
each param over the axes other than ``"model"`` through ``_GatherParam``
(FSDP over ``"data"``), whose backward sums the gradient over the batch
axes with one all-reduce, divides by their size and keeps the rank's
block. Over ``"model"`` the compute is tensor-parallel: the model runs
under the mesh (``sharding.mesh_context``) on each param's ``"model"``
block (heads, ffn columns, vocabulary rows, experts, SSM heads; the
models' collectives are ``distributed/tensor_parallel.py``'s), so no
param block crosses ``"model"``; a replicated param that a rank reads on
its own part of the work gets its gradient summed over ``"model"`` inside
the model. ``tp_compute=False`` gathers every param to full instead and
runs the model as on one device (the audit's ``force-gather-model``
mutation). The loss and the
gate's losses are the batch axes' means, so every rank takes the same
host decisions; the clip's global norm sums each leaf's squares over the
axes that shard it (``sharding.sum_squares``). With
``parallel.grad_compression = "int8"`` and a ``"pod"`` axis the reduced
gradient then crosses the pods as int8 (``distributed/gradsync.py``).
Only the elementwise optimizers run under a mesh.

``audit_step_fns`` hands the same three entry points (the fused step, the
jump, and record + streaming Gram alone) to the audit
(``repro_torch.audit``), which records each call op by op and checks that
the state keeps its storage across it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import arena as arena_mod
from repro_torch.core import controller as ctrl_mod
from repro_torch.core.accelerator import DMDAccelerator, jump_tree
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.gradsync import int8_psum_grads
from repro_torch.core.paths import (by_path, leaves_with_paths,
                                    map_with_paths, tree_map)
from repro_torch.distributed.sharding import (gather_full, local_shard,
                                              mesh_context, spec_axes,
                                              sum_squares, without_axis)
from repro_torch.launch.inputs import batch_axes, shard_batch
from repro_torch.optim.optimizers import global_norm, init_, make_optimizer
from repro_torch.train.state import TrainState

PyTree = Any

# Optimizers whose update is elementwise over each moment entry: the only
# ones whose moments can live in a flat arena buffer unchanged. adafactor
# (factored trailing dims) and adam8bit (256-block quantization) read
# shape structure that flattening destroys.
RESIDENT_OPTIMIZERS = ("sgd", "momentum", "adam", "adamw")

# the most elements one ``torch.vdot`` takes (BLAS's int32 length)
VDOT_ELEMS = 2 ** 31 - 1


def resolve_grad_accum(acfg, mesh, global_batch: int) -> int:
    """Largest accumulation factor <= the config's that keeps >= 1 row per
    batch shard of each microbatch."""
    ga = max(acfg.parallel.grad_accum, 1)
    shards = 1
    if mesh is not None:
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        shards = sizes.get("data", 1) * sizes.get("pod", 1)
    while ga > 1 and (global_batch // ga) % shards != 0:
        ga //= 2
    return max(min(ga, global_batch // shards), 1)


# ---------------------------------------------------------------------------
# Under a mesh
# ---------------------------------------------------------------------------

class _GatherParam(torch.autograd.Function):
    """A rank's block of a param -> the param the forward reads: gathered
    over the dims `spec` shards (one all-gather per sharded dim, recorded
    as ``param:<path>``). Backward: the gradient summed over the batch
    axes the rows were split over (one all-reduce, in the gradient's
    dtype, as the reference's psum of a bf16 param's gradient is bf16),
    divided by their size, and cut to the rank's block."""

    @staticmethod
    def forward(ctx, local, spec, mesh, reduce_axes, n, path):
        ctx.spec, ctx.mesh, ctx.reduce_axes, ctx.n = spec, mesh, reduce_axes, n
        return gather_full(local, spec, mesh, what=f"param:{path}")

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if ctx.reduce_axes:
            ctx.mesh.all_reduce(g, ctx.reduce_axes)
            g = g / ctx.n
        return (local_shard(g, ctx.spec, ctx.mesh), None, None, None, None,
                None)


def _gathered(params: PyTree, specs, mesh, split: bool,
              tp_compute: bool = True) -> PyTree:
    """The params the model's forward reads, from a rank's blocks: each
    gathered over its axes other than "model" (every axis without
    `tp_compute`); `split` (the batch rows were split) makes the backward
    reduce over the batch axes."""
    axes = batch_axes(mesh) if split else ()
    n = mesh.axis_size(axes)

    def one(path, x):
        spec = specs[path]
        if tp_compute:
            spec = without_axis(spec, "model")
        if not spec_axes(spec) and not mesh.live_axes(axes):
            return x
        return _GatherParam.apply(x, spec, mesh, axes, n, path)
    return map_with_paths(one, params)


def _mean_over(x: torch.Tensor, mesh, split: bool) -> torch.Tensor:
    """A rank's mean over its rows -> the mean over the batch (the batch
    axes' mean of equal-sized shards)."""
    if not split:
        return x
    axes = batch_axes(mesh)
    t = x.detach().float().reshape(1).clone()
    mesh.all_reduce(t, axes)
    return (t / mesh.axis_size(axes)).reshape(())


def shard_axes_of(acc: DMDAccelerator, params: PyTree) -> Callable:
    """path -> the mesh axes that shard that leaf of a params-shaped tree
    (a resident wrapper's flat bucket: its bucket's axes)."""
    specs = acc.param_specs
    table = acc.arena_for(params) if arena_mod.is_arena_state(params) \
        else {}
    buckets = {p: table[k].sys_axes + table[k].lane_axes
               for p, k in leaves_with_paths(
                   {arena_mod.ARENA_KEY: {k: k for k in table}})}

    def axes_of(path: str):
        if path in buckets:
            return buckets[path]
        if arena_mod.is_arena_state(params):
            path = path[len("/leaf"):]
        return spec_axes(specs[path])
    return axes_of


def resident_enabled(acc: DMDAccelerator, acfg) -> bool:
    """Residency gate: arenas on, ``dmd.arena_native`` on, and an
    elementwise-moment optimizer."""
    return (acc.arena_on and bool(acc.cfg.arena_native)
            and acfg.optimizer.name in RESIDENT_OPTIMIZERS)


def _params_shaped(field, param_paths) -> bool:
    return isinstance(field, dict) and set(by_path(field)) == param_paths


def state_resident(acc: DMDAccelerator, acfg, state):
    """Per-leaf TrainState -> the resident layout (params and params-shaped
    moment fields packed into the bucket buffers). No-op when residency is
    off, nothing is packed, or the state is already resident. Trainer.fit
    entry only."""
    if state is None or not resident_enabled(acc, acfg) \
            or arena_mod.is_arena_state(state.params):
        return state
    table = acc.arena_for(state.params)
    if not table:
        return state
    paths = set(by_path(state.params))

    def to_res(field):
        if _params_shaped(field, paths):
            return arena_mod.tree_resident(table, field)
        return field

    opt_state = state.opt_state
    if _params_shaped(opt_state, paths):                   # momentum
        opt_state = arena_mod.tree_resident(table, opt_state)
    elif isinstance(opt_state, tuple) and opt_state:       # NamedTuple
        opt_state = type(opt_state)(*(to_res(f) for f in opt_state))
    return state._replace(params=arena_mod.tree_resident(table, state.params),
                          opt_state=opt_state)


def state_unresident(acc: DMDAccelerator, state):
    """Inverse of ``state_resident``: resident params and moments back to
    per-leaf tensors (views of the flat buffers). Snapshot buffers and
    Grams keep their packed layout."""
    if state is None or not arena_mod.is_arena_state(state.params):
        return state
    table = acc.arena_for(state.params)
    return state._replace(
        params=arena_mod.tree_leafwise(table, state.params),
        opt_state=arena_mod.unwrap_resident(table, state.opt_state))


def assign_(dst: PyTree, src: PyTree) -> None:
    """Write every leaf of `src` into the same path of `dst`, in place (the
    addresses a captured graph holds stay valid). Leaves that are the same
    tensor are skipped."""
    src_of = by_path(src)
    for path, d in leaves_with_paths(dst):
        s = src_of[path]
        if s is not d:
            d.copy_(s.detach())


def model_stack_dims(model) -> Optional[dict]:
    """The model's ``param_stack_dims()`` (the reference's form: a tree of
    ints mirroring its params, or None) by normalised path, as
    ``DMDAccelerator`` takes it; None for a model without stacked
    leaves."""
    sd = model.param_stack_dims() if hasattr(model, "param_stack_dims") \
        else None
    return None if sd is None else by_path(sd)


def _accelerator_for(model, acfg, acc: Optional[DMDAccelerator], device,
                     mesh=None) -> DMDAccelerator:
    if acc is not None:
        if mesh is not None and acc.mesh is not mesh:
            raise ValueError("the accelerator's mesh is not the step's")
        return acc
    return DMDAccelerator(acfg.dmd, stack_dims=model_stack_dims(model),
                          device=device, mesh=mesh)


def _loss_of(model, loss_fn):
    if loss_fn is not None:
        return loss_fn
    if model is None:
        raise ValueError("need `model` or `loss_fn`")
    return lambda p, b: model.loss(p, b)[0]


def value_and_grad(loss, params: PyTree, batch: PyTree):
    """(loss, grads) of ``loss(params, batch)``; the grads share the params'
    tree (a resident wrapper gets flat gradients, zero at pad lanes)."""
    leaves = leaves_with_paths(params)
    req = [x.detach().requires_grad_(True) for _, x in leaves]
    by = {path: t for (path, _), t in zip(leaves, req)}
    p = map_with_paths(lambda path, _: by[path], params)
    with torch.enable_grad():
        value = loss(p, batch)
    grads = torch.autograd.grad(value, req, allow_unused=True)
    g_of = {path: (torch.zeros_like(t) if g is None else g)
            for (path, _), t, g in zip(leaves, req, grads)}
    return value.detach(), map_with_paths(lambda path, _: g_of[path],
                                          params)


def _check_mesh_optimizer(acfg, mesh) -> None:
    if mesh is not None and acfg.optimizer.name not in RESIDENT_OPTIMIZERS:
        raise NotImplementedError(
            f"{acfg.optimizer.name} under a mesh: its moments read a leaf's "
            "shape across ranks' blocks; only the elementwise optimizers "
            f"{RESIDENT_OPTIMIZERS} run under a mesh")


def _mesh_loss(loss, acc: DMDAccelerator, mesh, split: bool,
               tp_compute: bool = True) -> Callable:
    """`loss` on a rank's blocks (resident views keep their per-leaf
    paths): the params gathered over the axes other than "model" and the
    model run under the mesh, tensor-parallel over "model"; without
    `tp_compute` gathered to full and run as on one device."""
    axes = batch_axes(mesh) if split else ()

    def run(p, b):
        full = _gathered(p, acc.param_specs, mesh, split, tp_compute)
        with mesh_context(mesh if tp_compute else None), \
                tpm.batch_split(mesh, axes):
            return loss(full, b)
    return run


def make_train_step(model, acfg, *, global_batch=None,
                    loss_fn: Callable = None,
                    acc: Optional[DMDAccelerator] = None, device="cuda",
                    mesh=None, tp_compute: bool = True):
    """Returns ``train_step(state, batch, slots=None) -> (state, metrics)``.

    `slots` is the per-group slot vector of this step (``acc.slots(step)``,
    a host value); None or all-negative records nothing. The state is
    updated in place and returned; metrics are device tensors. Under
    `mesh` (default: the accelerator's) the state holds this rank's blocks
    and `batch` is the global batch; the model computes tensor-parallel
    over "model" (``tp_compute=False``: on params gathered to full)."""
    acc = _accelerator_for(model, acfg, acc, device, mesh)
    mesh = acc.mesh
    _check_mesh_optimizer(acfg, mesh)
    norm_state = {}

    def norm_fn(tree):
        if mesh is None:
            return global_norm(tree)
        return torch.sqrt(sum_squares(tree, norm_state["axes_of"], mesh))

    opt = make_optimizer(acfg.optimizer, norm_fn)
    gb = global_batch or acfg.train.global_batch
    ga = resolve_grad_accum(acfg, mesh, gb)
    dmd_on = acfg.dmd.enabled
    _loss = _loss_of(model, loss_fn)
    int8_sync = (mesh is not None and "pod" in mesh.axis_names
                 and acfg.parallel.grad_compression == "int8")
    # the fp32 gradient sums of grad accumulation, made once per param
    # structure and zeroed in place each step: a params-sized buffer that
    # neither a step's warm-up nor its CUDA graph's pool allocates anew
    # (beside an LM's state on one card, the two would not both fit).
    # ``train_step.release()`` frees them (``Trainer.fit`` does on return)
    sums: Dict[str, torch.Tensor] = {}

    def grad_sums(params: PyTree) -> PyTree:
        leaves = leaves_with_paths(params)
        if sorted(sums) != sorted(path for path, _ in leaves) or any(
                sums[path].shape != p.shape or sums[path].device != p.device
                for path, p in leaves):
            sums.clear()
            sums.update({path: torch.empty(p.shape, dtype=torch.float32,
                                           device=p.device)
                         for path, p in leaves})
        return map_with_paths(lambda path, _: sums[path].zero_(), params)

    def train_step(state: TrainState, batch: PyTree, slots=None) -> tuple:
        params = state.params
        resident = arena_mod.is_arena_state(params)
        table = acc.arena_for(params) if resident else None
        loss_of, split = _loss, False
        if mesh is not None:
            batch, split = shard_batch(batch, mesh)
            loss_of = _mesh_loss(_loss, acc, mesh, split, tp_compute)
            norm_state["axes_of"] = shard_axes_of(acc, params)

        if ga > 1 or resident:
            # the fp32 sum and its mean are formed in place: a + b.float()
            # and g / ga in the same precision, without a second
            # params-sized fp32 tree (the LM's state fills the card). A
            # resident buffer's leaves are differentiated as the leaves
            # themselves (views of the flat buffer, detached) and each
            # gradient added into its view of the flat sum: autograd
            # through the views would build every leaf's gradient into a
            # buffer-sized one, several at once
            grads = grad_sums(params)
            view = arena_mod.tree_leafwise(table, params) if resident \
                else params
            g_of = by_path(arena_mod.tree_leafwise(table, grads)
                           if resident else grads)
            mbs = tree_map(lambda x: x.reshape((ga, x.shape[0] // ga)
                                               + tuple(x.shape[1:])), batch)
            lsum = None
            for i in range(ga):
                mb = tree_map(lambda x: x[i], mbs)
                value, g = value_and_grad(loss_of, view, mb)
                for path, gi in leaves_with_paths(g):
                    g_of[path].add_(gi)
                del g
                lsum = value if lsum is None else lsum + value
            if ga > 1:
                for g in g_of.values():
                    g.div_(ga)
            del g_of, view
            loss = lsum / ga
        else:
            loss, grads = value_and_grad(loss_of, params, batch)
            grads = tree_map(lambda g: g.float(), grads)
        if mesh is not None:
            loss = _mean_over(loss, mesh, split)
        if int8_sync:
            grads = int8_psum_grads(grads, mesh)

        with torch.no_grad():
            gnorm = None
            if mesh is not None:
                gnorm = sum_squares(grads, norm_state["axes_of"], mesh)
            for _, g in leaves_with_paths(grads if mesh is None else {}):
                # BLAS's dot takes at most 2^31 - 1 elements a call (the
                # flat gradient sum of a resident bucket passes it at 2.2B
                # params: gemma3's tied embedding and two layers), so a
                # larger buffer is summed a piece at a time
                for part in g.reshape(-1).split(VDOT_ELEMS):
                    sq = torch.vdot(part, part)
                    gnorm = sq if gnorm is None else gnorm + sq
            gnorm = torch.sqrt(gnorm)
            if opt.update_ is not None:
                # the same arithmetic, in place, a chunk at a time
                opt.update_(grads, state.opt_state, params, state.step)
            else:
                updates, opt_state = opt.update(grads, state.opt_state,
                                                params, state.step)
                u_of = by_path(updates)
                for path, p in leaves_with_paths(params):
                    p.add_(u_of[path].to(p.dtype))
                assign_(state.opt_state, opt_state)
            del grads
            if dmd_on and state.dmd_buffers is not None and slots is not None \
                    and (np.asarray(slots) >= 0).any():
                acc.record(state.dmd_buffers, params, slots,
                           state.dmd_gram if acc.streaming else None)
            state.step.add_(1)
        return state, {"loss": loss, "grad_norm": gnorm}

    train_step.release = sums.clear
    return train_step


def reset_opt_state_after_jump(opt, opt_state, params, plans, groups,
                               n_groups, arena=None):
    """Post-jump optimizer-moment reset (a new state; the caller writes it
    in place).

    `groups` are the group indices whose moments reset (callers filter by
    each group's ``reset_opt``: ``DMDAccelerator.reset_groups``). When that
    covers every group this is a full ``opt.init``. Otherwise only those
    groups' entries are reset in each params-shaped field of the state;
    other fields (scalar counters, empty states) are kept. With resident
    moments the masking unit is the BUCKET (a bucket holds one group's
    leaves), so `arena` (``acc.arena_for(params)``) is required."""
    if groups is None or len(frozenset(groups)) >= n_groups:
        return opt.init(params)
    fresh = opt.init(params)
    gset = frozenset(int(g) for g in groups)
    plan_of = by_path(plans)

    def merge_leaf(old_field, new_field):
        new = by_path(new_field)

        def one(path, old):
            plan = plan_of.get(path)
            return new[path] if plan is not None and plan.group in gset \
                else old
        return map_with_paths(one, old_field)

    if arena_mod.is_arena_state(params):
        if arena is None:
            raise ValueError("resident optimizer state but no bucket table: "
                             "pass arena=acc.arena_for(params)")
        param_paths = None
    else:
        param_paths = set(by_path(params))

    def merge(old_field, new_field):
        if arena_mod.is_arena_state(old_field):
            ares_o, leaf_o = arena_mod.split_state(old_field)
            ares_n, leaf_n = arena_mod.split_state(new_field)
            ares = {k: (ares_n[k] if arena[k].group in gset else v)
                    for k, v in ares_o.items()}
            return arena_mod.make_state(ares, merge_leaf(leaf_o, leaf_n))
        if param_paths is None or not _params_shaped(old_field, param_paths):
            return old_field
        return merge_leaf(old_field, new_field)

    if isinstance(opt_state, dict):                # momentum-style state
        return merge(opt_state, fresh)
    if isinstance(opt_state, tuple):               # NamedTuple of fields
        return type(opt_state)(*(merge(o, n)
                                 for o, n in zip(opt_state, fresh)))
    return opt_state


def _blend(pre: PyTree, jump: PyTree, f: float) -> PyTree:
    """``(1 - f) * pre + f * jump`` per leaf in fp32, cast back: the
    f-scaled-relax jump (relax enters the coefficients linearly)."""
    return tree_map(lambda a, b: ((1.0 - f) * a.float() + f * b.float())
                    .to(a.dtype), pre, jump)


def make_dmd_step(acfg, *, acc: Optional[DMDAccelerator] = None, model=None,
                  loss_fn: Callable = None, device="cuda", mesh=None,
                  tp_compute: bool = True):
    """Returns the jump step. Controller off:
    ``dmd_step(state, relax, groups=None) -> (state, info)``. Controller on:
    ``dmd_step(state, relax, eval_batch, groups=None) -> (state, info)``,
    the loss-gated jump scored on `eval_batch` (a validation batch disjoint
    from the training stream). `groups` are the schedule groups whose
    window closed (None: all); `relax` is a scalar or the per-group vector
    of ``acc.relax_vector``. Params and moments are written in place.
    Under a mesh the gate's losses are the batch axes' means and its accept
    flags are broadcast from the mesh's first rank, so every rank keeps
    the same candidate."""
    cfg = acfg.dmd
    opt = make_optimizer(acfg.optimizer)
    acc = _accelerator_for(model, acfg, acc, device, mesh)
    mesh = acc.mesh

    def grams_of(state):
        return state.dmd_gram if acc.streaming else None

    def gset_of(groups):
        return None if groups is None else frozenset(int(g) for g in groups)

    def reset_moments(state, groups):
        """The jumped groups' moments reset (unless a group opts out:
        ``reset_opt``), written in place."""
        reset = acc.reset_groups(groups)
        if reset:
            params = state.params
            if len(frozenset(reset)) >= acc.n_groups and \
                    opt.update_ is not None:
                # every group: opt.init written in place, chunk by chunk
                init_(opt, state.opt_state, params)
                return
            assign_(state.opt_state, reset_opt_state_after_jump(
                opt, state.opt_state, params, acc.plans_for(params), reset,
                acc.n_groups, arena=acc.arena_for(params)))

    if not acc.controller_on:
        @torch.no_grad()
        def dmd_step(state: TrainState, relax,
                     groups: Optional[Sequence[int]] = None) -> tuple:
            if state.dmd_buffers is None:
                return state, {"mean_rank": torch.zeros(())}
            new_params, mean_rank = jump_tree(
                cfg, acc.plans_for(state.params), state.params,
                state.dmd_buffers, grams_of(state), relax,
                groups=gset_of(groups), arena=acc.arena_for(state.params))
            assign_(state.params, new_params)
            reset_moments(state, groups)
            return state, {"mean_rank": mean_rank}

        return dmd_step

    # ---- the loss-gated controller variant --------------------------------
    ccfg = cfg.controller
    _loss = _loss_of(model, loss_fn)
    levels = tuple(float(f) for f in (ccfg.shrink_levels or (0.5,)))
    for f in levels:
        if not 0.0 < f < 1.0:
            raise ValueError(f"controller shrink_levels must lie in (0, 1): "
                             f"got {levels}")
    # meta-tuning differentiates through the jump: the host eig of eig
    # mode has no derivative
    meta_on = float(ccfg.meta_lr) > 0
    if meta_on and cfg.mode != "matpow":
        raise ValueError("controller meta-tuning (meta_lr > 0) needs "
                         "dmd.mode='matpow': the eig host step is not "
                         "differentiable")

    def gated_dmd_step(state: TrainState, relax, eval_batch,
                       groups: Optional[Sequence[int]] = None) -> tuple:
        dev = acc.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if state.dmd_buffers is None:
            return state, {"mean_rank": zero, "ctrl_outcome": ctrl_mod.REJECT,
                           "ctrl_loss_pre": zero, "ctrl_loss_jump": zero,
                           "ctrl_loss_kept": zero, "ctrl_gain": zero,
                           "ctrl_level": zero}
        n = acc.n_groups
        ctrl = state.controller
        jumped = tuple(range(n)) if groups is None else tuple(groups)
        params = state.params
        resident = arena_mod.is_arena_state(params)
        table = acc.arena_for(params)

        def eval_loss(p):
            if resident:
                p = arena_mod.tree_leafwise(table, p)
            if mesh is None:
                return _loss(p, eval_batch)
            rows, split = shard_batch(eval_batch, mesh)
            local = _mesh_loss(_loss, acc, mesh, split, tp_compute)(p,
                                                                    rows)
            if not split:
                return local
            # the batch axes' mean, bit for bit, carrying this rank's
            # gradient (meta-tuning): ``_GatherParam``'s backward makes it
            # the mean's
            return _mean_over(local, mesh, split) + (local - local.detach())

        s_vec = ctrl_mod.effective_s(ctrl, acc.groups, ccfg)
        relax_vec = torch.as_tensor(relax, dtype=torch.float32,
                                    device=dev).expand(n) * ctrl.relax_eff
        ridge_vec = ctrl.ridge_eff if meta_on else None
        if meta_on:
            # the knobs as autograd leaves: the candidate IS the reference's
            # meta_loss point (relax scale 1, ridge = ridge_eff)
            rscale = torch.ones((n,), dtype=torch.float32, device=dev,
                                requires_grad=True)
            ridge_vec = ctrl.ridge_eff.detach().clone().requires_grad_(True)
            relax_in = relax_vec * rscale
        else:
            relax_in = relax_vec
        with torch.set_grad_enabled(meta_on):
            p_jump, mean_rank = jump_tree(
                cfg, acc.plans_for(params), params, state.dmd_buffers,
                grams_of(state), relax_in, groups=gset_of(groups),
                arena=table, s_vec=s_vec, ridge_vec=ridge_vec)
            loss_post = eval_loss(p_jump)
        g_relax = g_ridge = None
        if meta_on:
            if loss_post.requires_grad:
                g_relax, g_ridge = torch.autograd.grad(
                    loss_post, (rscale, ridge_vec), allow_unused=True)
            g_relax = torch.zeros((n,), device=dev) if g_relax is None \
                else g_relax
            g_ridge = torch.zeros((n,), device=dev) if g_ridge is None \
                else g_ridge
            p_jump = tree_map(lambda x: x.detach(), p_jump)
            loss_post = loss_post.detach()
            mean_rank = mean_rank.detach()

        with torch.no_grad():
            loss_pre = eval_loss(params)
            rungs = [_blend(params, p_jump, f) for f in levels]
            cand = [loss_post] + [eval_loss(p) for p in rungs]
            ok = torch.stack([ctrl_mod.gate_outcome(loss_pre, c,
                                                    ccfg.accept_tol)
                              for c in cand])
            if mesh is not None:
                ok = mesh.broadcast(ok.to(torch.int32))
            # the one host read of this jump step: every accept flag
            flags = ok.tolist()  # lint: allow-host-sync (once per jump)
            if flags[0]:
                outcome, kept, loss_kept, level = (ctrl_mod.ACCEPT, p_jump,
                                                   loss_post, levels[0])
            elif any(flags[1:]):
                i = flags[1:].index(True)
                outcome, kept, loss_kept, level = (ctrl_mod.SCALED, rungs[i],
                                                   cand[1 + i], levels[i])
            else:
                # bit-exact rollback: the state was never written
                outcome, kept, loss_kept, level = (ctrl_mod.REJECT, None,
                                                   loss_pre, levels[0])
            if kept is not None:
                assign_(state.params, kept)
                reset_moments(state, groups)
            gain = (loss_pre - loss_kept) / torch.clamp_min(loss_pre, 1e-30)
            new_ctrl = ctrl_mod.update_on_jump(ctrl, jumped, outcome, gain,
                                               ccfg, acc.groups, level=level)
            if meta_on:
                new_ctrl = ctrl_mod.meta_update(new_ctrl, jumped, g_relax,
                                                g_ridge, ccfg, acc.groups)
        return state._replace(controller=new_ctrl), {
            "mean_rank": mean_rank, "ctrl_outcome": outcome,
            "ctrl_loss_pre": loss_pre, "ctrl_loss_jump": loss_post,
            "ctrl_loss_kept": loss_kept, "ctrl_gain": gain,
            "ctrl_level": torch.tensor(level, dtype=torch.float32)}

    return gated_dmd_step


def _rebinding(fn: Callable, n_state: int) -> Callable:
    """`fn` run on a fresh copy of its first `n_state` arguments, the copy
    returned: the state is rebound to new tensors instead of written in
    place (the eager form of a jit without donate_argnums)."""
    def step(*args, **kwargs):
        fresh = tuple(tree_map(lambda t: t.clone(), a)
                      for a in args[:n_state])
        return fn(*fresh, *args[n_state:], **kwargs)
    return step


def audit_step_fns(model, acfg, *, acc: Optional[DMDAccelerator] = None,
                   loss_fn: Callable = None, donate: bool = True,
                   device="cuda", mesh=None, tp_compute: bool = True):
    """The audit's surface (``repro_torch.audit.targets``): every hot entry
    point, built as the Trainer builds it, and their shared accelerator.

    Returns ``(acc, {name: fn})`` with
      * ``train_step``: the fused step (record and streaming Gram inside),
        ``train_step(state, batch, slots)``;
      * ``dmd_step``: the jump, plain or loss-gated as the config says;
      * ``record_update``: ``record_update(buffers, grams, params,
        slots)``, record and streaming-Gram maintenance as a step of its
        own, so the data passes are audited apart from the model.

    Each writes its state in place. ``donate=False`` is the seeded
    violation (the audit's ``drop-donation``): each step then rebinds its
    state to fresh tensors instead of writing it in place through
    ``assign_``. Under `mesh` each works on this rank's blocks
    (``tp_compute=False``: the model reads params gathered to full, the
    audit's ``force-gather-model``)."""
    acc = _accelerator_for(model, acfg, acc, device, mesh)
    fns = {
        "train_step": make_train_step(model, acfg, loss_fn=loss_fn, acc=acc,
                                      device=device, tp_compute=tp_compute),
        "dmd_step": make_dmd_step(acfg, acc=acc, model=model,
                                  loss_fn=loss_fn, device=device,
                                  tp_compute=tp_compute),
    }

    def record_update(buffers, grams, params, slots):
        return acc.record(buffers, params, slots, grams)

    fns["record_update"] = record_update
    if not donate:
        fns = {"train_step": _rebinding(fns["train_step"], 1),
               "dmd_step": _rebinding(fns["dmd_step"], 1),
               "record_update": _rebinding(record_update, 2)}
    return acc, fns
