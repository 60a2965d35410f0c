"""Rank-side checks of the mesh against one rank, on any device and at any
size: the DMD data passes per block, the coefficients' broadcast, a run's
full final params, the restored running Grams, the int8 pod sync, the
audit under a mesh, and tensor-parallel compute (a model's loss and each
leaf's gradient block against one rank's, with planted faults).

Every rank of a mesh calls them alike (each makes collectives); they
return tensors and verdicts and assert nothing, so that the caller holds
them to its references and tolerances: ``tests/torch_mesh_worker.py`` on
gloo ranks on the CPU (against the reference's math, in the test
process), and ``chip_smoke.py``'s mesh phase on ranks sharing one card.
"""
from __future__ import annotations

import contextlib
import hashlib
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import DMDConfig
from repro_torch.core import arena as arena_mod
from repro_torch.core.accelerator import DMDAccelerator
from repro_torch.core.paths import by_path, leaves_with_paths
from repro_torch.distributed.gradsync import int8_psum_grads
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.sharding import (Spec, gather_full, local_shard,
                                              param_specs, shard_tree)
from repro_torch.kernels import arena as ka
from repro_torch.kernels import ops
from repro_torch.kernels import sharded as ks
from repro_torch.launch.mesh import record_collectives

# the window of the data-pass checks
M = 4


def nest(flat: Dict[str, Any]) -> dict:
    """{"/a/b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for path, x in flat.items():
        node = out
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()
                        ).hexdigest()


class LeafState:
    """The fields of a TrainState that ``state_leafwise`` reads."""

    def __init__(self, params, bufs, grams):
        self.params, self.dmd_buffers, self.dmd_gram = params, bufs, grams
        self.opt_state = None

    def _replace(self, **kw):
        new = LeafState(self.params, self.dmd_buffers, self.dmd_gram)
        for k, v in kw.items():
            setattr(new, k, v)
        return new


def data_passes(mesh, shapes: Dict[str, tuple], stack_dims: Dict[str, int],
                *, arena: bool, snapshot: Callable[[int], Dict[str, Any]],
                coefficients: Dict[str, torch.Tensor], device,
                block_n: Optional[int] = None, keep_full: bool = True,
                probe: Optional[Callable] = None) -> dict:
    """Record M snapshots (``snapshot(j)``: {path: full tensor}, the same
    on every rank) through the accelerator on `mesh` (K1 / K4 on each
    rank's blocks plus one all-reduce a record) and, on the same rank,
    without a mesh. Returns, by path: the mesh's running Grams gathered
    to full (``streamed``) beside one rank's (``one``), bit-equality of
    the two, K3 / K6's recompute on the blocks plus its all-reduce
    gathered (``recomputed``; per bucket ``k3`` on arenas), K2 / K5 of
    `coefficients` on the blocks against the one-rank combine's block bit
    for bit (``k2_slice_equal``; per bucket ``k2_bucket_equal``, which
    also asks for no collective), and the gathered combine
    (``k2_full``, with `keep_full`); and the collectives of each record.
    ``probe(acc, params, bufs, leaf_state)``, where given, runs on the
    rank's state before it is freed; its result is ``probe``."""
    kw = {} if block_n is None else {"arena_block_n": block_n}
    cfg = DMDConfig(m=M, s=M, tol=1e-4, warmup_steps=0, cooldown_steps=0,
                    arena=arena, param_filter="all", **kw)
    anchor_first = cfg.anchor == "first"
    tree = nest({p: torch.zeros(s, device=device) for p, s in shapes.items()})
    acc = DMDAccelerator(cfg, stack_dims=stack_dims, device=device, mesh=mesh)
    one = DMDAccelerator(cfg, stack_dims=stack_dims, device=device)
    acc.plans_for(tree)
    specs = acc.param_specs
    bufs = acc.init(shard_tree(tree, specs, mesh))
    grams = acc.init_grams(bufs)
    bufs1 = one.init(tree)
    grams1 = one.init_grams(bufs1)
    coll: List[list] = []
    last = None
    for j in range(cfg.m):
        last = nest(snapshot(j))
        with record_collectives() as rec:
            acc.record(bufs, shard_tree(last, specs, mesh), j, grams)
        coll.append([(c["kind"], c["bytes"]) for c in rec])
        one.record(bufs1, last, j, grams1)
    params = shard_tree(last, specs, mesh)
    del last
    plan_of = by_path(acc.plans_for(params))
    table = acc.arena_for(params)
    state = acc.state_leafwise(LeafState(params, bufs, grams))
    state1 = one.state_leafwise(LeafState(tree, bufs1, grams1))
    out = {"streamed": {}, "one": {}, "streamed_equal_one": {},
           "recomputed": {}, "k2_slice_equal": {}, "k2_full": {},
           "record_collectives": coll,
           "buckets": {k: (b.lane_axes, b.sys_axes, b.n_sys, b.n_sys_global)
                       for k, b in table.items()}}
    g_of, b_of = by_path(state.dmd_gram), by_path(state.dmd_buffers)
    g1_of, b1_of = by_path(state1.dmd_gram), by_path(state1.dmd_buffers)
    for path, plan in plan_of.items():
        if plan is None:
            continue
        g = gather_full(g_of[path].contiguous(), plan.gram_spec, mesh)
        out["streamed"][path] = g
        out["one"][path] = g1_of[path]
        out["streamed_equal_one"][path] = bool(torch.equal(g, g1_of[path]))
        buf = b_of[path].contiguous()
        out["recomputed"][path] = gather_full(
            ks.gram(buf, plan, anchor_first=anchor_first).contiguous(),
            plan.gram_spec, mesh)
        c = coefficients[path]
        c_local = local_shard(c, Spec(*plan.stack_spec_entries, None),
                              mesh).contiguous()
        w = ks.combine(buf, c_local, plan)
        w1 = ops.combine(b1_of[path].contiguous(), c,
                         stack_dims=plan.stack_dims)
        out["k2_slice_equal"][path] = bool(torch.equal(
            w, local_shard(w1, plan.param_spec, mesh)))
        if keep_full:
            out["k2_full"][path] = gather_full(w, plan.param_spec, mesh)
        del buf, w, w1
    if arena:
        arenas = arena_mod.split_state(bufs)[0]
        k3 = {key: ka.gram(buf, table[key].tables_on(buf.device),
                           anchor_first=anchor_first, **table[key].shard_kw())
              for key, buf in arenas.items()}
        out["k3"] = {p: gather_full(g.contiguous(), plan_of[p].gram_spec,
                                    mesh)
                     for p, g in arena_mod.grams_leafwise(table, k3).items()}
        out["k2_bucket_equal"] = _bucket_combine_equal(
            acc, one, params, tree, bufs, bufs1, coefficients, mesh)
    if probe is not None:
        out["probe"] = probe(acc, params, bufs, state)
    return out


def _bucket_combine_equal(acc, one, params, tree, bufs, bufs1, c_of,
                          mesh) -> Dict[str, bool]:
    """K2 on each bucket of this rank's blocks (one launch, no
    collective) against the one-rank bucket's K2, unpacked per leaf and
    cut to the rank's blocks: bit for bit per leaf."""
    table = acc.arena_for(params)
    table1 = one.arena_for(tree)
    arenas = arena_mod.split_state(bufs)[0]
    arenas1 = arena_mod.split_state(bufs1)[0]
    want = {}
    for key, b in table1.items():
        c = torch.cat([c_of[s.path].reshape(s.n_sys, b.m)
                       for s in b.segments])
        flat = ka.combine(arenas1[key], c, b.tables_on(c.device))
        for s, x in zip(b.segments, arena_mod._unpack_row(b, flat)):
            want[s.path] = x
    verdicts = {}
    for key, b in table.items():
        rows = []
        for s in b.segments:
            c = c_of[s.path]
            if b.sys_axes:
                c = local_shard(c, Spec(ka._axis_entry(b.sys_axes)), mesh)
            rows.append(c.reshape(s.n_sys, b.m))
        with record_collectives() as rec:
            flat = ka.combine(arenas[key], torch.cat(rows).contiguous(),
                              b.tables_on(arenas[key].device),
                              **b.shard_kw())
        for s, x in zip(b.segments, arena_mod._unpack_row(b, flat)):
            verdicts[s.path] = bool(torch.equal(
                x, local_shard(want[s.path], s.param_spec, mesh))) \
                and not rec
    return verdicts


class CoefficientLog:
    """Digests of every fp32 tensor the mesh broadcasts from its first
    rank (the jump coefficients), before and after the broadcast, while
    open; ``close`` restores the mesh's broadcast."""

    def __init__(self, mesh):
        self.before: List[str] = []
        self.after: List[str] = []
        self._mesh = mesh
        inner = mesh.broadcast

        def broadcast(t, axes=None):
            if t.dtype == torch.float32:
                self.before.append(digest(t))
            out = inner(t, axes)
            if t.dtype == torch.float32:
                self.after.append(digest(out))
            return out
        mesh.broadcast = broadcast

    def close(self) -> None:
        del self._mesh.broadcast


def fit(trainer, batches, steps: int, state=None,
        on_metrics: Optional[Callable] = None) -> tuple:
    """``trainer.fit`` from `state` (a list of batches is entered at the
    state's step): (state, losses, jump steps, gate outcomes)."""
    losses, jumps, outcomes = [], [], []

    def on_m(t, m):
        losses.append(float(m["loss"]))
        if "mean_rank" in m:
            jumps.append(t)
        if "ctrl_outcome" in m:
            outcomes.append(int(m["ctrl_outcome"]))
        if on_metrics is not None:
            on_metrics(t, m)

    start = 0 if state is None else int(state.step)
    it = iter(batches[start:] if isinstance(batches, list) else batches)
    st = trainer.fit(it, steps, state=state, on_metrics=on_m)
    return st, losses, jumps, outcomes


def full_params(trainer, state) -> Dict[str, torch.Tensor]:
    """{path: full param} of a Trainer's state: every rank takes part in
    the gathers under a mesh."""
    params = trainer.acc.params_leafwise(state.params)
    if trainer.mesh is None:
        return dict(leaves_with_paths(params))
    return {p: gather_full(x, trainer.acc.param_specs[p], trainer.mesh)
            for p, x in leaves_with_paths(params)}


def gram_errors(trainer, state) -> Dict[str, float]:
    """Each running Gram of a (restored) state against K3's / K6's
    recompute of its ring, over the rows the current window has written
    (the rows of older windows are rewritten before the next jump):
    relative to the recompute's largest entry."""
    acc = trainer.acc
    leaf = acc.state_leafwise(state)
    plans = by_path(acc.plans_for(leaf.params))
    bufs = by_path(leaf.dmd_buffers)
    step = int(state.step)
    out = {}
    for path, g in leaves_with_paths(leaf.dmd_gram):
        plan = plans[path]
        k = plan.sched.slot(step - 1)
        if k < 0 or plan.sched.should_apply(step - 1):
            continue
        want = ks.gram(bufs[path].contiguous(), plan,
                       anchor_first=acc.cfg.anchor == "first")
        out[path] = rel_err(g[..., :k + 1, :k + 1],
                            want[..., :k + 1, :k + 1])
    return out


def int8_sync(pods, shape: tuple, device) -> dict:
    """``int8_psum_grads`` on a mesh with a "pod" axis: a gradient every
    pod holds alike (``input`` -> ``same``) and one that differs by pod
    (``diff``), with the collectives of the second."""
    gen = torch.Generator(device=device).manual_seed(0)
    g = torch.randn(shape, generator=gen, device=device)
    same = int8_psum_grads({"w": g}, pods)["w"]
    gen_p = torch.Generator(device=device).manual_seed(
        10 + pods.coords["pod"])
    d = torch.randn(shape, generator=gen_p, device=device)
    with record_collectives() as rec:
        diff = int8_psum_grads({"w": d}, pods)["w"]
    return {"input": g, "same": same, "pod_input": d, "diff": diff,
            "wire": [(c["kind"], c["dtype"], c["axes"]) for c in rec]}


def mesh_audit(mesh_shape: tuple, device) -> dict:
    """The audit of the reduced TinyLlama under `mesh_shape`, clean, with
    ``force-allgather`` and with ``force-gather-model``: the failed
    passes, record_update's collectives, the analytic all-reduce bytes,
    train_step's param blocks all-gathered over "model" of each, and the
    collectives of kv-SP's merge the build made (the reduced model
    attends in kv-SP, as the reference's audit target does)."""
    from repro_torch.audit import run_audit

    out = {}
    for mutate in (None, "force-allgather", "force-gather-model"):
        with record_collectives() as rec:
            report = run_audit("tinyllama-1.1b", reduced=True, device=device,
                               mesh_shape=mesh_shape, mutate=mutate)
        info = next(r.info for r in report.results
                    if r.name == "collective-budget")
        out[mutate or "clean"] = {
            "failed": sorted(r.name for r in report.results if not r.ok),
            "record": info.get("record_update.collectives"),
            "analytic": info.get("record_allreduce_bytes_analytic"),
            "model_gathers": info.get("train_step.model_param_gathers"),
            "merges": sum(str(c["what"]).startswith("attn.merge")
                          for c in rec)}
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel compute
# ---------------------------------------------------------------------------

# the planted faults of tensor-parallel compute: the function of
# ``tensor_parallel`` replaced, the sites (its one str argument) where the
# replacement runs, and what the replacement returns there
PLANTED = {
    # one row-parallel product's all-reduce: each rank keeps its partial
    # sum (the MLP's w_out; the SSM's out_proj)
    "drop-row-sum": ("leave", ("mlp.w_out", "ssm.out_proj"),
                     lambda x, tp, what: x),
    # one replicated param's gradient sum over "model": each rank keeps
    # the gradient of its own part of the work (the SSM's norm_scale, the
    # k / v projections of kv columns the rules replicate)
    "drop-replicated-sum": ("enter", ("ssm.norm_scale", "attn.wk"),
                            lambda x, tp, what: x),
    # kv-SP's merge without its weights: each rank keeps the attention
    # over its own block of the keys, and its log-sum-exp
    "kv-sp-unweighted-merge": ("merge_blocks", ("attn.merge",),
                               lambda o, lse, tp, what: (o.float(), lse)),
    # kv-SP's dq without its sum over "model" (the q move's backward
    # all-reduce): each rank keeps the part its own keys give
    "kv-sp-drop-dq-sum": ("_all_reduce", ("attn.q",),
                          lambda t, tp, what, op=None: t.contiguous()),
}


@contextlib.contextmanager
def planted_fault(name: Optional[str]):
    """Inside the block, ``tensor_parallel``'s function of the fault
    (PLANTED) returns the fault's value at the fault's sites."""
    if name is None:
        yield
        return
    attr, sites, value = PLANTED[name]
    real = getattr(tpm, attr)

    def faulty(*args, **kw):
        what = next(a for a in args if isinstance(a, str))
        return (value if what in sites else real)(*args, **kw)
    setattr(tpm, attr, faulty)
    try:
        yield
    finally:
        setattr(tpm, attr, real)


def one_rank(model, params: Dict[str, torch.Tensor], batch) -> tuple:
    """`model`'s loss and gradient on the full `params` ({path: tensor})
    and batch here, without a mesh: (loss, {path: gradient})."""
    from repro_torch.train import step as step_mod

    v1, g1 = step_mod.value_and_grad(lambda p, b: model.loss(p, b)[0],
                                     nest(params), batch)
    return float(v1), by_path(g1)


def tp_gradients(model, params: Dict[str, torch.Tensor], batch, mesh, *,
                 fault: Optional[str] = None, one: Optional[tuple] = None,
                 keep: bool = False) -> dict:
    """`model`'s loss and gradient on `mesh` (tensor-parallel over
    "model", the batch split over the batch axes) through the train
    step's mesh loss, from the full `params` ({path: tensor}, the same on
    every rank) cut to this rank's blocks. Against `one` (``one_rank``'s
    result on the same params and batch), each leaf's error: max |mesh -
    one| over the block / max |one| over the leaf (``grad_err``), and
    ||mesh - one|| over the block / ||one|| over the leaf
    (``grad_err_l2``). Also the collectives of the mesh's step and, with
    `keep`, the mesh's gradient, every rank's blocks gathered to full
    (``grads``). `fault` plants one of PLANTED."""
    from repro_torch.launch.inputs import shard_batch
    from repro_torch.train import step as step_mod

    tree = nest(params)
    specs = param_specs(tree, mesh)
    local = shard_tree(tree, specs, mesh)
    rows, split = shard_batch(batch, mesh)
    loss = step_mod._mesh_loss(lambda p, b: model.loss(p, b)[0],
                               SimpleNamespace(param_specs=specs), mesh,
                               split)
    with record_collectives() as rec, planted_fault(fault):
        value, grads = step_mod.value_and_grad(loss, local, rows)
        value = step_mod._mean_over(value, mesh, split)
    del local
    out = {"loss": float(value), "collectives": [
        {k: c[k] for k in ("kind", "axes", "bytes", "what")} for c in rec]}
    if keep:
        out["grads"] = {p: gather_full(g.contiguous(), specs[p], mesh)
                        for p, g in leaves_with_paths(grads)}
    if one is None:
        return out
    out["loss_one"], g1_of = one
    errs, l2 = {}, {}
    for path, g in leaves_with_paths(grads):
        want = g1_of[path].float()
        diff = g.float() - local_shard(want, specs[path], mesh)
        errs[path] = float(diff.abs().max()
                           / want.abs().max().clamp_min(1e-30))
        l2[path] = float(diff.norm() / want.norm().clamp_min(1e-30))
    out["grad_err"], out["grad_err_l2"] = errs, l2
    return out


def model_param_gathers(collectives) -> List[dict]:
    """The all-gathers of a param block over "model" among `collectives`
    (``record_collectives``' dicts)."""
    return [c for c in collectives if c["kind"] == "all_gather"
            and "model" in c["axes"]
            and str(c.get("what") or "").startswith("param:")]
