"""Partition specs of a training run's inputs and state on a mesh (the
reference's ``launch/inputs.py``, its training side).

A batch splits its leading dim over the batch axes (``("pod", "data")``,
or ``("data",)`` without a pod axis) where they divide it, and is
replicated where they do not. Params and their optimizer moments follow
the path rules (``distributed/sharding.py``); the DMD ring buffers and
Grams follow the plan table (``plan.snapshot_spec`` / ``plan.gram_spec``),
the one audited source. ``state_specs`` gives the spec of every leaf of a
LEAF-WISE TrainState (the layout checkpoints are written in) by its
checkpoint key string, which is what ``Trainer.save`` gathers by and
``Trainer.restore`` slices by.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.core.paths import (by_path, keystr_leaves, leaves_with_paths,
                                    map_with_paths)
from repro_torch.distributed.sharding import (Spec, batch_axes, local_shard,
                                              param_specs)

__all__ = ["batch_axes", "gate_batch_specs", "shard_batch", "param_specs",
           "state_specs"]

PyTree = Any


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _nbatch(mesh) -> int:
    s = _mesh_sizes(mesh)
    return s.get("pod", 1) * s.get("data", 1)


def _batch_spec(x, mesh) -> Spec:
    nd = x.dim()
    if nd == 0:
        return Spec()
    b = batch_axes(mesh) if x.shape[0] % _nbatch(mesh) == 0 else None
    return Spec(*((b,) + (None,) * (nd - 1)))


def gate_batch_specs(batch: PyTree, mesh) -> PyTree:
    """Specs of the controller's gate batch (and of a training batch):
    the leading dim over the batch axes where they divide it, everything
    else replicated."""
    return map_with_paths(lambda _, x: _batch_spec(x, mesh), batch)


def shard_batch(batch: PyTree, mesh) -> Tuple[PyTree, bool]:
    """This rank's rows of `batch`, and whether the rows were split (False:
    every rank holds the whole batch). The rows split only where the
    batch axes divide every leaf's leading dim."""
    leaves = leaves_with_paths(batch)
    split = _nbatch(mesh) > 1 and all(
        x.dim() > 0 and x.shape[0] % _nbatch(mesh) == 0 for _, x in leaves)
    if not split:
        return batch, False
    spec = Spec(batch_axes(mesh))
    return map_with_paths(lambda _, x: local_shard(x, spec, mesh),
                          batch), True


def _params_shaped(field, paths) -> bool:
    return isinstance(field, dict) and set(by_path(field)) == paths


def state_specs(state, plans: PyTree, pspecs: Dict[str, Spec]
                ) -> Dict[str, Spec]:
    """{checkpoint key string: Spec} for a leaf-wise TrainState: params and
    their params-shaped optimizer fields by ``pspecs``, ring buffers and
    Grams by the plan table, every other leaf (the step, the controller,
    scalar optimizer fields) replicated."""
    plan_of = by_path(plans)
    paths = set(by_path(state.params))

    def rep(tree):
        return map_with_paths(lambda _, x: Spec(), tree)

    def params_like(tree):
        return map_with_paths(lambda p, _: pspecs[p], tree)

    def field(f):
        return params_like(f) if _params_shaped(f, paths) else rep(f)

    opt = state.opt_state
    if isinstance(opt, tuple) and hasattr(opt, "_fields"):
        opt = type(opt)(*(field(f) for f in opt))
    else:
        opt = field(opt)
    tree = state._replace(
        params=params_like(state.params), opt_state=opt, step=Spec(),
        dmd_buffers=map_with_paths(lambda p, _: plan_of[p].snapshot_spec,
                                   state.dmd_buffers),
        dmd_gram=map_with_paths(lambda p, _: plan_of[p].gram_spec,
                                state.dmd_gram),
        controller=rep(state.controller))
    return dict(keystr_leaves(tree))
