"""Logical-axis sharding rules: param path regex -> partition spec, and
each rank's block of a tensor under one.

The mesh has the axes ("pod", "data", "model") (pod optional), mapped as
the reference maps them (DESIGN.md §6):
  * batch            -> ("pod", "data")      activations
  * tensor-parallel  -> "model"              heads / ffn hidden / vocab / experts
  * fsdp             -> "data"               the non-TP dim of every >=2D param
  * pod              -> pure data parallelism

Specs are derived from the param path and trailing dims, so stacked
leading dims are replicated. A ``Spec`` is one entry per dim (an axis name,
a tuple of names, or None) and prints as the reference's ``PartitionSpec``
prints, so the plan tables of both packages read alike.

The reference places a tensor on its mesh with a ``NamedSharding``. Here
each rank holds its own block: ``local_shard(full, spec, mesh)`` slices it
and ``gather_full(local, spec, mesh)`` all-gathers it back (checkpoints,
and the forward's parameters).
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.paths import map_with_paths, normalize_path

PyTree = Any

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


class Spec:
    """A partition spec: one entry per leading dim (an axis name, a tuple
    of axis names, or None); dims past the last entry are replicated. A
    one-name tuple is that name, as a PartitionSpec normalises it."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        self.entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Spec) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + repr(self.entries)

    __str__ = __repr__


@contextlib.contextmanager
def mesh_context(mesh):
    """Make `mesh` the ambient mesh of the block (``current_mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


def batch_axes(mesh=None) -> Tuple[str, ...]:
    mesh = mesh or current_mesh()
    if mesh is not None and "pod" in mesh.axis_names:
        return ("pod", "data")
    return ("data",)


def constrain(x, *spec):
    """The identity. The reference constrains activations' shardings so
    that GSPMD lays out its compiled program and inserts the collectives;
    here the layout is explicit: each rank computes on its own blocks and
    the models call ``distributed/tensor_parallel.py``'s collectives where
    the reference's constraints change a sharding, so there is nothing to
    constrain."""
    return x


def logical_axis_rules() -> dict:
    return {"tp": "model", "fsdp": "data", "batch": ("pod", "data")}


# ---------------------------------------------------------------------------
# Param partition rules (the reference's table)
# ---------------------------------------------------------------------------
# Each rule: (path regex, spec for the TRAILING dims). Leading (stack) dims
# are padded with None. "fsdp" -> "data", "tp" -> "model".
_RULES = [
    (r"(^|/)(emb|lm_head)$", ("tp", "fsdp")),
    (r"pos_emb$", (None, "fsdp")),
    (r"wqkv$", ("fsdp", "tp")),
    (r"w[qkv]$", ("fsdp", "tp")),
    (r"wo$", ("tp", "fsdp")),
    (r"w_(gate|in)$", ("fsdp", "tp")),
    (r"w_out$", ("tp", "fsdp")),
    (r"experts_(gate|in)$", ("tp", "fsdp", None)),
    (r"experts_out$", ("tp", None, "fsdp")),
    (r"router$", ("fsdp", None)),
    (r"in_proj/(z|x|dt)$", ("fsdp", "tp")),
    (r"in_proj/(B|C)$", ("fsdp", None)),
    (r"out_proj$", ("tp", "fsdp")),
    (r"conv_w/x$", (None, "tp")),
    (r"conv_w/(B|C)$", None),
    (r"(A_log|dt_bias|skip_d)$", ("tp",)),
    (r"(scale|bias|b)$", None),
]

_RULE_OVERRIDES: list = []


def set_rule_overrides(overrides) -> None:
    """Prepend (regex, trailing rule) pairs to the param rules (the
    per-architecture sharding knob)."""
    global _RULE_OVERRIDES
    _RULE_OVERRIDES = list(overrides or [])


def rule_for_path(path: str):
    """The raw logical trailing-dims rule of a param path (or None)."""
    path = normalize_path(path)
    for pattern, trailing in _RULE_OVERRIDES + _RULES:
        if re.search(pattern, path):
            return trailing
    return None


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape)) if mesh else {}


def resolve_rule(trailing, ndim: int, shape, mesh) -> Spec:
    """Logical trailing rule -> physical Spec; a dim its axis does not
    divide is replicated."""
    mesh = mesh or current_mesh()
    sizes = _axis_sizes(mesh)

    def physical(logical, dim_size):
        ax = {"tp": "model", "fsdp": "data"}.get(logical, logical)
        if ax is None:
            return None
        size = sizes.get(ax, 1)
        if dim_size is not None and size > 1 and dim_size % size != 0:
            return None
        return ax

    if trailing is None:
        return Spec()
    trailing = trailing[-ndim:] if ndim < len(trailing) else trailing
    pad = (None,) * (ndim - len(trailing))
    dims = (list(shape[-len(trailing):]) if shape is not None
            else [None] * len(trailing))
    return Spec(*(pad + tuple(physical(t, d)
                              for t, d in zip(trailing, dims))))


def spec_for_path(path: str, ndim: int, mesh=None, shape=None) -> Spec:
    """A param path and shape -> its Spec (physical axis names);
    replicated where no rule matches."""
    trailing = rule_for_path(path)
    if trailing is None:
        return Spec()
    return resolve_rule(trailing, ndim, shape, mesh)


def partition_specs(params: PyTree, mesh=None) -> PyTree:
    """A tree of Specs matching `params` (full shapes)."""
    return map_with_paths(
        lambda path, x: spec_for_path(path, x.dim(), mesh, tuple(x.shape)),
        params)


def param_specs(params: PyTree, mesh) -> Dict[str, Spec]:
    """{path: full-length Spec} of the FULL params."""
    from repro_torch.core.paths import leaves_with_paths
    return {path: full_spec(spec_for_path(path, x.dim(), mesh,
                                          tuple(x.shape)), x.dim())
            for path, x in leaves_with_paths(params)}


def full_spec(spec: Spec, ndim: int) -> Spec:
    ent = tuple(spec)[:ndim]
    return Spec(*(ent + (None,) * (ndim - len(ent))))


# ---------------------------------------------------------------------------
# Each rank's block
# ---------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec names, in the spec's order."""
    out = []
    for e in spec:
        for a in entry_axes(e):
            if a not in out:
                out.append(a)
    return tuple(out)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    sizes = _axis_sizes(mesh)
    ent = tuple(spec) + (None,) * len(shape)
    return tuple(int(d) // int(np.prod([sizes.get(a, 1)
                                        for a in entry_axes(e)]))
                 for d, e in zip(shape, ent))


def local_shard(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of `full` under `spec` (a new contiguous tensor;
    `full` itself where nothing is sharded)."""
    if mesh is None:
        return full
    x = full
    for dim, e in enumerate(tuple(spec)[:full.dim()]):
        axes = entry_axes(e)
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split over {axes} ({n})")
        chunk = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(axes) * chunk, chunk)
    return x if x is full else x.contiguous()


def gather_full(local: torch.Tensor, spec: Spec, mesh, what=None
                ) -> torch.Tensor:
    """The full tensor from every rank's block under `spec` (one
    all-gather per sharded dim, each recorded as `what`); `local` itself
    where nothing is sharded."""
    if mesh is None:
        return local
    x = local
    for dim, e in enumerate(tuple(spec)[:local.dim()]):
        axes = entry_axes(e)
        if mesh.axis_size(axes) == 1:
            continue
        x = torch.cat(mesh.all_gather(x, axes, what=what), dim=dim)
    return x


def without_axis(spec: Spec, axis: str) -> Spec:
    """`spec` with the dims `axis` shards replicated: the layout of a
    block gathered over every other axis (a param the forward reads on a
    rank's "model" block)."""
    out = []
    for e in spec:
        axes = entry_axes(e)
        if axis in axes and len(axes) > 1:
            raise ValueError(f"{spec}: a dim sharded over {axis} and "
                             f"{axes} together")
        out.append(None if axis in axes else e)
    return Spec(*out)


def shard_tree(tree: PyTree, specs: Dict[str, Spec], mesh) -> PyTree:
    """Each leaf of `tree` replaced by its block under ``specs[path]``."""
    return map_with_paths(lambda p, x: local_shard(x, specs[p], mesh), tree)


def sum_squares(tree: PyTree, axes_of, mesh) -> torch.Tensor:
    """The fp32 sum of squares of a tree of local blocks: each leaf's local
    sum is summed over the axes that shard it (``axes_of(path)``), so a
    replicated leaf counts once. One all-reduce per distinct axis set."""
    from repro_torch.core.paths import leaves_with_paths
    from repro_torch.optim.optimizers import _sum_sq

    parts: Dict[Tuple[str, ...], torch.Tensor] = {}
    for path, x in leaves_with_paths(tree):
        axes = mesh.live_axes(axes_of(path)) if mesh else ()
        s = _sum_sq(x)
        parts[axes] = s if axes not in parts else parts[axes] + s
    if not parts:
        return torch.zeros((), dtype=torch.float32)
    total = None
    for axes in sorted(parts):
        s = parts[axes].reshape(1).clone()
        if axes:
            mesh.all_reduce(s, axes)
        total = s if total is None else total + s
    return total.reshape(())
