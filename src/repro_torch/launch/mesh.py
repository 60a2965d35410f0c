"""The device mesh: ranks as processes, collectives through
``torch.distributed``.

    init_process_group("gloo", rank=r, world_size=4, store=FileStore(...))
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    mesh.all_reduce(t, ("data",))          # sum over the data axis, in place

One process per device (a rank), laid out row-major over the mesh's axes
``("pod", "data", "model")`` (pod optional): rank r sits at
``np.unravel_index(r, shape)``. The layout is a ``DeviceMesh`` built without
its own process groups (``device_mesh``); ``Mesh`` makes, at
construction, one process group for every subset of the non-trivial axes a
reduction may name (at most 7, each split by the other axes' coordinates),
every rank calling ``new_group`` for every group in the same order. A
collective over a subset whose mesh size is 1 makes no call.

The reference's table code reads a mesh only through ``axis_names`` and
``devices.shape``; ``Mesh`` exposes both, so the port's spec, plan and
arena tables read it as the reference reads a ``jax.sharding.Mesh``.

The backend is the caller's explicit choice (``init_process_group``):
NCCL where each rank has a card of its own, gloo where ranks share one
card or run on the CPU. Nothing swaps one for the other: NCCL refuses two
ranks on one GPU, and that error stays an error. The process group has a
timeout (``TIMEOUT_S``), so a rank that diverges from the others raises
instead of hanging the run.

Every collective made through a ``Mesh`` is appended to the innermost
``record_collectives()`` list (kind, axes, dtype, shape, bytes, and the
caller's ``what``: a param's path for a param block, a tensor-parallel
site for an activation): the audit's collective budget reads it.

``run_ranks(fn, world, ...)`` spawns `world` ranks (start method
``spawn``), each joined to a gloo or NCCL group through a ``FileStore``, runs
``fn(rank, *args)`` in each and returns their results; a rank that raises
fails the call, and a run that outlives ``join_timeout`` is terminated and
raises.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import pickle
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")
TIMEOUT_S = 60                      # process-group timeout (seconds)

_RECORDS: List[list] = []


@contextlib.contextmanager
def record_collectives():
    """Collect every collective a ``Mesh`` makes inside the block: a list
    of dicts (``kind``, ``axes``, ``dtype``, ``shape``, ``bytes``,
    ``what``: what the caller named the tensor, or None)."""
    out: list = []
    _RECORDS.append(out)
    try:
        yield out
    finally:
        _RECORDS.remove(out)


def _record(kind: str, axes, t: torch.Tensor, what=None) -> None:
    for rec in _RECORDS:
        rec.append({"kind": kind, "axes": tuple(axes),
                    "dtype": str(t.dtype).removeprefix("torch."),
                    "shape": tuple(t.shape),
                    "bytes": t.numel() * t.element_size(), "what": what})


def init_process_group(backend: str, *, rank: int, world_size: int,
                       store=None, init_method: Optional[str] = None,
                       timeout_s: float = TIMEOUT_S) -> None:
    """Join the default process group on `backend` ("gloo" or "nccl"),
    through `store` or `init_method` ("env://" reads ``MASTER_ADDR`` /
    ``MASTER_PORT``), with a timeout."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    kw = {"store": store} if store is not None else \
        {"init_method": init_method or "env://"}
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s), **kw)


def init_from_env(backend: str) -> Tuple[int, int]:
    """Join the group ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); returns (rank, world size)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if not dist.is_initialized():
        init_process_group(backend, rank=rank, world_size=world,
                           init_method="env://")
    return rank, world


class _Devices:
    """The ``devices.shape`` the reference's table code reads."""

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = shape


def default_axis_names(ndim: int) -> Tuple[str, ...]:
    return {1: ("data",), 2: ("data", "model"), 3: AXES}[ndim]


class Mesh:
    """A mesh over the ranks ``0 .. prod(shape) - 1`` of the default group
    (every rank of the group constructs it; a rank beyond the mesh is not
    a member and makes no collective through it). `device` is where this
    rank's tensors live."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Optional[Sequence[str]] = None, *,
                 device="cpu"):
        from torch.distributed.device_mesh import DeviceMesh

        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names or default_axis_names(len(shape)))
        if len(names) != len(shape) or not set(names) <= set(AXES):
            raise ValueError(f"axis names {names} for a mesh of shape "
                             f"{shape}: each one of {AXES}")
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs the default process group: call "
                               "init_process_group first")
        n = int(np.prod(shape))
        world = dist.get_world_size()
        if n > world:
            raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                             f"group has {world}")
        self.axis_names = names
        self.devices = _Devices(shape)
        self.shape = shape
        self.sizes = dict(zip(names, shape))
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        me = dist.get_rank()
        self.rank = me if me < n else None
        layout = np.arange(n).reshape(shape)
        self.coords = (dict(zip(names, (int(c) for c in np.unravel_index(
            me, shape)))) if self.rank is not None else None)
        self.device_mesh = (DeviceMesh(self.device.type,
                                       torch.as_tensor(layout),
                                       mesh_dim_names=names,
                                       _init_backend=False)
                            if self.rank is not None else None)
        # one group per subset of the non-trivial axes, split by the
        # coordinates of the other axes; every rank makes every group, in
        # the same order
        live = [a for a in names if self.sizes[a] > 1]
        self._groups: Dict[Tuple[str, ...], Any] = {}
        for k in range(1, len(live) + 1):
            for subset in itertools.combinations(live, k):
                dims = [names.index(a) for a in subset]
                rest = [i for i in range(len(names)) if i not in dims]
                for fixed in itertools.product(
                        *(range(shape[i]) for i in rest)):
                    idx = [slice(None)] * len(names)
                    for i, c in zip(rest, fixed):
                        idx[i] = c
                    ranks = sorted(int(r) for r in
                                   np.ravel(layout[tuple(idx)]))
                    g = dist.new_group(ranks)
                    if self.rank is not None and me in ranks:
                        self._groups[subset] = g

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.sizes)}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    # ---- axes -------------------------------------------------------------
    def live_axes(self, axes) -> Tuple[str, ...]:
        """`axes` (a name, a tuple, or None) without the axes of size 1,
        in mesh order."""
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names
                     if a in axes and self.sizes[a] > 1)

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return int(np.prod([self.sizes.get(a, 1) for a in axes]))

    def axis_index(self, axes) -> int:
        """This rank's linear index over `axes`, the first axis major (the
        order a spec entry names them in)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        idx = 0
        for a in axes:
            idx = idx * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return idx

    def group(self, axes):
        """The process group over `axes` that holds this rank; None where
        their mesh size is 1."""
        live = self.live_axes(axes)
        return self._groups[live] if live else None

    # ---- collectives --------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM,
                   what=None) -> torch.Tensor:
        """Reduce `t` over `axes` in place; returns `t`. `what` names the
        tensor in the recorder."""
        g = self.group(axes)
        if g is not None:
            _record("all_reduce", self.live_axes(axes), t, what)
            dist.all_reduce(t, op=op, group=g)
        return t

    def all_gather(self, t: torch.Tensor, axes, what=None
                   ) -> List[torch.Tensor]:
        """Every rank's `t` over `axes`, ordered by the linear index over
        `axes` in the order given (the spec entry's order). `what` names
        the tensor in the recorder."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        g = self.group(axes)
        if g is None:
            return [t]
        live = self.live_axes(axes)
        _record("all_gather", live, t, what)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.axis_size(live))]
        dist.all_gather(parts, t, group=g)
        # group rank = the linear index over `live` in mesh order
        order = [0] * len(parts)
        for gi in range(len(parts)):
            c = dict(zip(live, np.unravel_index(
                gi, [self.sizes[a] for a in live])))
            j = 0
            for a in axes:
                j = j * self.sizes.get(a, 1) + int(c.get(a, 0))
            order[j] = gi
        return [parts[gi] for gi in order]

    def broadcast(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """`t` of the first rank over `axes` (default: every axis), in
        place on the others."""
        g = self.group(self.axis_names if axes is None else axes)
        if g is not None:
            _record("broadcast", self.live_axes(
                self.axis_names if axes is None else axes), t)
            dist.broadcast(t, src=min(dist.get_process_group_ranks(g)),
                           group=g)
        return t

    def any_(self, flag: bool) -> bool:
        """True where any rank of the mesh says so (one host decision that
        every rank takes alike)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        self.all_reduce(t, self.axis_names, op=dist.ReduceOp.MAX)
        return bool(t.item())  # lint: allow-host-sync (a host decision)

    def barrier(self) -> None:
        g = self.group(self.axis_names)
        if g is not None:
            dist.barrier(group=g)


def make_mesh_for_devices(n_devices: int, model_parallel: int = 1,
                          pods: int = 1, *, device="cpu") -> Mesh:
    """A (pod, data, model) mesh over `n_devices` ranks (no pod axis for
    one pod): the restart-after-resize helper."""
    if n_devices % (model_parallel * pods):
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"tp={model_parallel} x pods={pods}")
    data = n_devices // (model_parallel * pods)
    if pods > 1:
        return Mesh((pods, data, model_parallel), AXES, device=device)
    return Mesh((data, model_parallel), ("data", "model"), device=device)


def make_production_mesh(multi_pod: bool = False, *, device="cuda") -> Mesh:
    """The reference's production mesh: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return Mesh((2, 16, 16), AXES, device=device)
    return Mesh((16, 16), ("data", "model"), device=device)


def parse_mesh(s: str) -> Tuple[int, ...]:
    """"2x2" -> (2, 2); "2x2x2" -> (2, 2, 2)."""
    try:
        shape = tuple(int(d) for d in s.lower().split("x"))
    except ValueError:
        raise ValueError(f"a mesh is DxM or PxDxM (e.g. 2x2), got {s!r}")
    if not 1 <= len(shape) <= 3 or min(shape) < 1:
        raise ValueError(f"a mesh is DxM or PxDxM (e.g. 2x2), got {s!r}")
    return shape


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               store_path: str, out_dir: str, args: tuple,
               threads: int) -> None:
    torch.set_num_threads(threads)
    store = dist.FileStore(store_path, world)
    init_process_group(backend, rank=rank, world_size=world, store=store)
    try:
        result = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              join_timeout: float = 120.0, tmp_dir: Optional[str] = None,
              threads: int = 1) -> List[Any]:
    """Spawn `world` ranks, each running ``fn(rank, *args)`` inside a
    process group on `backend` with `threads` CPU threads (ranks that
    share a host's cores would otherwise oversubscribe them); returns
    their results by rank. `fn` must be importable (a module-level
    function). A rank that raises fails the call with its traceback; past
    `join_timeout` seconds every rank is terminated and this raises."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=tmp_dir) as d:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, os.path.join(d, "store"),
                              d, args, threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + join_timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks of {getattr(fn, '__name__', fn)} "
                        f"did not finish within {join_timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(5)
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
