"""Atomic checkpoints in the reference's on-disk format.

    save_checkpoint(dir, state, step, keep=3)     # dir/step_{step}/
    state = restore_checkpoint(dir, template)     # newest step, or None

One directory per step holding ``arrays.npz`` (every leaf) and
``manifest.json``: ``{"step": N, "leaves": {keystr: {"key": "a{i}",
"shape": [...], "dtype": "..."}}}``. A leaf is named by its JAX key string
(``core/paths.py::keystr_leaves``: ``".params['l0']['w']"``,
``".opt_state.m['l0']['b']"``, ``".step"``) and stored under ``a{i}``, i
its index in the sorted key strings; bf16 is stored as its ``uint16``
bits with logical dtype ``"bfloat16"`` (``np.savez`` has no bf16). So a
checkpoint written by either package restores in the other.

The write goes to a ``.tmp_*`` directory renamed into place, removed on
any exception: a writer killed mid-write never exposes a partial step,
and ``list_checkpoints`` sees only steps with a manifest. ``keep=k``
prunes the oldest steps. Every tensor is copied to the host before
``save_checkpoint`` returns, so a caller may overwrite its state in place
right after.

Restore walks the template: a leaf the manifest names takes the stored
array (its stored dtype) on the template leaf's device; a leaf the
manifest lacks keeps the template's value (state grown after the
checkpoint was written, e.g. the controller's). Trainers save the
leaf-wise state (``DMDAccelerator.state_leafwise``), so the format does
not depend on ``dmd.arena`` or residency.

Under a mesh every rank holds blocks of the state. ``save_checkpoint(...,
mesh=, specs=)`` gathers each leaf to full (``specs`` by key string:
``launch/inputs.py::state_specs``), the mesh's first rank writes the same
format, and a barrier follows the write; ``restore_checkpoint(...,
mesh=, specs=)`` reads the checkpoint on every rank and keeps each leaf's
block under the CURRENT mesh's specs. So a checkpoint written on one mesh
restores onto another, onto one card, or into the reference, and the
reverse.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.paths import keystr_leaves, map_keystrs
from repro_torch.distributed.sharding import gather_full, local_shard

PyTree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")


def _to_host(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as the (C-ordered) numpy array stored for it, and its
    logical dtype."""
    x = x.detach()
    bf16 = x.dtype == torch.bfloat16
    arr = (x.view(torch.int16) if bf16 else x).cpu().numpy()
    arr = np.array(arr, order="C", copy=not arr.flags.c_contiguous)
    return (arr.view(np.uint16), "bfloat16") if bf16 else (arr,
                                                            str(arr.dtype))


def _from_host(arr: np.ndarray, dtype: str, device, spec=None,
               mesh=None) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if mesh is not None:
        t = local_shard(t, spec, mesh)
    return t.to(device)


def save_checkpoint(ckpt_dir, state: PyTree, step: int, keep: int = 3,
                    mesh=None, specs=None) -> str:
    """Write `state` as ``ckpt_dir/step_{step}`` (replacing one there) and
    prune to the newest `keep` steps. Returns the step's directory. Under
    `mesh`, `state` holds this rank's blocks, laid out by `specs` ({key
    string: Spec}); every rank takes part in the gathers, the mesh's first
    rank writes."""
    ckpt_dir = Path(ckpt_dir)
    writer = mesh is None or mesh.rank == 0
    final = ckpt_dir / f"step_{step}"
    arrays = {}
    manifest = {"step": int(step), "leaves": {}}
    leaves = sorted(keystr_leaves(state), key=lambda kv: kv[0])
    for i, (path, leaf) in enumerate(leaves):
        if mesh is not None:
            leaf = gather_full(leaf, specs[path], mesh)
        if not writer:
            continue
        key = f"a{i}"
        arrays[key], dtype = _to_host(leaf)
        manifest["leaves"][path] = {"key": key,
                                    "shape": list(arrays[key].shape),
                                    "dtype": dtype}
    if writer:
        _write(ckpt_dir, final, arrays, manifest, keep)
    if mesh is not None:
        mesh.barrier()
    return str(final)


def _write(ckpt_dir: Path, final: Path, arrays: dict, manifest: dict,
           keep: int) -> None:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        np.savez(tmp / "arrays.npz", **arrays)
        del arrays
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(ckpt_dir, keep)


def _prune(ckpt_dir: Path, keep: int) -> None:
    steps = list_checkpoints(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def list_checkpoints(ckpt_dir) -> list:
    """The complete steps (those with a manifest) in `ckpt_dir`, sorted."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for d in ckpt_dir.iterdir():
        m = _STEP_RE.match(d.name)
        if m and (d / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, template: PyTree,
                       step: Optional[int] = None, mesh=None,
                       specs=None) -> Optional[PyTree]:
    """`template` with every leaf the manifest of `step` (default: the
    newest) names replaced by the stored array, on the template leaf's
    device; the others keep the template's value. None when there is no
    checkpoint. The arrays are read into memory, not mapped. Under `mesh`
    each rank keeps its block of each stored array under ``specs[key
    string]``."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None
    d = ckpt_dir / f"step_{step}"
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    with np.load(d / "arrays.npz") as arrays:
        def one(path, leaf):
            meta = leaves.get(path)
            if meta is None:
                return leaf
            return _from_host(arrays[meta["key"]], meta["dtype"],
                              getattr(leaf, "device", "cpu"),
                              None if mesh is None else specs[path], mesh)
        return map_keystrs(one, template)
