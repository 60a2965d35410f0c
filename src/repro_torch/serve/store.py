"""Version-stamped double-buffered parameter store.

``ParamStore`` owns the serving weights. A publish is two phases:

  * ``stage(params, version)`` lands the incoming tree in FRESH device
    buffers (a device-to-device ``clone`` of every leaf, so the publisher
    may go on changing its own tensors) and waits until the copy is done.
    The staged tree is the standby buffer.
  * ``commit()`` flips active and standby on the host and bumps the
    version. Nothing touches the old active tensors, so work already
    enqueued on them completes untouched; they are freed when the last
    reference goes.

Steady state holds one copy of the params; between ``stage`` and
``commit`` two. A version at or below the active one is refused as stale.
The constructor takes the caller's tensors themselves as the first active
buffer (as the reference's ``serve_fns(model, donate=True)`` donates
them): a model whose weights fill most of the card exists once on it. The
caller must not change them afterwards (pass a clone to keep changing
its own); ``stage`` still copies, so a later swap needs room for a second
copy.

``WeightsChannel`` is the trainer -> server bus over the checkpoint files
(``checkpoint/``): the trainer ``publish``es a param tree as a version,
a server ``poll``s the newest one into its engine's store. Its files are
the reference's, so either package may publish and the other load.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.paths import tree_map

PyTree = Any


def _sync(tree: PyTree) -> None:
    """Wait for the copies (nothing to wait for on the CPU)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    if tree.is_cuda:
        torch.cuda.synchronize(tree.device)


class ParamStore:
    """Double-buffered, version-stamped residence for the weights."""

    #: the store's share of the engine's program ceiling (the reference's
    #: landing-copy program; here the per-leaf clone of ``stage``)
    n_programs = 1

    def __init__(self, params: PyTree):
        self._version = 0
        self._staged: Optional[PyTree] = None
        self._staged_version: Optional[int] = None
        self._active = tree_map(lambda t: t.detach(), params)

    @staticmethod
    def _land(params: PyTree) -> PyTree:
        out = tree_map(lambda t: t.detach().clone(), params)
        _sync(out)
        return out

    @property
    def params(self) -> PyTree:
        return self._active

    @property
    def version(self) -> int:
        return self._version

    @property
    def staged_version(self) -> Optional[int]:
        return self._staged_version

    def stage(self, params: PyTree, version: Optional[int] = None) -> int:
        """Land ``params`` in the standby buffer; does not serve them yet."""
        v = self._version + 1 if version is None else int(version)
        if v <= self._version:
            raise ValueError(
                f"stale publish: version {v} <= active {self._version}")
        self._staged = self._land(params)
        self._staged_version = v
        return v

    def commit(self) -> int:
        """Flip: standby becomes active, the version bumps."""
        if self._staged is None:
            raise RuntimeError("commit() with no staged weights")
        self._active = self._staged
        self._version = self._staged_version
        self._staged = None
        self._staged_version = None
        return self._version

    def publish(self, params: PyTree, version: Optional[int] = None) -> int:
        """stage + commit in one call."""
        self.stage(params, version)
        return self.commit()


class WeightsChannel:
    """File-based trainer -> server weights bus over the checkpoint layer.

    A publish is torn-write-safe: ``save_checkpoint`` writes a temporary
    directory and renames it into place, so a publisher killed mid-write
    never exposes a partial version (``latest_version`` keeps returning
    the previous one). The newest two versions are kept.
    """

    def __init__(self, root):
        self.root = str(root)

    def publish(self, params: PyTree, version: int) -> str:
        return save_checkpoint(self.root, {"params": params}, int(version),
                               keep=2)

    def latest_version(self) -> Optional[int]:
        return latest_step(self.root)

    def load(self, template: PyTree, version: Optional[int] = None
             ) -> Optional[PyTree]:
        """Version `version` (default: the newest) on the devices of
        `template`'s leaves, or None when nothing was published."""
        out = restore_checkpoint(self.root, {"params": template},
                                 step=version)
        return None if out is None else out["params"]

    def poll(self, engine, template: PyTree) -> Optional[int]:
        """Swap `engine` onto the newest published version if it is newer
        than the engine's; returns that version, else None."""
        v = self.latest_version()
        if v is None or v <= engine.version:
            return None
        engine.swap_weights(self.load(template, v), version=v)
        return v
