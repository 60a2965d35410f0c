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

The reference's ``WeightsChannel`` (the trainer -> server bus over the
checkpoint files) waits for the port's checkpoint slice.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

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

    def __init__(self, params: PyTree):
        self._version = 0
        self._staged: Optional[PyTree] = None
        self._staged_version: Optional[int] = None
        self._active = self._land(params)

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
