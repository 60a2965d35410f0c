"""Move parameter trees between the two packages' representations."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device


def params_from_jax(tree: Any, device="cuda") -> Any:
    """A reference param tree whose leaves are numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, init_mlp(key, sizes))``) -> the
    same nested dicts of torch tensors on `device`, values and dtypes
    unchanged. This package never imports JAX: the caller converts to
    numpy first."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)
