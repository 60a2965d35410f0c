"""Move parameter trees between the two packages' representations."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.device import resolve_device


def params_from_jax(tree: Any, device="cuda") -> Any:
    """A reference param tree whose leaves are numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, init_mlp(key, sizes))``) -> the
    same nested dicts of torch tensors on `device`, values, dtypes and
    shapes unchanged: every family's tree carries over as it is (a
    zamba segment's (groups, 6, ...) Mamba stacks, its ``shared_block``,
    the SSM's fp32 scalars beside bf16 matrices, a gemma segment's
    (groups, 5, ...) local stacks beside its (groups, ...) global layer,
    Granite's gate-less MLP, Whisper's LayerNorm ``b``, ``pos_emb``,
    ``enc_pos_emb`` and enc / dec stacks). This package never
    imports JAX: the caller converts to numpy first."""
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
