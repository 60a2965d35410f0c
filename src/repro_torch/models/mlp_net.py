"""The paper's regression network: feed-forward softsign MLP
(6 -> 40 -> 200 -> 1000 -> 2670), Xavier init, trained with Adam on MSE.

Params keep the reference's layout, ``{"l<i>": {"w": (fan_in, fan_out),
"b": (fan_out,)}}`` with ``h @ w + b``, so the arena packs the same leaves
in the same order as the reference does.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn

from repro_torch.kernels.device import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


def init_mlp(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float32, device="cuda") -> Params:
    """sizes: [in, h1, ..., out]. Xavier/Glorot normal weights, zero biases,
    drawn from the CPU `generator` (its numbers differ from JAX's for the
    same seed; the tests inject the reference's weights instead), then
    placed on `device`."""
    device = resolve_device(device)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        std = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32) * std
        params[f"l{i}"] = {"w": w.to(dtype=dtype, device=device),
                           "b": torch.zeros((fan_out,), dtype=dtype,
                                            device=device)}
    return params


def mlp_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    h = x
    for i in range(n):
        p = params[f"l{i}"]
        h = h @ p["w"] + p["b"]
        if i < n - 1:
            h = nn.functional.softsign(h)
    return h


def mse_loss(params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    return torch.mean(torch.square(mlp_forward(params, x) - y))


class MLPNet(nn.Module):
    """``nn.Module`` view of the same network: its parameters ARE the
    params dict (``self.params["l0"]["w"]`` ...), in the reference layout."""

    def __init__(self, params: Params):
        super().__init__()
        self.params = nn.ModuleDict({
            name: nn.ParameterDict({k: nn.Parameter(v) for k, v in
                                    layer.items()})
            for name, layer in params.items()})

    def as_dict(self) -> Params:
        return {name: dict(layer.items()) for name, layer in
                self.params.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self.as_dict(), x)


class MLPModel:
    """Trainer adapter for the paper's regression MLP (the counterpart of
    the reference benchmarks' ``_MLPModel``): ``init``, ``loss`` and
    ``param_stack_dims`` are the whole contract ``Trainer`` needs; batches
    are ``{"x": (B, in), "y": (B, out)}`` dicts."""

    def __init__(self, sizes: Sequence[int]):
        self.sizes = tuple(sizes)

    def init(self, generator: torch.Generator) -> Params:
        """Xavier init from the CPU `generator`, on the CPU (the Trainer
        moves it to its device)."""
        return init_mlp(generator, self.sizes, device="cpu")

    def loss(self, params: Params, batch) -> tuple:
        return mse_loss(params, batch["x"], batch["y"]), None

    def param_stack_dims(self):
        """No stacked leaves."""
        return None
