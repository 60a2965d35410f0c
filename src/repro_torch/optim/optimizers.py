"""Gradient-transform optimizers as functions on param dicts.

    state   = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params  = apply_updates(params, updates)

The same interface and arithmetic as the reference's mini-optax, written
out by hand (not ``torch.optim``): the DMD jump resets moments by group
and the parity tests need the reference's exact bias correction and
``eps`` placement. Scalars (lr, bias corrections) are computed in fp32 on
the host, with the step counter as fp32, as the reference computes them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.paths import by_path, map_with_paths, tree_map
from repro_torch.optim.schedules import make_schedule

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple]   # (grads, state, params, step) -> (u, state)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr_fn) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        lr = float(lr_fn(step))
        return tree_map(lambda g: -lr * g.float(), grads), state
    return Optimizer(init, update)


def momentum(lr_fn, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(_zeros, params)

    def update(grads, state, params, step):
        lr = float(lr_fn(step))
        new_m = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m
    return Optimizer(init, update)


class AdamState(NamedTuple):
    m: PyTree
    v: PyTree


def adam(lr_fn, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        return AdamState(tree_map(_zeros, params), tree_map(_zeros, params))

    def update(grads, state, params, step):
        lr = float(lr_fn(step))
        t = np.float32(step) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        ms, vs, ps = by_path(state.m), by_path(state.v), by_path(params)
        new_m, new_v = {}, {}

        def upd(path, g):
            g = g.float()
            m = b1 * ms[path] + (1 - b1) * g
            v = b2 * vs[path] + (1 - b2) * g * g
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * ps[path].float()
            new_m[path], new_v[path] = m, v
            return u

        updates = map_with_paths(upd, grads)
        return updates, AdamState(
            map_with_paths(lambda p, _: new_m[p], grads),
            map_with_paths(lambda p, _: new_v[p], grads))
    return Optimizer(init, update)


def make_optimizer(cfg) -> Optimizer:
    """cfg: OptimizerConfig -> Optimizer with the schedule baked in."""
    if cfg.grad_clip and cfg.grad_clip > 0:
        raise NotImplementedError("grad_clip is not ported yet")
    lr_fn = make_schedule(cfg)
    if cfg.name == "sgd":
        return sgd(lr_fn)
    if cfg.name == "momentum":
        return momentum(lr_fn, beta=cfg.b1)
    if cfg.name == "adam":
        return adam(lr_fn, cfg.b1, cfg.b2, cfg.eps, 0.0)
    raise NotImplementedError(f"optimizer {cfg.name!r} is not ported yet")
