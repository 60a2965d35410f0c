"""Gradient-transform optimizers as functions on param dicts.

    state   = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params  = apply_updates(params, updates)

The same interface and arithmetic as the reference's mini-optax, written
out by hand (not ``torch.optim``): the DMD jump resets moments by group
and the parity tests need the reference's exact bias correction and
``eps`` placement. ``step`` is the optimizer-step counter as a tensor (the
Trainer's device int32 counter) or a Python int; the lr and the bias
corrections are fp32 tensor arithmetic on it, as the reference computes
them, and nothing is read back to the host: a captured CUDA graph
recomputes them from the counter on every replay.

The elementwise optimizers (sgd, momentum, adam, adamw; with or without
clipping) also have ``update_(grads, state, params, step)``, which the
train step uses: their ``update`` run in place on ``CHUNK`` elements of
every leaf at a time (``_in_place``), the moments written into ``state``
and the update added to ``params``, so its temporaries are a few chunks
and not several params-sized trees (at TinyLlama's width those would not
fit beside the DMD ring). Elementwise arithmetic gives the same bits in
chunks.

Trees are the port's nested dicts, including the arena-resident wrapper
``{"__arena__": {bucket: flat}, "leaf": tree with None}``: every update
is elementwise per path, so a flat resident buffer updates as one leaf
(``RESIDENT_OPTIMIZERS`` in ``train/step.py``). ``adafactor`` factors the
trailing two dims and ``adam8bit`` quantizes fixed 256-blocks, so they
run only on per-leaf params.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.paths import (by_path, leaves_with_paths,
                                    map_with_paths, tree_map)
from repro_torch.optim.schedules import make_schedule

PyTree = Any


CHUNK = 1 << 24                     # elements per pass of ``update_``


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple]   # (grads, state, params, step) -> (u, state)
    # (grads, state, params, step) -> None, in place (elementwise ones only)
    update_: Optional[Callable[..., None]] = None


def _in_place(update):
    """``update`` as ``update_(grads, state, params, step, scale=None)``:
    run on CHUNK-element views of every leaf of grads, state and params at
    a time (grads times `scale` first, as ``clip_by_global_norm`` leaves
    them), the new state written into the state's views and the update
    added to the params'. Writes into a view land in its tensor; an
    elementwise update gives the same bits a chunk at a time."""
    def update_(grads, state, params, step, scale=None):
        trees = (grads, state, params)
        if not all(x.is_contiguous() for t in trees
                   for _, x in leaves_with_paths(t)):
            raise ValueError("update_ needs contiguous params, grads and "
                             "moments")
        n = max(x.numel() for _, x in leaves_with_paths(grads))
        for a in range(0, n, CHUNK):
            g, s, p = (map_with_paths(
                lambda _, x: x.view(-1)[a:a + CHUNK], t) for t in trees)
            if scale is not None:
                g = map_with_paths(lambda _, x: x * scale.to(x.dtype), g)
            u, new_s = update(g, s, p, step)
            new_of, u_of = by_path(new_s), by_path(u)
            for path, x in leaves_with_paths(s):
                x.copy_(new_of[path])
            for path, x in leaves_with_paths(p):
                x.add_(u_of[path].to(x.dtype))
    return update_


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    leaves = [torch.sum(torch.square(x.float())) for _, x in
              by_path(tree).items()]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _t(step) -> torch.Tensor:
    """The step counter + 1 in fp32 (bias corrections, adafactor's decay)."""
    return torch.as_tensor(step).float() + 1.0


def _split(fn, tree: PyTree, n: int):
    """``fn(path, leaf)`` -> an n-tuple for every leaf of `tree`; returns n
    trees shaped like `tree`."""
    out = {path: fn(path, x) for path, x in by_path(tree).items()}
    return tuple(map_with_paths(lambda p, _, i=i: out[p][i], tree)
                 for i in range(n))


def sgd(lr_fn) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        lr = lr_fn(step)
        return tree_map(lambda g: -lr * g.float(), grads), state

    return Optimizer(init, update, _in_place(update))


def momentum(lr_fn, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(_zeros, params)

    def update(grads, state, params, step):
        lr = lr_fn(step)
        new_m = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update, _in_place(update))


class AdamState(NamedTuple):
    m: PyTree
    v: PyTree


def adam(lr_fn, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        return AdamState(tree_map(_zeros, params), tree_map(_zeros, params))

    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = _t(step)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
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

    return Optimizer(init, update, _in_place(update))


def adamw(lr_fn, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01) -> Optimizer:
    return adam(lr_fn, b1, b2, eps, weight_decay)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment): optimizer memory O(rows + cols)
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    vr: PyTree      # row second moment (or the full v for < 2-D leaves)
    vc: PyTree      # column second moment (or a scalar for < 2-D leaves)


def adafactor(lr_fn, decay=0.999, eps=1e-30, clip_threshold=1.0
              ) -> Optimizer:
    """Beta1-free Adafactor. Factors the trailing two dims of >= 2-D
    params."""

    def init(params):
        def vr_of(p):
            return _zeros(p[..., 0]) if p.dim() >= 2 else _zeros(p)

        def vc_of(p):
            if p.dim() >= 2:
                return _zeros(p[..., 0, :])
            return torch.zeros((), dtype=torch.float32, device=p.device)
        return AdafactorState(tree_map(vr_of, params),
                              tree_map(vc_of, params))

    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = _t(step)
        # time-dependent decay (Shazeer & Stern)
        beta = torch.clamp_max(1.0 - torch.pow(t, -0.8), decay)
        vrs, vcs, ps = by_path(state.vr), by_path(state.vc), by_path(params)

        def upd(path, g):
            g = g.float()
            g2 = g * g + eps
            vr, vc = vrs[path], vcs[path]
            if ps[path].dim() >= 2:
                new_vr = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
                new_vc = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
                # rank-1 reconstruction of v
                denom = torch.mean(new_vr, dim=-1, keepdim=True)
                vhat = (new_vr[..., :, None] * new_vc[..., None, :]
                        / torch.clamp_min(denom[..., None], eps))
                u = g / torch.sqrt(vhat + eps)
            else:
                new_vr = beta * vr + (1 - beta) * g2
                new_vc = vc
                u = g / torch.sqrt(new_vr + eps)
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            return new_vr, new_vc, -lr * u

        vr, vc, u = _split(upd, grads, 3)
        return u, AdafactorState(vr, vc)
    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# 8-bit Adam: block-quantized moments
# ---------------------------------------------------------------------------

_QBLOCK = 256


def _quantize(x: torch.Tensor):
    """Flatten to blocks of _QBLOCK: int8 values and one fp32 absmax scale
    per block."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _QBLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q, scale[:, 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


class Adam8bitState(NamedTuple):
    mq: PyTree
    ms: PyTree
    vq: PyTree
    vs: PyTree


def adam8bit(lr_fn, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0
             ) -> Optimizer:
    def init(params):
        mq, ms = _split(lambda _, p: _quantize(_zeros(p)), params, 2)
        vq, vs = _split(lambda _, p: _quantize(_zeros(p)), params, 2)
        return Adam8bitState(mq, ms, vq, vs)

    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = _t(step)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        of = [by_path(x) for x in (state.mq, state.ms, state.vq, state.vs,
                                   params)]

        def upd(path, g):
            mq, ms, vq, vs, p = (o[path] for o in of)
            g = g.float()
            m = b1 * _dequantize(mq, ms, p.shape) + (1 - b1) * g
            v = b2 * _dequantize(vq, vs, p.shape) + (1 - b2) * g * g
            v = torch.clamp_min(v, 0.0)
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return _quantize(m) + _quantize(v) + (u,)

        nmq, nms, nvq, nvs, u = _split(upd, grads, 5)
        return u, Adam8bitState(nmq, nms, nvq, nvs)
    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def make_optimizer(cfg) -> Optimizer:
    """cfg: OptimizerConfig -> Optimizer with the schedule and gradient
    clipping baked in."""
    lr_fn = make_schedule(cfg)
    if cfg.name == "sgd":
        base = sgd(lr_fn)
    elif cfg.name == "momentum":
        base = momentum(lr_fn, beta=cfg.b1)
    elif cfg.name == "adam":
        base = adam(lr_fn, cfg.b1, cfg.b2, cfg.eps, 0.0)
    elif cfg.name == "adamw":
        base = adamw(lr_fn, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    elif cfg.name == "adafactor":
        base = adafactor(lr_fn, decay=cfg.b2)
    elif cfg.name == "adam8bit":
        base = adam8bit(lr_fn, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")

    if cfg.grad_clip and cfg.grad_clip > 0:
        inner = base

        def update(grads, state, params, step):
            grads = clip_by_global_norm(grads, cfg.grad_clip)
            return inner.update(grads, state, params, step)

        def update_(grads, state, params, step):
            scale = torch.clamp_max(
                cfg.grad_clip / (global_norm(grads) + 1e-12), 1.0)
            inner.update_(grads, state, params, step, scale)
        base = Optimizer(inner.init, update,
                         None if inner.update_ is None else update_)
    return base
