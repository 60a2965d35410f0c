"""The paper's experiment loop: Adam on the softsign MLP with DMD jumps.

    python -m repro_torch.train.paper_loop [--steps 300] [--rows 1000]
        [--no-streaming] [--device cuda]

Each step takes an Adam step; on recorded steps the params go into the
arena ring buffer and one streaming Gram row is refreshed (kernel K1);
when a window closes the accelerator jumps (coefficient solve, kernel K2)
and the optimizer moments of the jumped groups reset. A jump that raises
the training loss is reverted (the guard). With ``streaming_gram=False``
no Gram is carried and each jump recomputes it (kernel K3).

Data: the numpy-seeded teacher of ``data/synthetic.py`` at the paper's
output width, until the PDE dataset is ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import DMDConfig, OptimizerConfig
from repro_torch.configs.pollutant_mlp import PAPER_SIZES
from repro_torch.core.accelerator import DMDAccelerator
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.data.synthetic import synthetic_regression
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.mlp_net import init_mlp, mse_loss
from repro_torch.optim.optimizers import apply_updates, make_optimizer
from repro_torch.train.step import reset_opt_state_after_jump


class TrainResult(NamedTuple):
    params: Any
    acc: DMDAccelerator
    buffers: Any                 # {bucket: (n_blocks, m, block_n)} or None
    grams: Any                   # {bucket: (n_sys, m, m)} or None
    losses: np.ndarray           # (steps,) loss before each step's update
    jumps: List[float]           # loss after / before, per jump
    reverted: List[int]          # steps whose jump the guard reverted


def value_and_grad(params, X, Y):
    """(loss, grads) of the MSE at `params`; grads share the params' tree."""
    p = map_with_paths(lambda _, x: x.detach().requires_grad_(True), params)
    loss = mse_loss(p, X, Y)
    leaves = leaves_with_paths(p)
    grads = torch.autograd.grad(loss, [x for _, x in leaves])
    by = {path: g for (path, _), g in zip(leaves, grads)}
    return loss.detach(), map_with_paths(lambda path, _: by[path], params)


LR = 1e-3                        # the paper's Adam learning rate


def train(X, Y, sizes, dmd_cfg: DMDConfig, steps: int, *, seed: int = 0,
          params=None, device="cuda") -> TrainResult:
    """Train the MLP `sizes` on (X, Y) for `steps` Adam steps with DMD
    jumps. `params` (the reference's layout, e.g. from
    ``convert.params_from_jax``) overrides the seeded Xavier init."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    Y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = init_mlp(gen, sizes, device=dev)
    else:
        params = map_with_paths(lambda _, x: x.to(dev), params)
    opt = make_optimizer(OptimizerConfig(name="adam", lr=LR))
    state = opt.init(params)
    acc = DMDAccelerator(dmd_cfg, device=dev)
    bufs = acc.init(params)
    grams = acc.init_grams(bufs)

    losses, jumps, reverted = [], [], []
    for t in range(steps):
        loss, g = value_and_grad(params, X, Y)
        with torch.no_grad():
            u, state = opt.update(g, state, params, t)
            params = apply_updates(params, u)
        losses.append(loss)
        if acc.should_record(t):
            bufs, grams = acc.record(bufs, params, acc.slots(t), grams)
        if acc.should_apply(t):
            with torch.no_grad():
                before = float(mse_loss(params, X, Y))
                new_params, _ = acc.apply(params, bufs, grams=grams, step=t)
                after = float(mse_loss(new_params, X, Y))
            jumps.append(after / max(before, 1e-30))
            if after > before:
                reverted.append(t)        # keep the pre-jump params
            else:
                params = new_params
                reset = acc.reset_groups(acc.apply_groups(t))
                if reset:
                    state = reset_opt_state_after_jump(
                        opt, state, params, acc.plans_for(params), reset,
                        acc.n_groups)
    loss_hist = (torch.stack(losses).cpu().numpy() if losses
                 else np.zeros(0, np.float32))
    return TrainResult(params, acc, bufs, grams, loss_hist, jumps, reverted)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-streaming", action="store_true",
                    help="recompute the Gram at every jump")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    X, Y = synthetic_regression(seed=args.seed, n=args.rows,
                                n_out=PAPER_SIZES[-1])
    cfg = dataclasses.replace(DMDConfig(),
                              streaming_gram=not args.no_streaming)
    t0 = time.perf_counter()
    res = train(X, Y, PAPER_SIZES, cfg, args.steps, seed=args.seed,
                device=args.device)
    wall = time.perf_counter() - t0
    print(f"{args.steps} steps in {wall:.3f} s on {args.device}: loss "
          f"{res.losses[0]:.6e} -> {res.losses[-1]:.6e}, "
          f"{len(res.jumps)} jumps, {len(res.reverted)} reverted")
    for r in res.jumps:
        print(f"  jump loss ratio {r:.4f}")


if __name__ == "__main__":
    main()
