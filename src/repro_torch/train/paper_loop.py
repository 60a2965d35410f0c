"""The paper's experiment loop: Adam on the softsign MLP with DMD jumps.

    python -m repro_torch.train.paper_loop [--steps 300] [--rows 1000]
        [--data teacher|pollutant] [--no-streaming] [--no-arena]
        [--device cuda]

Each step takes an Adam step; on recorded steps the params go into the
arena ring buffer and one streaming Gram row is refreshed (kernel K1);
when a window closes the accelerator jumps (coefficient solve, kernel K2)
and the optimizer moments of the jumped groups reset. A jump that raises
the training loss is reverted (the guard; ``guard=False`` keeps every
jump). With ``streaming_gram=False`` (the route of the reference's
example and benchmark loops, which record and jump without Grams), no
Gram is carried and each jump recomputes it (kernel K3). With
``arena=False`` (``--no-arena``) every leaf keeps its own ring buffer and
the same steps run once per leaf through the flat kernels: K4 for the
Gram row, K5 for the combine and K6 for the recompute.

Data: the numpy-seeded teacher of ``data/synthetic.py`` at the paper's
output width (``--data teacher``, the default), or the paper's own
dataset (``--data pollutant``: ``data/pollutant.py`` at 96 x 48 with 2670
probes, ``--rows`` samples, its march on the same device).
``launch/pollutant_regression.py`` runs the paper's experiment on the
latter with a held-out test split.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DMDConfig, OptimizerConfig
from repro_torch.configs.pollutant_mlp import PAPER_SIZES
from repro_torch.core.accelerator import DMDAccelerator
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.data import pollutant
from repro_torch.data.synthetic import synthetic_regression
from repro_torch.kernels.device import resolve_device
from repro_torch.models.mlp_net import init_mlp, mse_loss
from repro_torch.optim.optimizers import apply_updates, make_optimizer
from repro_torch.train.step import reset_opt_state_after_jump


class TrainResult(NamedTuple):
    params: Any
    acc: DMDAccelerator
    buffers: Any                 # the accelerator's snapshot state, or None
    grams: Any                   # its streaming Grams, or None
    losses: np.ndarray           # (steps,) loss before each step's update
    jumps: List[float]           # loss after / before, per jump
    reverted: List[int]          # steps whose jump the guard reverted
    # (step, train MSE, test MSE) after every `log_every`-th step and the
    # last, when a test split was given
    curve: List[Tuple[int, float, float]]


def value_and_grad(params, X, Y):
    """(loss, grads) of the MSE at `params`; grads share the params' tree."""
    p = map_with_paths(lambda _, x: x.detach().requires_grad_(True), params)
    loss = mse_loss(p, X, Y)
    leaves = leaves_with_paths(p)
    grads = torch.autograd.grad(loss, [x for _, x in leaves])
    by = {path: g for (path, _), g in zip(leaves, grads)}
    return loss.detach(), map_with_paths(lambda path, _: by[path], params)


LR = 1e-3                        # the paper's Adam learning rate
LOG_EVERY = 200                  # the launcher's steps between two test MSEs


def train(X, Y, sizes, dmd_cfg: DMDConfig, steps: int, *, seed: int = 0,
          params=None, test=None, log_every: int = LOG_EVERY,
          guard: bool = True, device="cuda") -> TrainResult:
    """Train the MLP `sizes` on (X, Y) for `steps` Adam steps with DMD
    jumps. `params` (the reference's layout, e.g. from
    ``convert.params_from_jax``) overrides the seeded Xavier init. With a
    `test` split (Xte, Yte), the train and test MSE of the params after
    every `log_every`-th step and the last go into ``curve``.
    ``guard=False`` keeps every jump, also one that raises the training
    loss."""
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    X, Y = put(X), put(Y)
    if test is not None:
        Xte, Yte = map(put, test)
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

    losses, jumps, reverted, curve = [], [], [], []
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
            if guard and after > before:
                reverted.append(t)        # keep the pre-jump params
            else:
                params = new_params
                reset = acc.reset_groups(acc.apply_groups(t))
                if reset:
                    state = reset_opt_state_after_jump(
                        opt, state, params, acc.plans_for(params), reset,
                        acc.n_groups)
        if test is not None and (t % log_every == 0 or t == steps - 1):
            with torch.no_grad():
                curve.append((t, float(mse_loss(params, X, Y)),
                              float(mse_loss(params, Xte, Yte))))
    loss_hist = (torch.stack(losses).cpu().numpy() if losses
                 else np.zeros(0, np.float32))
    return TrainResult(params, acc, bufs, grams, loss_hist, jumps, reverted,
                       curve)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", choices=("teacher", "pollutant"),
                    default="teacher",
                    help="the numpy teacher, or the paper's PDE dataset "
                         "(--rows samples)")
    ap.add_argument("--no-streaming", action="store_true",
                    help="recompute the Gram at every jump")
    ap.add_argument("--no-arena", action="store_true",
                    help="per-leaf ring buffers instead of packed arenas")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.data == "pollutant":
        data = pollutant.generate_dataset(
            n_samples=args.rows, n_points=PAPER_SIZES[-1], seed=args.seed,
            verbose=True, device=args.device)
        X, Y = data["X"], data["Y"]
    else:
        X, Y = synthetic_regression(seed=args.seed, n=args.rows,
                                    n_out=PAPER_SIZES[-1])
    cfg = dataclasses.replace(DMDConfig(),
                              streaming_gram=not args.no_streaming,
                              arena=not args.no_arena)
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
