"""Train the paper MLP at full width through the port's Trainer.

    python -m repro_torch.launch.train_mlp [--steps 300] [--rows 1000]
        [--gated] [--no-arena] [--eager] [--ckpt DIR] [--device cuda]

The numpy teacher's rows (``data/synthetic.py``), Adam 1e-3, the default
DMDConfig; ``--gated`` runs fig4's validation-gated controller (shrink
ladder 0.5, 0.25; meta-tuning at meta_lr 0.05) on a disjoint 150-row fold
of the same teacher; ``--eager`` turns the CUDA graphs off. ``--ckpt DIR``
checkpoints every 50 steps into DIR, and SIGTERM saves after the current
step and exits; a rerun with the same ``--ckpt`` resumes from the newest
checkpoint, bit-exactly. Without ``--device cpu`` it needs a card and
raises otherwise.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs.base import (ArchConfig, DMDConfig,
                                      DMDControllerConfig, ModelConfig,
                                      OptimizerConfig, TrainConfig)
from repro_torch.configs.pollutant_mlp import PAPER_SIZES
from repro_torch.core import controller as ctrl_mod
from repro_torch.data.synthetic import synthetic_regression
from repro_torch.models.mlp_net import MLPModel, mse_loss
from repro_torch.train import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--gated", action="store_true",
                    help="fig4's validation-gated controller")
    ap.add_argument("--no-arena", action="store_true")
    ap.add_argument("--eager", action="store_true",
                    help="no CUDA graphs on a CUDA device")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (every 50 steps; resumes "
                         "from the newest)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    val_rows = 150 if args.gated else 0
    X, Y = synthetic_regression(seed=0, n=args.rows + val_rows,
                                n_out=PAPER_SIZES[-1])
    ctrl = (DMDControllerConfig(enabled=True, eval_rows=0, val_gate=True,
                                shrink_levels=(0.5, 0.25), meta_lr=0.05)
            if args.gated else DMDControllerConfig())
    acfg = ArchConfig(
        model=ModelConfig(name="pollutant-mlp", family="mlp"),
        dmd=DMDConfig(arena=not args.no_arena, controller=ctrl),
        optimizer=OptimizerConfig(name="adam", lr=1e-3),
        train=TrainConfig(global_batch=args.rows, seq_len=1,
                          checkpoint_every=50 if args.ckpt else 0,
                          checkpoint_dir=args.ckpt), shapes=())
    start = (latest_step(args.ckpt) or 0) if args.ckpt else 0
    trainer = Trainer(MLPModel(PAPER_SIZES), acfg, device=args.device,
                      cuda_graphs=not args.eager,
                      val_batch=({"x": X[args.rows:], "y": Y[args.rows:]}
                                 if args.gated else None))
    batch = trainer._to_device({"x": X[:args.rows], "y": Y[:args.rows]})
    outcomes = []
    t0 = time.perf_counter()
    state = trainer.fit(iter(lambda: batch, None), args.steps,
                        on_metrics=lambda t, m: outcomes.append(
                            m["ctrl_outcome"]) if "ctrl_outcome" in m
                        else None)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = float(mse_loss(state.params, batch["x"], batch["y"]))
    done = int(state.step) - start
    print(f"steps {start} to {int(state.step)} in {wall:.3f} s on "
          f"{trainer.device} ({wall / max(done, 1) * 1e3:.3f} ms/step), "
          f"train MSE {loss:.6e}, graphs {trainer.graph_stats}")
    if args.gated:
        print(f"gate outcomes (0 reject, 1 scaled, 2 accept): {outcomes}")
        print(ctrl_mod.summary(state.controller, trainer.acc.groups))


if __name__ == "__main__":
    main()
