"""The paper's experiment end to end: the pollutant-dispersion surrogate.

    python -m repro_torch.launch.pollutant_regression [--samples 300]
        [--epochs 1200] [--points 2670] [--grid 64 32] [--full]
        [--staggered] [--device cuda]

1. Generates the dataset (``data/pollutant.py``): Blasius shooting and
   velocity fields on the host, the advection-diffusion-reaction march on
   the device, LHS samples of the 6 parameters, c3 at `--points` probes.
2. Splits it 80/20 (seed 2) and trains the paper's softsign MLP
   (6-40-200-1000-points) with Adam through ``train/paper_loop.py``: once
   without DMD, then with DMD (m=14, s=55, tol=1e-4, warmup 100, cooldown
   10; ``--staggered``: the matrices on m=14, the biases on m=6 windows
   shifted by 7), each jump guarded by the training loss. As in the
   reference's ``examples/pollutant_regression.py``, no Gram is carried:
   every jump recomputes it from the ring buffer (kernel K3).
3. Prints the train and test MSE every 200 epochs and a summary: both final
   MSEs, their ratios, the per-jump loss ratios.

``--full`` is the paper's own run at its scale: 1000 samples, 3000
epochs, the 96 x 48 grid, and the paper's DMD (eig mode, tol 1e-10,
unanchored, no affine term, no trust region, warmup 28, no cooldown, the
optimizer moments kept across jumps), guarded as above. It runs in fp32,
as the reference's does: its ``jax_enable_x64`` widens nothing there (the
params, the moments, the arena and the data stay float32, and its host
eig returns complex64). Without ``--device cpu`` it needs a card and
raises otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.base import DMDConfig
from repro_torch.core.schedule import DMDGroupRule
from repro_torch.data import pollutant
from repro_torch.train import paper_loop


def full_dmd_config() -> DMDConfig:
    """The paper's DMD as ``--full`` runs it: plain (unanchored) classic
    DMD by eigendecomposition, tol 1e-10, no guards of its own."""
    return DMDConfig(m=14, s=55, tol=1e-10, warmup_steps=28,
                     cooldown_steps=0, anchor="none", affine=False,
                     trust_region=0.0, mode="eig", reset_opt_state=False)


def run(Xtr, Ytr, Xte, Yte, sizes, cfg, epochs, device):
    """One paper-loop run on the reference example's route (no carried
    Gram) with its curve printed; the TrainResult."""
    res = paper_loop.train(Xtr, Ytr, sizes,
                           dataclasses.replace(cfg, streaming_gram=False),
                           epochs, test=(Xte, Yte), device=device)
    for t, tr, te in res.curve:
        print(f"  epoch {t:5d}: train {tr:.5e}  test {te:.5e}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=1200)
    ap.add_argument("--points", type=int, default=2670)
    ap.add_argument("--grid", type=int, nargs=2, default=(64, 32))
    ap.add_argument("--full", action="store_true",
                    help="paper-exact: 1000 samples, 3000 epochs, 96 x 48, "
                         "eig-mode DMD at tol 1e-10 (fp32)")
    ap.add_argument("--staggered", action="store_true",
                    help="per-leaf schedule: matrices m=14/phase 0, "
                         "biases m=6/phase 7 (staggered asynchronous jumps)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.full:
        args.samples, args.epochs, args.grid = 1000, 3000, (96, 48)

    print(f"generating dataset: {args.samples} PDE solves on "
          f"{args.grid[0]}x{args.grid[1]} grid ...")
    t0 = time.perf_counter()
    data = pollutant.generate_dataset(
        n_samples=args.samples, nx=args.grid[0], ny=args.grid[1],
        n_points=args.points, seed=0, verbose=True, device=args.device)
    (Xtr, Ytr), (Xte, Yte) = pollutant.train_test_split(data, 0.8)
    print(f"dataset ready in {time.perf_counter() - t0:.1f}s: "
          f"train {Xtr.shape} -> {Ytr.shape}, test {Xte.shape}")
    sizes = (6, 40, 200, 1000, args.points)
    dmd_cfg = full_dmd_config() if args.full else DMDConfig(
        m=14, s=55, tol=1e-4, warmup_steps=100, cooldown_steps=10)
    if args.staggered:
        # matrices keep the paper's m=14 window; biases get short m=6
        # windows phase-shifted by 7 with a cooldown matching the cycles
        # and no moment reset: the two groups never jump on the same step
        dmd_cfg = dataclasses.replace(
            dmd_cfg, cooldown_steps=0,
            groups=(DMDGroupRule(name="biases", max_ndim=1, m=6, phase=7,
                                 cooldown_steps=8, s=24, reset_opt=False),))

    print("\n=== baseline (plain Adam) ===")
    base = run(Xtr, Ytr, Xte, Yte, sizes, DMDConfig(enabled=False),
               args.epochs, args.device)
    label = "staggered two-group" if args.staggered else "m=14, s=55"
    print(f"\n=== DMD-accelerated ({label}) ===")
    dmd = run(Xtr, Ytr, Xte, Yte, sizes, dmd_cfg, args.epochs, args.device)

    (_, tr_b, te_b), (_, tr_d, te_d) = base.curve[-1], dmd.curve[-1]
    print("\n=== summary (paper Fig. 4 analogue) ===")
    print(f"final train MSE: baseline {tr_b:.5e}  dmd {tr_d:.5e}  ratio "
          f"{tr_b / tr_d:.1f}x")
    print(f"final test  MSE: baseline {te_b:.5e}  dmd {te_d:.5e}  ratio "
          f"{te_b / te_d:.1f}x")
    if dmd.jumps:
        acc_n = sum(1 for j in dmd.jumps if j < 1.0)
        print(f"mean relative improvement per DMD application: "
              f"{np.mean(dmd.jumps):.3f} (median {np.median(dmd.jumps):.3f})"
              f" over {len(dmd.jumps)} jumps; accepted {acc_n} (paper Fig. 3 "
              "metric)")


if __name__ == "__main__":
    main()
