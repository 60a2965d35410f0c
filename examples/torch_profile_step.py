"""Where a step of the port's paper loop spends its time, on a CUDA card.

    PYTHONPATH=src python examples/torch_profile_step.py [--steps 300]
        [--no-arena]

Runs ``repro_torch.train.paper_loop.train`` at the paper's full width
three times: a short warm-up (kernel build, cuBLAS start-up), one timed
run (host clock, synchronised) and one under ``torch.profiler``. Prints
ms per step, the device's busy share of the profiled wall (summed kernel
time over wall: one stream, so kernels do not overlap) and the kernels
that take the most device time. ``--no-arena`` profiles the per-leaf
route (``DMDConfig(arena=False)``) instead of the packed arenas.
"""
import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.base import DMDConfig  # noqa: E402
from repro_torch.configs.pollutant_mlp import PAPER_SIZES  # noqa: E402
from repro_torch.data.synthetic import synthetic_regression  # noqa: E402
from repro_torch.train.paper_loop import train  # noqa: E402


def device_us(evt) -> float:
    """Device time of a KERNEL row; 0 for the CPU-op rows, which repeat
    their kernels' time and would count it twice."""
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total",
                 "device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--no-arena", action="store_true")
    args = ap.parse_args()
    X, Y = synthetic_regression(seed=0, n=args.rows, n_out=PAPER_SIZES[-1])
    cfg = dataclasses.replace(DMDConfig(), arena=not args.no_arena)
    train(X, Y, PAPER_SIZES, cfg, 20, device="cuda")
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    train(X, Y, PAPER_SIZES, cfg, args.steps, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"{torch.cuda.get_device_name(0)} arena={cfg.arena}: {args.steps} "
          f"steps in {wall} s, ms/step {wall / args.steps * 1e3}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(X, Y, PAPER_SIZES, cfg, args.steps, device="cuda")
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    rows = [(device_us(e), e.count, e.key) for e in prof.key_averages()]
    ours = sum(r[0] for r in rows
               if any(k in r[2] for k in ("row_part", "arena_row",
                                          "arena_gram_k", "gram_flat",
                                          "combine<", "combine_flat<")))
    rows = [r for r in rows if r[0] > 0]
    busy_us = sum(r[0] for r in rows)
    print(f"profiled: wall {pwall} s, device kernel time {busy_us / 1e6} s, "
          f"busy share {busy_us / 1e6 / pwall}, idle share "
          f"{1 - busy_us / 1e6 / pwall}; kernel time over the unprofiled "
          f"wall {busy_us / 1e6 / wall}; the port's own CUDA kernels "
          f"{ours / 1e6} s ({ours / max(busy_us, 1e-9)} of kernel time)")
    if not rows:
        print("no device time in the trace")
        return
    print("top kernels by device time (us total, launches, share, name):")
    for us, count, key in sorted(rows, reverse=True)[:args.top]:
        print(f"  {us:12.1f} {count:6d} {us / busy_us:7.3f}  {key[:90]}")


if __name__ == "__main__":
    main()
