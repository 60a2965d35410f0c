"""Run the port's paper benches and write one ``BENCH_torch_<suite>.json``
per suite.

    python -m repro_torch.benchmarks.run [--quick] [--out DIR]
        [--device cuda]

Prints each suite's CSV rows and writes, per suite, its rows with the
wall time, the backend, the device count and the card (``nvidia-smi``'s
name and power limit; null on the CPU). ``--quick`` is the reference's
quick mode (``benchmarks/run.py``): smaller grids and widths where it
has them. Without ``--device cpu`` it needs a card and raises otherwise.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.benchmarks import paper_benches as pb
from repro_torch.kernels.device import resolve_device


def suites(quick: bool, device: str) -> list:
    """(suite name, its rows' thunk), at the reference's sizes or its
    ``--quick`` ones."""
    kw = {"device": device}
    return [
        ("sec3_overhead", lambda: pb.sec3_overhead(**kw)),
        ("streaming_gram", lambda: pb.streaming_gram(
            n=1_000_000 if quick else 4_000_000, **kw)),
        ("staggered_jump", lambda: pb.staggered_jump(
            **(dict(sizes=(6, 400, 400, 400), reps=5) if quick else {}),
            **kw)),
        ("controller", lambda: pb.controller(
            **(dict(steps=300, sizes=(6, 40, 80, 200)) if quick else {}),
            **kw)),
        ("fig3", lambda: pb.fig3_sensitivity(
            **(dict(ms=(6, 14), ss=(10, 55), steps=300) if quick else {}),
            **kw)),
        ("fig4", lambda: pb.fig4_curves(
            **(dict(steps=300) if quick else {}), **kw)),
    ]


def losing_rows(rows: list) -> list:
    """Rows that report a losing direction: a suite marks a metric that
    regressed against its baseline with an explicit ``_LOSES`` token."""
    return [r for r in rows if "_LOSES" in r]


def card(dev: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, None on the
    CPU."""
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def write_suite(out_dir: Path, suite: str, rows: list, wall_s: float,
                quick: bool, dev: torch.device) -> Path:
    path = out_dir / f"BENCH_torch_{suite}.json"
    path.write_text(json.dumps({
        "suite": suite,
        "rows": rows,
        "wall_s": round(wall_s, 2),
        "quick": quick,
        "backend": dev.type,
        "n_devices": torch.cuda.device_count(),
        "card": card(dev),
    }, indent=1))
    print(f"# wrote {path}")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=".",
                    help="directory for the BENCH_torch_<suite>.json files")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t_total = time.perf_counter()
    all_rows = []
    for suite, fn in suites(args.quick, args.device):
        t0 = time.perf_counter()
        rows = fn()
        write_suite(out_dir, suite, rows, time.perf_counter() - t0,
                    args.quick, dev)
        for r in losing_rows(rows):
            print(f"# LOSING DIRECTION [{suite}]: {r}")
        all_rows += rows
    print("\n".join(all_rows))
    losers = losing_rows(all_rows)
    if losers:
        print(f"\n# {len(losers)} metric(s) in a LOSING direction — "
              "see rows above")
    print(f"\n# total bench wall: {time.perf_counter() - t_total:.0f}s")


if __name__ == "__main__":
    main()
