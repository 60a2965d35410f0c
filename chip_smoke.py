#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero (nothing is caught):

1. The card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions.
2. Build the CUDA kernels (``src/repro_torch/kernels/csrc/arena.cu``).
3. Each kernel against its plain PyTorch twin at the paper MLP's arena
   shape, (5633, 14, 512), with the paper bucket's real block -> system
   table: fp32 and bf16 buffers, both anchors of the Gram row, first and
   mean anchor of the Gram, bit-identical repeat launches; then timings of
   the kernel, the twin and (where one PyTorch call computes the same
   function) that call, beside the least time the card could take.
4. The main path: ``paper_loop.train`` for 300 steps at the paper's full
   width (2,882,150 params), default DMDConfig, 1000 teacher rows. It must
   launch the Gram-row kernel 112 times and the combine kernel 8 times,
   and its loss must be finite and falling. At step 123 (the first
   complete window) the carried streaming Gram must match the Gram
   kernel's full recompute of the ring buffer.
5. The non-streaming path (``streaming_gram=False``) for 150 steps: 2 Gram
   and 2 combine launches, no Gram-row launch.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import DMDConfig  # noqa: E402
from repro_torch.configs.pollutant_mlp import PAPER_SIZES  # noqa: E402
from repro_torch.core.accelerator import DMDAccelerator  # noqa: E402
from repro_torch.data.synthetic import synthetic_regression  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import arena as ka  # noqa: E402
from repro_torch.models.mlp_net import init_mlp  # noqa: E402
from repro_torch.train import paper_loop  # noqa: E402

# H100 SXM data sheet (the least-time bound): HBM3 bytes/s, fp32 flop/s
# outside the tensor cores (the kernels are IEEE fp32, no TF32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SRC = "src/repro_torch/kernels/csrc/arena.cu"
STEPS, ROWS = 300, 1000
# tolerance of a kernel against its twin on random data: fp32 sums over
# up to 5215 blocks x 512 lanes in two different orders. It is relative to
# each system's own largest entry (each block's, for the combine), so a
# fault in a one-block system is not hidden by the 5215-block one.
RTOL = 1e-5


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want):
    return float((got - want).abs().max())


def check_close(name, got, want, rows):
    """|got - want| <= RTOL * max(1, max |want|) within each of `rows`
    leading rows (one per system, or one per block); returns the largest
    error."""
    diff = (got - want).abs().reshape(rows, -1).amax(dim=1)
    limit = RTOL * want.abs().reshape(rows, -1).amax(dim=1).clamp_min(1.0)
    bad = torch.nonzero(diff > limit).flatten().tolist()
    require(not bad, f"{name}: rows {bad[:8]}: max |kernel - twin| "
            f"{diff[bad[:8]].tolist()} > {limit[bad[:8]].tolist()}")
    return float(diff.max())


def check_kernels(dev):
    """Phase 3. Returns {kernel: record} for the fp32 main-path buffer."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = init_mlp(gen, PAPER_SIZES, device=dev)
    (bucket,) = DMDAccelerator(DMDConfig(), device=dev).arena_for(
        params).values()
    seg = bucket.tables_on(dev)
    nb, m, bn = bucket.n_blocks, bucket.m, bucket.block_n
    require((nb, m, bn) == (5633, 14, 512), f"paper bucket {(nb, m, bn)}")
    x32 = torch.randn((nb, m, bn), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    c = torch.randn((seg.n_sys, m), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    slot = m - 1
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        q = x[:, slot, :]
        tag = str(dtype).removeprefix("torch.")
        errs = {"gram_row": 0.0, "gram": 0.0, "combine": 0.0}
        for anchor_first in (False, True):
            got = ka.gram_row(x, q, seg, anchor_first=anchor_first)
            want = ka.gram_row_ref(x, q, seg.block_sys, seg.n_sys,
                                   anchor_first=anchor_first)
            errs["gram_row"] = max(errs["gram_row"], check_close(
                f"gram_row {tag} anchor_first={anchor_first}", got, want,
                seg.n_sys))
            again = ka.gram_row(x, q, seg, anchor_first=anchor_first)
            require(torch.equal(got, again), f"gram_row {tag} not repeatable")
        for anchor in ({"anchor_first": True}, {"anchor_mean": True}):
            got = ka.gram(x, seg, **anchor)
            want = ka.gram_ref(x, seg.block_sys, seg.n_sys, **anchor)
            errs["gram"] = max(errs["gram"], check_close(
                f"gram {tag} {anchor}", got, want, seg.n_sys))
            require(torch.equal(got, ka.gram(x, seg, **anchor)),
                    f"gram {tag} not repeatable")
        got = ka.combine(x, c, seg)
        want = ka.combine_ref(x, c, seg.block_sys)
        errs["combine"] = check_close(f"combine {tag}", got, want, nb)
        require(torch.equal(got, ka.combine(x, c, seg)),
                f"combine {tag} not repeatable")
        torch.cuda.synchronize()

        xbytes = x.numel() * x.element_size()
        cb = c[seg.block_sys.long()]
        runs = {
            # q is a slot of x: the unique bytes read are x's
            "gram_row": (
                lambda: ka.gram_row(x, q, seg, anchor_first=True),
                lambda: ka.gram_row_ref(x, q, seg.block_sys, seg.n_sys,
                                        anchor_first=True),
                None, xbytes + seg.n_sys * m * 4, 2.0 * nb * m * bn),
            "combine": (
                lambda: ka.combine(x, c, seg),
                lambda: ka.combine_ref(x, c, seg.block_sys),
                ((lambda: torch.einsum("im,imb->ib", cb, x))
                 if dtype == torch.float32 else None),
                xbytes + nb * bn * 4 + c.numel() * 4 + nb * 4,
                2.0 * nb * m * bn),
            "gram": (
                lambda: ka.gram(x, seg, anchor_first=True),
                lambda: ka.gram_ref(x, seg.block_sys, seg.n_sys,
                                    anchor_first=True),
                None, xbytes + seg.n_sys * m * m * 4, 2.0 * nb * m * m * bn),
        }
        for name, (kern, twin, lib, nbytes, flops) in runs.items():
            k_ms, p_ms = cuda_ms(kern), cuda_ms(twin)
            l_ms = cuda_ms(lib) if lib is not None else None
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"kernel {name} {tag}: kernel_ms {k_ms} ref_ms {p_ms} "
                  f"bound_ms {b_ms} ({b_by}) library_ms {l_ms} "
                  f"max_abs_err {errs[name]} GB/s {nbytes / k_ms / 1e6}")
            if dtype == torch.float32:
                records[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=l_ms,
                                     max_abs_err=errs[name])
    return records


def run_main_path(dev, X, Y):
    """Phase 4: the streaming main path, counted."""
    cfg = DMDConfig()
    torch.cuda.synchronize()
    ka.reset_launches()
    t0 = time.perf_counter()
    res = paper_loop.train(X, Y, PAPER_SIZES, cfg, STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ka.LAUNCHES)
    print(f"main path: {STEPS} steps in {wall} s, ms/step "
          f"{wall / STEPS * 1e3}, launches {launches}, jumps "
          f"{len(res.jumps)}, reverted {res.reverted}")
    require(launches["gram_row"] == 112, f"gram_row launches {launches}")
    require(launches["combine"] == 8, f"combine launches {launches}")
    require(launches["gram"] == 0, f"gram launches {launches}")
    loss = res.losses
    require(np.isfinite(loss).all(), "non-finite loss")
    require(loss[-1] < loss[0], f"loss did not fall: {loss[0]} -> {loss[-1]}")
    print(f"main path loss {loss[0]} -> {loss[-1]}; jump ratios "
          f"{res.jumps}")

    # record / jump time on the final state (outside the counted run)
    acc, bufs, grams = res.acc, res.buffers, res.grams
    t_rec = 291                          # a recorded step (slot 13)
    rec_ms = cuda_ms(lambda: acc.record(bufs, res.params, acc.slots(t_rec),
                                        grams), iters=20)
    t0 = time.perf_counter()
    for _ in range(5):
        acc.apply(res.params, bufs, grams=grams, step=t_rec)
    torch.cuda.synchronize()
    jump_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"record ms {rec_ms} (device, CUDA events); jump ms {jump_ms} "
          f"(host clock, synchronised)")
    return launches


def check_window_gram(dev, X, Y):
    """Step 123 closes the first window: the carried Gram must equal the
    full recompute of the buffer (DESIGN.md §2.2), to fp32 summation order
    over 2.9M lanes: |diff| <= 1e-4 * max|G|."""
    res = paper_loop.train(X, Y, PAPER_SIZES, DMDConfig(), 124, device=dev)
    require(res.acc.slot(123) == 13, "step 123 is not slot m-1")
    for key, b in res.acc.arena_for(res.params).items():
        full = ka.gram(res.buffers[key], b.tables_on(res.buffers[key].device),
                       anchor_first=True)
        carried = res.grams[key]
        err = max_err(carried, full)
        scale = float(full.abs().max())
        print(f"step 123 Gram {key}: max |carried - recomputed| {err}, "
              f"max |G| {scale}")
        require(scale > 0 and err <= 1e-4 * scale,
                f"streaming Gram off by {err} (scale {scale})")


def run_recompute_path(dev, X, Y):
    """Phase 5: the non-streaming path, counted."""
    cfg = dataclasses.replace(DMDConfig(), streaming_gram=False)
    torch.cuda.synchronize()
    ka.reset_launches()
    res = paper_loop.train(X, Y, PAPER_SIZES, cfg, 150, device=dev)
    torch.cuda.synchronize()
    launches = dict(ka.LAUNCHES)
    print(f"recompute path: 150 steps, launches {launches}, loss "
          f"{res.losses[0]} -> {res.losses[-1]}")
    require(launches == {"gram_row": 0, "gram": 2, "combine": 2},
            f"recompute path launches {launches}")
    require(np.isfinite(res.losses).all(), "non-finite loss (recompute)")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0} s")

    records = check_kernels(dev)

    X, Y = synthetic_regression(seed=0, n=ROWS, n_out=PAPER_SIZES[-1])
    main_launches = run_main_path(dev, X, Y)
    check_window_gram(dev, X, Y)
    rec_launches = run_recompute_path(dev, X, Y)

    replaces = {"gram_row": "src/repro/kernels/arena.py:206",
                "combine": "src/repro/kernels/arena.py:294",
                "gram": "src/repro/kernels/arena.py:258"}
    launches = {"gram_row": main_launches["gram_row"],
                "combine": main_launches["combine"],
                "gram": rec_launches["gram"]}
    kernels = [dict(name=name, route="cuda", source=SRC,
                    replaces=replaces[name], launches=launches[name],
                    **records[name])
               for name in ("gram_row", "combine", "gram")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
