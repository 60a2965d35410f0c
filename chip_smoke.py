#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero (nothing is caught):

1. The card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions.
2. Build the CUDA kernels (``src/repro_torch/kernels/csrc/*.cu``, one
   ``nvcc`` per source, in parallel).
3. The arena kernels K1-K3 against their plain PyTorch twins at the paper
   MLP's arena shape, (5633, 14, 512), with the paper bucket's real block
   -> system table: fp32 and bf16 buffers, both anchors of the Gram row,
   first and mean anchor of the Gram, bit-identical repeat launches; then
   timings of the kernel, the twin and (where one PyTorch call computes
   the same function) that call, beside the least time the card could
   take.
3b. The flat per-leaf kernels K4-K6 against their twins at the 8 paper
   leaves' buffers (14, n) and one stacked (14, 4, 131072) buffer: fp32
   and bf16, with and without the anchor, per-system tolerance, repeat
   launches bit-identical, integer-valued data exact; timings at the
   largest leaf, /l3/w (14, 2670000).
4. The main path: ``paper_loop.train`` for 300 steps at the paper's full
   width (2,882,150 params), default DMDConfig, 1000 teacher rows. It must
   launch the Gram-row kernel 112 times and the combine kernel 8 times,
   and its loss must be finite and falling. At step 123 (the first
   complete window) the carried streaming Gram must match the Gram
   kernel's full recompute of the ring buffer.
5. The non-streaming path (``streaming_gram=False``) for 150 steps: 2 Gram
   and 2 combine launches, no Gram-row launch.
6. The per-leaf path (``arena=False``) for 300 steps: K4 896 launches (112
   records x 8 leaves), K5 64 (8 jumps x 8 leaves), no other kernel; loss
   finite and falling. At step 123 each leaf's carried Gram must match
   K6's recompute of its buffer and the arena route's Gram of the same
   system.
7. The per-leaf recompute path (``arena=False, streaming_gram=False``) for
   150 steps: K6 and K5 16 launches each, no K4.

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
from repro_torch.core.paths import leaves_with_paths  # noqa: E402
from repro_torch.data.synthetic import synthetic_regression  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import arena as ka  # noqa: E402
from repro_torch.kernels import combine as kc  # noqa: E402
from repro_torch.kernels import gram as kg  # noqa: E402
from repro_torch.kernels import gram_row as kgr  # noqa: E402
from repro_torch.models.mlp_net import init_mlp  # noqa: E402
from repro_torch.train import paper_loop  # noqa: E402

# H100 SXM data sheet (the least-time bound): HBM3 bytes/s, fp32 flop/s
# outside the tensor cores (the kernels are IEEE fp32, no TF32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SRC = "src/repro_torch/kernels/csrc/arena.cu"
FLAT_SRC = "src/repro_torch/kernels/csrc/flat.cu"
STEPS, ROWS = 300, 1000
# every wrapper's launch counter
COUNTERS = (ka.LAUNCHES, kgr.LAUNCHES, kc.LAUNCHES, kg.LAUNCHES)
# tolerance of a kernel against its twin on random data: fp32 sums over
# up to 5215 blocks x 512 lanes in two different orders. It is relative to
# each system's own largest entry (each block's, for the combine), so a
# fault in a one-block system is not hidden by the 5215-block one.
RTOL = 1e-5


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def reset_counts():
    for counter in COUNTERS:
        for key in counter:
            counter[key] = 0


def counts():
    return {k: v for counter in COUNTERS for k, v in counter.items()}


def require_counts(what, want):
    """Every kernel of `want` launched exactly so often, all others 0."""
    got = counts()
    full = {k: want.get(k, 0) for k in got}
    require(got == full, f"{what}: launches {got}, expected {full}")
    return got


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


def check_flat_kernels(dev):
    """Phase 3b. Returns {kernel: record} for the fp32 /l3/w buffer."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = init_mlp(gen, PAPER_SIZES, device="cpu")
    leaves = {path: x.numel() for path, x in leaves_with_paths(params)}
    m = DMDConfig().m
    shapes = [(m, 1, n) for n in leaves.values()] + [(m, 4, 256 * 512)]
    for i, (m_, n_sys, n) in enumerate(shapes):
        g = torch.Generator(device=dev).manual_seed(10 + i)
        x32 = torch.randn((m_, n_sys, n), generator=g, device=dev)
        c = torch.randn((n_sys, m_), generator=g, device=dev)
        xi = torch.randint(-1, 2, (m_, n_sys, n), generator=g,
                           device=dev).float()
        ci = torch.randint(-4, 5, (n_sys, m_), generator=g,
                           device=dev).float()
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{(m_, n_sys, n)} {str(dtype).removeprefix('torch.')}"
            for x, cc, exact in ((x32.to(dtype), c, False),
                                 (xi.to(dtype), ci, True)):
                _check_flat(tag + (" integer" if exact else ""), x, cc,
                            n_sys, exact)
        torch.cuda.synchronize()
    print(f"flat kernels: {len(shapes)} shapes x fp32/bf16 x random/integer "
          f"match their twins")

    # timings at the largest leaf, /l3/w, as the main path gives it
    n = leaves["/l3/w"]
    g = torch.Generator(device=dev).manual_seed(3)
    x32 = torch.randn((m, 1, n), generator=g, device=dev)
    c32 = torch.randn((1, m), generator=g, device=dev)
    slot = m - 1
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        q = x[slot]
        x2, q1, c1 = x.view(m, n), x[slot].view(n), c32.view(m)
        tag = str(dtype).removeprefix("torch.")
        xbytes = x.numel() * x.element_size()
        fp32 = dtype == torch.float32
        runs = {
            # q is a slot of x: the unique bytes read are x's
            "flat_gram_row": (
                lambda: kgr.gram_row(x, q), lambda: kgr.gram_row_ref(x, q),
                (lambda: torch.mv(x2, q1)) if fp32 else None,
                lambda: kgr.gram_row(x, q, anchor_first=True),
                xbytes + m * 4, 2.0 * m * n),
            "flat_combine": (
                lambda: kc.combine(x, c32), lambda: kc.combine_ref(x, c32),
                (lambda: c1 @ x2) if fp32 else None, None,
                xbytes + n * 4 + m * 4, 2.0 * m * n),
            "flat_gram": (
                lambda: kg.gram(x), lambda: kg.gram_ref(x),
                (lambda: x2 @ x2.T) if fp32 else None,
                lambda: kg.gram(x, anchor_first=True),
                xbytes + m * m * 4, 2.0 * m * m * n),
        }
        errs = {"flat_gram_row": max_err(kgr.gram_row(x, q),
                                         kgr.gram_row_ref(x, q)),
                "flat_combine": max_err(kc.combine(x, c32),
                                        kc.combine_ref(x, c32)),
                "flat_gram": max_err(kg.gram(x), kg.gram_ref(x))}
        for name, (kern, twin, lib, anchored, nbytes, flops) in runs.items():
            k_ms, p_ms = cuda_ms(kern), cuda_ms(twin)
            l_ms = cuda_ms(lib) if lib is not None else None
            a_ms = cuda_ms(anchored) if anchored is not None else None
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"kernel {name} {tag} /l3/w {(m, n)}: kernel_ms {k_ms} "
                  f"anchored_ms {a_ms} ref_ms {p_ms} bound_ms {b_ms} "
                  f"({b_by}) library_ms {l_ms} max_abs_err {errs[name]} "
                  f"GB/s {nbytes / k_ms / 1e6}")
            if fp32:
                records[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=l_ms,
                                     max_abs_err=errs[name])
    return records


def _check_flat(tag, x, c, n_sys, exact):
    """K4-K6 against their twins on one buffer: within RTOL of each
    system's largest entry (exactly, on integer-valued data), repeat
    launches bit-identical, the anchored row of slot 0 exactly zero."""
    def close(name, got, want):
        if exact:
            require(torch.equal(got, want), f"{name} {tag}: integer data "
                    f"not exact, max diff {max_err(got, want)}")
        else:
            check_close(f"{name} {tag}", got, want, n_sys)

    m = x.shape[0]
    for slot in (0, m - 1):
        for anchor_first in (False, True):
            got = kgr.gram_row(x, x[slot], anchor_first=anchor_first)
            close(f"flat_gram_row slot {slot} anchor {anchor_first}", got,
                  kgr.gram_row_ref(x, x[slot], anchor_first=anchor_first))
            require(torch.equal(got, kgr.gram_row(
                x, x[slot], anchor_first=anchor_first)),
                f"flat_gram_row {tag} not repeatable")
            if anchor_first and slot == 0:
                require(not got.any(), f"flat_gram_row {tag}: slot-0 "
                        "anchored row is not zero")
    for anchor_first in (False, True):
        got = kg.gram(x, anchor_first=anchor_first)
        close(f"flat_gram anchor {anchor_first}", got,
              kg.gram_ref(x, anchor_first=anchor_first))
        require(torch.equal(got, kg.gram(x, anchor_first=anchor_first)),
                f"flat_gram {tag} not repeatable")
    got = kc.combine(x, c)
    close("flat_combine", got, kc.combine_ref(x, c))
    require(torch.equal(got, kc.combine(x, c)),
            f"flat_combine {tag} not repeatable")


def run_main_path(dev, X, Y):
    """Phase 4: the streaming main path, counted."""
    return run_streaming(dev, X, Y, "main path", DMDConfig(),
                         {"gram_row": 112, "combine": 8})


def run_streaming(dev, X, Y, what, cfg, want):
    """A streaming path for STEPS steps, counted (the counts set to 0 just
    before it and read just after), then its record and jump times."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = paper_loop.train(X, Y, PAPER_SIZES, cfg, STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = require_counts(what, want)
    print(f"{what}: {STEPS} steps in {wall} s, ms/step "
          f"{wall / STEPS * 1e3}, launches {launches}, jumps "
          f"{len(res.jumps)}, reverted {res.reverted}")
    loss = res.losses
    require(np.isfinite(loss).all(), f"{what}: non-finite loss")
    require(loss[-1] < loss[0],
            f"{what}: loss did not fall: {loss[0]} -> {loss[-1]}")
    print(f"{what} loss {loss[0]} -> {loss[-1]}; jump ratios {res.jumps}")

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
    print(f"{what}: record ms {rec_ms} (device, CUDA events); jump ms "
          f"{jump_ms} (host clock, synchronised)")
    return launches


def _require_gram(what, carried, full):
    """|carried - full| <= 1e-4 * max|full|: fp32 summation order over up
    to 2.9M lanes."""
    err = max_err(carried, full)
    scale = float(full.abs().max())
    print(f"step 123 Gram {what}: max |diff| {err}, max |G| {scale}")
    require(scale > 0 and err <= 1e-4 * scale,
            f"step 123 Gram {what} off by {err} (scale {scale})")


def check_window_gram(dev, X, Y):
    """Step 123 closes the first window: the carried Gram must equal the
    full recompute of the buffer (DESIGN.md §2.2). Returns {leaf path: its
    system's carried arena Gram}."""
    res = paper_loop.train(X, Y, PAPER_SIZES, DMDConfig(), 124, device=dev)
    require(res.acc.slot(123) == 13, "step 123 is not slot m-1")
    arenas, agrams = res.buffers["__arena__"], res.grams["__arena__"]
    by_leaf = {}
    for key, b in res.acc.arena_for(res.params).items():
        full = ka.gram(arenas[key], b.tables_on(arenas[key].device),
                       anchor_first=True)
        _require_gram(f"{key} carried vs K3", agrams[key], full)
        by_leaf.update({seg.path: agrams[key][seg.sys_start]
                        for seg in b.segments})
    return by_leaf


def check_window_gram_per_leaf(dev, X, Y, arena_grams):
    """Phase 6, step 123: each leaf's carried Gram against K6's recompute
    of its buffer and against the arena route's Gram of the same system
    (same init and data: the same trajectory up to the first jump)."""
    cfg = dataclasses.replace(DMDConfig(), arena=False)
    res = paper_loop.train(X, Y, PAPER_SIZES, cfg, 124, device=dev)
    grams = dict(leaves_with_paths(res.grams))
    for path, buf in leaves_with_paths(res.buffers):
        full = kg.gram(buf.view(buf.shape[0], 1, -1), anchor_first=True)[0]
        _require_gram(f"{path} carried vs K6", grams[path], full)
        _require_gram(f"{path} per-leaf vs arena", grams[path],
                      arena_grams[path])


def run_recompute_path(dev, X, Y, what, cfg, want):
    """A non-streaming path for 150 steps, counted."""
    torch.cuda.synchronize()
    reset_counts()
    res = paper_loop.train(X, Y, PAPER_SIZES, cfg, 150, device=dev)
    torch.cuda.synchronize()
    launches = require_counts(what, want)
    print(f"{what}: 150 steps, launches {launches}, loss "
          f"{res.losses[0]} -> {res.losses[-1]}")
    require(np.isfinite(res.losses).all(), f"{what}: non-finite loss")
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
    records.update(check_flat_kernels(dev))

    X, Y = synthetic_regression(seed=0, n=ROWS, n_out=PAPER_SIZES[-1])
    main_launches = run_main_path(dev, X, Y)
    arena_grams = check_window_gram(dev, X, Y)
    rec_launches = run_recompute_path(
        dev, X, Y, "recompute path",
        dataclasses.replace(DMDConfig(), streaming_gram=False),
        {"gram": 2, "combine": 2})
    leaf_launches = run_streaming(
        dev, X, Y, "per-leaf path",
        dataclasses.replace(DMDConfig(), arena=False),
        {"flat_gram_row": 112 * 8, "flat_combine": 8 * 8})
    check_window_gram_per_leaf(dev, X, Y, arena_grams)
    leaf_rec_launches = run_recompute_path(
        dev, X, Y, "per-leaf recompute path",
        dataclasses.replace(DMDConfig(), arena=False, streaming_gram=False),
        {"flat_gram": 2 * 8, "flat_combine": 2 * 8})

    replaces = {"gram_row": "src/repro/kernels/arena.py:206",
                "combine": "src/repro/kernels/arena.py:294",
                "gram": "src/repro/kernels/arena.py:258",
                "flat_gram_row": "src/repro/kernels/gram_row.py:48",
                "flat_combine": "src/repro/kernels/combine.py:27",
                "flat_gram": "src/repro/kernels/gram.py:45"}
    launches = {"gram_row": main_launches["gram_row"],
                "combine": main_launches["combine"],
                "gram": rec_launches["gram"],
                "flat_gram_row": leaf_launches["flat_gram_row"],
                "flat_combine": leaf_launches["flat_combine"],
                "flat_gram": leaf_rec_launches["flat_gram"]}
    kernels = [dict(name=name, route="cuda",
                    source=FLAT_SRC if name.startswith("flat") else SRC,
                    replaces=replaces[name], launches=launches[name],
                    **records[name])
               for name in replaces]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
