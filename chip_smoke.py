#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero (nothing is caught):

1. The card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions.
2. Build the CUDA kernels (``src/repro_torch/kernels/csrc/*.cu``, one
   ``nvcc`` per source, in parallel) and print ptxas's registers, shared
   memory and spills (``-Xptxas -v``) of the Hopper flash-attention design,
   of K1, K4 and K5; K7's design, K1 and K5 must not spill.
3. The arena kernels K1-K3 against their plain PyTorch twins at the paper
   MLP's arena shape, (5633, 14, 512), with the paper bucket's real block
   -> system table: fp32 and bf16 buffers, both anchors of the Gram row,
   first and mean anchor of the Gram, bit-identical repeat launches, K1's
   tickets left at zero; then timings of the kernel, the twin and (where
   one PyTorch call computes the same function) that call, beside the
   least time the card could take. K1 takes 16-byte loads on this arena,
   and is timed in turns with its twin (no single call computes it); its
   CUDA-graph replay time (device time without the host's time per call)
   is printed and recorded beside, as ``graph_ms``.
3b. The flat per-leaf kernels K4-K6 against their twins at the 8 paper
   leaves' buffers (14, n) and one stacked (14, 4, 131072) buffer: fp32
   and bf16, with and without the anchor, per-system tolerance, repeat
   launches bit-identical, integer-valued data exact; timings at the
   largest leaf, /l3/w (14, 2670000), with K4's time over ``torch.mv``'s
   and K5's over ``c @ x``'s in the same call (fp32; bf16 has no library
   call: its GB/s; K5's CUDA-graph replay time beside, as for K1), and
   K4's and K5's load width on the ragged n = 2670 leaf (one lane) and on
   /l3/w (16 bytes).
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
8. The flash-attention kernel K7 against its plain twin: every prefill
   shape the serve phase launches, (1, 4096, 32, 4, 64) bf16 causal, and
   windowed, non-causal, ragged, Sq != Sk, d 16 and 128, GQA rep 1 and 8
   cases in fp32 and bf16; the Hopper design's tile edges (Sq, Sk of 127,
   128, 129, 257 at d 64 and 128, every mask, GQA rep 1 and 8, q/k/v as
   slices of one fused tensor); repeat launches bit-identical; timings at
   the 4096 shape and the largest serve prefill shape beside the bound and
   ``scaled_dot_product_attention``, with K7's time over SDPA's.
9. The serving path at TinyLlama-1.1B's full width (22 layers, d 2048,
   32/4 heads, vocab 32000, bf16, random weights from a seeded generator on
   the card) through ``repro_torch.launch.serve``: the launcher's stream of
   12 requests, 16 new tokens, 8 slots, greedy. Every request completes;
   K7 launches 22 times per prefill dispatch, every launch through its
   Hopper (wgmma) design, and no other kernel runs;
   each request's first-token logits match the exact-length
   prefill + decode loop; a run with a hot-swap every 8 steps; a 4096-token
   ``forward`` with 22 K7 launches and a finite loss.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import re
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
from repro_torch.core.paths import leaves_with_paths, tree_map  # noqa: E402
from repro_torch.data.synthetic import synthetic_regression  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import arena as ka  # noqa: E402
from repro_torch.kernels import combine as kc  # noqa: E402
from repro_torch.kernels import device as kd  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import gram as kg  # noqa: E402
from repro_torch.kernels import gram_row as kgr  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.mlp_net import init_mlp  # noqa: E402
from repro_torch.train import paper_loop  # noqa: E402

# H100 SXM data sheet (the least-time bound): HBM3 bytes/s, fp32 flop/s
# outside the tensor cores (K1-K6 are IEEE fp32, no TF32), dense bf16
# flop/s on the tensor cores (K7 in bf16)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
SRC = "src/repro_torch/kernels/csrc/arena.cu"
FLAT_SRC = "src/repro_torch/kernels/csrc/flat.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash.cu"
STEPS, ROWS = 300, 1000
# every wrapper's launch counter
COUNTERS = (ka.LAUNCHES, kgr.LAUNCHES, kc.LAUNCHES, kg.LAUNCHES,
            kf.LAUNCHES)
# each served request's first-token logits (padded prefill + one decode
# step) against the exact-length loop's (prefill alone), bf16 model:
# |diff| <= tol * max(1, max |logits|). The two differ by bf16 rounding on
# different paths (cuBLAS at another M, K7's bf16 softmax weights against
# the decode core's fp32 ones) through 22 layers.
SERVE_LOGIT_TOL = 5e-2
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


# design counters: a subset of their kernel's launches, not another kernel
DESIGNS = {"flash_attention_wgmma": "flash_attention"}


def counts():
    return {k: v for counter in COUNTERS for k, v in counter.items()
            if k not in DESIGNS}


def require_counts(what, want):
    """Every kernel of `want` launched exactly so often, all others 0; a
    design counter never exceeds its kernel's count."""
    got = counts()
    full = {k: want.get(k, 0) for k in got}
    require(got == full, f"{what}: launches {got}, expected {full}")
    for design, kernel in DESIGNS.items():
        require(kf.LAUNCHES[design] <= got[kernel], f"{what}: {design} "
                f"{kf.LAUNCHES[design]} > {kernel} {got[kernel]}")
    return got


def require_wgmma(what):
    """Every K7 launch since the counts were set to 0 ran the Hopper
    design."""
    n, w = kf.LAUNCHES["flash_attention"], kf.LAUNCHES["flash_attention_wgmma"]
    require(n > 0 and w == n, f"{what}: {w} of {n} K7 launches through the "
            "wgmma design")
    print(f"{what}: {w} of {n} K7 launches through the wgmma design")


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


def in_turns(kern, lib, iters=50):
    """Kernel and library call timed in turns (kernel, library, library,
    kernel), each by cuda_ms over `iters` launches: the two means. Without a
    library call, the kernel alone (library None)."""
    if lib is None:
        return cuda_ms(kern, iters), None
    k1, l1, l2, k2 = (cuda_ms(f, iters) for f in (kern, lib, lib, kern))
    return (k1 + k2) / 2, (l1 + l2) / 2


def graph_ms(fn, iters=20):
    """Mean device time of fn() over `iters` launches captured in one CUDA
    graph and replayed, by CUDA events: the kernels back to back, without
    the host's time per call (a wrapper's Python is tens of µs, close to a
    bandwidth-bound pass at these sizes). Recorded beside the eager time,
    as ``graph_ms``, for K1 and K5."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                # warm-up on the capture stream
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    stop.record()
    stop.synchronize()
    del graph
    return start.elapsed_time(stop) / (2 * iters)


def bound_ms(nbytes, flops, peak=FP32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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
        require(not kd.tickets(x.device, kd.stream(), seg.n_sys).any(),
                f"gram_row {tag}: tickets not left at zero")
        # K1's per-call choices on the main path's arena and query
        vec, qslot = kd.vector_lanes(x, q), kd.query_slot(x, q, axis=1)
        require(vec and qslot == slot, f"K1 on the paper arena {tag}: "
                f"16-byte loads {vec}, query slot {qslot}")
        print(f"K1 load path on the paper arena {tag}: 16 bytes per row per "
              f"step, query read as slot {qslot}, "
              f"{ka.grid_ctas(nb, m, kd.sm_count(x.device))} CTAs")

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
            extra = {}
            if name == "gram_row":
                k_ms, p_ms = in_turns(kern, twin)
                extra["graph_ms"] = graph_ms(kern)
            else:
                k_ms, p_ms = cuda_ms(kern), cuda_ms(twin)
            l_ms = cuda_ms(lib) if lib is not None else None
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"kernel {name} {tag}: kernel_ms {k_ms} ref_ms {p_ms} "
                  f"bound_ms {b_ms} ({b_by}) library_ms {l_ms} "
                  f"max_abs_err {errs[name]} GB/s {nbytes / k_ms / 1e6}")
            if name == "gram_row":
                print(f"K1 {(nb, m, bn)} {tag}: kernel / twin {k_ms / p_ms} "
                      f"(same call, in turns); {nbytes / k_ms / 1e6} GB/s, "
                      f"{b_ms / k_ms} of the bound; CUDA-graph replay "
                      f"{extra['graph_ms']} ms")
            if dtype == torch.float32:
                records[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=l_ms,
                                     max_abs_err=errs[name], **extra)
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
    # K4's and K5's two load paths: one lane per load on the ragged leaf,
    # 16 bytes on /l3/w (both were checked against the twin just above)
    for path, want in ((next(p for p, n in leaves.items() if n == 2670),
                        False), ("/l3/w", True)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.zeros((m, 1, leaves[path]), dtype=dtype, device=dev)
            for kernel, vec in (("K4", kd.vector_lanes(x, x[m - 1])),
                                ("K5", kd.vector_lanes(x))):
                require(vec is want,
                        f"{kernel} on {path} {dtype}: 16-byte loads {vec}")
                print(f"{kernel} load path on {path} (n {leaves[path]}) "
                      f"{str(dtype).removeprefix('torch.')}: "
                      f"{'16 bytes' if vec else 'one lane'} per row per step")

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
            extra = {}
            if name in ("flat_gram_row", "flat_combine"):
                k_ms, l_ms = in_turns(kern, lib)
            else:
                k_ms = cuda_ms(kern)
                l_ms = cuda_ms(lib) if lib is not None else None
            if name == "flat_combine":
                extra["graph_ms"] = graph_ms(kern)
            p_ms = cuda_ms(twin)
            a_ms = cuda_ms(anchored) if anchored is not None else None
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"kernel {name} {tag} /l3/w {(m, n)}: kernel_ms {k_ms} "
                  f"anchored_ms {a_ms} ref_ms {p_ms} bound_ms {b_ms} "
                  f"({b_by}) library_ms {l_ms} max_abs_err {errs[name]} "
                  f"GB/s {nbytes / k_ms / 1e6}")
            if name == "flat_gram_row":
                print(f"K4 /l3/w {tag}: " + (
                    f"kernel / torch.mv {k_ms / l_ms} (same call, in turns)"
                    if l_ms else f"no library call; {nbytes / k_ms / 1e6} "
                    f"GB/s, {b_ms / k_ms} of the bound"))
            if name == "flat_combine":
                print(f"K5 /l3/w {tag}: " + (
                    f"kernel / c @ x {k_ms / l_ms} (same call, in turns)"
                    if l_ms else "no library call")
                    + f"; {nbytes / k_ms / 1e6} GB/s, {b_ms / k_ms} of the "
                    f"bound; CUDA-graph replay {extra['graph_ms']} ms")
            if fp32:
                records[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=l_ms,
                                     max_abs_err=errs[name], **extra)
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


# kernels whose ptxas report must show no spill: K7's Hopper design, K1, K5
NO_SPILL = ("flash_wgmma", "arena_row", "combine_flat")


def _kernel_name(mangled):
    """flash_wgmma<64>, row_part<float,16,vec=1> (K4), arena_row<...> (K1)
    and combine_flat<...> (K5) from ptxas's mangled names."""
    if m := re.search(r"flash_wgmmaILi(\d+)E", mangled):
        return f"flash_wgmma<{m.group(1)}>"
    if m := re.search(r"(row_part|arena_row|combine_flat)I"
                      r"(f|13__nv_bfloat16)Li(\d+)ELb([01])E", mangled):
        dtype = "float" if m.group(2) == "f" else "bf16"
        return f"{m.group(1)}<{dtype},{m.group(3)},vec={m.group(4)}>"
    return None


def report_ptxas():
    """Phase 2: registers, shared memory and spills of the Hopper K7 design
    and of K1, K4 and K5, from ptxas -v; those in NO_SPILL must not
    spill."""
    for mangled, res in sorted(_build.kernel_resources(
            _build.ptxas_log()).items()):
        name = _kernel_name(mangled)
        if name is None:
            continue
        print(f"ptxas {name}: {res.get('registers')} registers, static smem "
              f"{res['smem']} B, stack {res.get('stack')} B, spill stores "
              f"{res.get('spill_stores')} B, spill loads "
              f"{res.get('spill_loads')} B")
        if name.startswith(NO_SPILL):
            require(res.get("spill_stores") == 0 and
                    res.get("spill_loads") == 0, f"{name} spills: {res}")


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

# K7 on unit-normal inputs, over the rows that see at least one key: fp32
# within 2e-5 + 1e-5 |twin| (online softmax over key tiles against one
# softmax per row); bf16 within 1e-2 + 1.6e-2 |twin| (one bf16 rounding of
# the output, 2^-7 relative, plus the kernel's bf16 softmax weights)
FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 1.6e-2)}
SERVE_SHAPES = [(b, s, s, 32, 4, 64, True, 0) for b in (1, 4)
                for s in (16, 64)]
LONG = (1, 4096, 4096, 32, 4, 64, True, 0)
# (B, Sq, Sk, H, K, d, causal, window) beyond the serve shapes
FLASH_EDGES = [
    (1, 256, 256, 8, 4, 64, True, 64),        # window
    (2, 100, 100, 16, 2, 16, False, 0),       # non-causal, ragged, d 16
    (1, 100, 100, 8, 8, 128, True, 0),        # ragged, d 128, rep 1
    (1, 64, 192, 32, 4, 64, True, 0),         # Sq < Sk
    (1, 192, 64, 8, 1, 32, True, 0),          # Sq > Sk, rep 8
    (2, 333, 333, 16, 2, 128, False, 100),    # non-causal window
]
# the Hopper design's tile edges (128 queries per CTA; 128 keys per tile at
# d 64, 64 at d 128): lengths 127 ... 257 under every mask, GQA rep 1 and
# 8, Sq != Sk both ways
FLASH_TILE_EDGES = [
    case for d in (64, 128) for case in
    [(1, s, s, 8, 1, d, True, 0) for s in (127, 128, 129, 257)]
    + [(2, s, s, 4, 4, d, False, 0) for s in (127, 128, 129, 257)]
    + [(1, s, s, 8, 2, d, True, 100) for s in (127, 257)]
    + [(1, 129, 257, 8, 1, d, True, 0), (1, 257, 127, 8, 8, d, True, 0),
       (1, 127, 129, 4, 1, d, False, 64), (1, 257, 128, 4, 4, d, False, 0)]]


def _flash_inputs(case, dtype, dev, seed):
    B, Sq, Sk, H, K, d = case[:6]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, Sq, H, d), (B, Sk, K, d), (B, Sk, K, d))]


def _flash_pairs(Sq, Sk, causal, window):
    """Visible (query, key) pairs of one head: the work the data needs."""
    return int(kf._mask(Sq, Sk, causal, window, "cpu").sum())


def _check_flash_case(case, dtype, dev, seed, qkv=None):
    """K7 on one case against its twin; both launches through the design
    its dtype and d select. `qkv` replaces the drawn inputs."""
    causal, window = case[6], case[7]
    q, k, v = qkv or _flash_inputs(case, dtype, dev, seed)
    w0 = kf.LAUNCHES["flash_attention_wgmma"]
    got = kf.flash_attention(q, k, v, causal=causal, window=window)
    require(torch.equal(got, kf.flash_attention(q, k, v, causal=causal,
                                                window=window)),
            f"flash {case} {dtype} not repeatable")
    require(kf.LAUNCHES["flash_attention_wgmma"] - w0 ==
            2 * kf.uses_wgmma(dtype, case[5]),
            f"flash {case} {dtype}: wrong design launched")
    want = kf.flash_attention_ref(q, k, v, causal=causal, window=window)
    rows = kf._mask(case[1], case[2], causal, window, dev).any(dim=1)
    diff = (got[:, rows].float() - want[:, rows].float()).abs()
    atol, rtol = FLASH_TOL[dtype]
    limit = atol + rtol * want[:, rows].float().abs()
    require(torch.isfinite(got.float()).all(), f"flash {case}: non-finite")
    require(bool((diff <= limit).all()), f"flash {case} {dtype}: max "
            f"|kernel - twin| {float(diff.max())} beyond {atol} + "
            f"{rtol}|twin|")
    return float(diff.max()), (q, k, v)


def check_flash(dev):
    """Phase 8. Returns the record of K7 at the 4096 shape."""
    n = 0
    for case in SERVE_SHAPES + FLASH_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            if case in SERVE_SHAPES and dtype == torch.float32:
                continue                  # the serve path is bf16
            _check_flash_case(case, dtype, dev, seed=100 + n)
            n += 1
    for case in FLASH_TILE_EDGES:
        _check_flash_case(case, torch.bfloat16, dev, seed=100 + n)
        n += 1
    # q, k and v as head slices of one fused (B, S, H + 2K, d) projection
    for d in (64, 128):
        case = (2, 257, 257, 8, 2, d, True, 0)
        g = torch.Generator(device=dev).manual_seed(100 + n)
        qkv = torch.randn((2, 257, 12, d), generator=g, device=dev).to(
            torch.bfloat16)
        q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
        _check_flash_case(case, torch.bfloat16, dev, 0, (q, k, v))
        require(torch.equal(kf.flash_attention(q, k, v), kf.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous())),
            f"flash {case}: strided views differ from contiguous copies")
        n += 1
    torch.cuda.synchronize()
    print(f"flash: {n} cases match the twin within {FLASH_TOL}; repeat "
          f"launches bit-identical; {len(FLASH_TILE_EDGES) + 2} of them at "
          "the wgmma design's tile edges and on strided views")

    record = None
    for case in (LONG, SERVE_SHAPES[-1]):
        err, (q, k, v) = _check_flash_case(case, torch.bfloat16, dev, 7)
        B, Sq, Sk, H, K, d = case[:6]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        k_ms, l_ms = in_turns(
            lambda: kf.flash_attention(q, k, v),
            lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
        p_ms = cuda_ms(lambda: kf.flash_attention_ref(q, k, v), iters=5)
        flops = 4.0 * d * _flash_pairs(Sq, Sk, True, 0) * B * H
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        print(f"kernel flash_attention bf16 {case[:6]} causal: kernel_ms "
              f"{k_ms} ref_ms {p_ms} sdpa_ms {l_ms} bound_ms {b_ms} ({b_by})"
              f" max_abs_err {err} TFLOP/s {flops / k_ms / 1e9}")
        print(f"K7 {case[:6]}: kernel / sdpa {k_ms / l_ms} (same call, in "
              f"turns); {b_ms / k_ms} of the bound")
        if record is None:
            record = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=l_ms, max_abs_err=err)
    return record


def _serve_counted(what, engine, prompts, swap_every=0, swap=None):
    """One counted serve run: counts set to 0 just before, read just after;
    K7 must have launched once per layer per prefill dispatch and nothing
    else at all."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    done, steps, wall = launch_serve.serve(engine, prompts, swap_every, swap)
    s = engine.stats
    per_prefill = engine.model.cfg.n_layers
    launches = require_counts(what, {
        "flash_attention": per_prefill * s["prefill_dispatches"]})
    require_wgmma(what)
    require(len(done) == len(prompts), f"{what}: {len(done)} of "
            f"{len(prompts)} requests completed")
    for r in done:
        require(len(r.tokens) == engine.cfg.max_new_tokens and
                np.isfinite(r.last_logits).all(),
                f"{what}: request {r.uid} gave {len(r.tokens)} tokens")
    print(f"{what}: {len(done)} requests, {s['tokens_emitted']} tokens, "
          f"{steps} steps, {s['prefill_dispatches']} prefills, "
          f"{s['decode_dispatches']} decodes, swaps {s['swaps']} in {wall} s"
          f": tokens/s {s['tokens_emitted'] / wall}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB; launches "
          f"{launches}")
    return done, launches


def run_serve(dev):
    """Phase 9: the serving path at TinyLlama-1.1B's full width."""
    t0 = time.perf_counter()
    model, params, engine = launch_serve.build("tinyllama-1.1b", device=dev)
    torch.cuda.synchronize()
    cfg = model.cfg
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.vocab_size, cfg.dtype) == (22, 2048, 32, 4, 32000,
                                            "bfloat16"), f"config {cfg}")
    print(f"serve: tinyllama-1.1b {model.param_count(params)} params, built "
          f"in {time.perf_counter() - t0} s")
    prompts = launch_serve.request_stream(12, cfg.vocab_size)
    done, launches = _serve_counted("serve path", engine, prompts)

    # the breakdown, on a second engine: host clock around each engine step,
    # synchronised; a step that admitted requests ran their prefill
    del engine
    eng = launch_serve.make_engine(model, params)
    for p in prompts:
        eng.submit(p)
    pre_ms, dec_ms = [], []
    while eng.queue_len or eng.active_slots:
        n_pre = eng.stats["prefill_dispatches"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        kind = pre_ms if eng.stats["prefill_dispatches"] > n_pre else dec_ms
        kind.append((time.perf_counter() - t0) * 1e3)
    print(f"serve: decode-only step ms median {float(np.median(dec_ms))} "
          f"(of {len(dec_ms)}); steps with prefill ms {pre_ms}")
    # one prefill dispatch as the engine makes it, at the smallest and the
    # largest (batch, prompt) bucket: fresh caches, then the prompt pass
    s_max = max(launch_serve.PROMPT_BUCKETS) + 16
    for shape in ((1, 16), (4, 64)):
        toks = torch.ones(shape, dtype=torch.long, device=dev)
        ms = cuda_ms(lambda: model.prefill(
            params, {"tokens": toks}, model.init_cache(shape[0], s_max)),
            iters=5, warmup=1)
        print(f"serve: prefill dispatch {shape} ms {ms}")

    # first-token logits against the exact-length prefill + decode loop
    del eng
    eng = launch_serve.make_engine(model, params, new_tokens=1)
    firsts = {r.uid: r.last_logits for r in
              launch_serve.serve(eng, prompts)[0]}
    del eng
    equal, worst = 0, 0.0
    for r in done:
        toks, first = launch_serve.exact_greedy(model, params,
                                                prompts[r.uid], 16)
        first = first.cpu().numpy()
        err = float(np.abs(firsts[r.uid] - first).max())
        scale = max(1.0, float(np.abs(first).max()))
        require(err <= SERVE_LOGIT_TOL * scale,
                f"request {r.uid}: first-token logits off by {err} (scale "
                f"{scale})")
        worst = max(worst, err / scale)
        equal += sum(a == b for a, b in zip(r.tokens, toks))
    print(f"serve: first-token logits vs the exact-length loop: worst "
          f"|diff| / max(1, max|logits|) {worst} (limit {SERVE_LOGIT_TOL}); "
          f"equal tokens {equal} of {16 * len(done)}")

    # hot-swap every 8 steps
    eng = launch_serve.make_engine(model, params)
    swap = tree_map(lambda t: t * 1.001, params)
    done2, _ = _serve_counted("serve path, swap every 8", eng, prompts, 8,
                              swap)
    require(eng.stats["swaps"] >= 1 and any(
        r.version_end > r.version_start for r in done2), "no swap adopted")
    del swap, eng

    # one 4096-token sequence through forward
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(1, cfg.vocab_size, (1, 4096), generator=g,
                         device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = model.loss(params, {"tokens": toks})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    require_counts("forward 4096", {"flash_attention": cfg.n_layers})
    require_wgmma("forward 4096")
    require(bool(torch.isfinite(loss)), f"forward 4096: loss {loss}")
    print(f"forward 4096: loss {float(loss)} in {ms} ms, {cfg.n_layers} K7 "
          "launches")
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
    report_ptxas()

    records = check_kernels(dev)
    records.update(check_flat_kernels(dev))
    records["flash_attention"] = check_flash(dev)

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
    serve_launches = run_serve(dev)

    replaces = {"gram_row": "src/repro/kernels/arena.py:206",
                "combine": "src/repro/kernels/arena.py:294",
                "gram": "src/repro/kernels/arena.py:258",
                "flat_gram_row": "src/repro/kernels/gram_row.py:48",
                "flat_combine": "src/repro/kernels/combine.py:27",
                "flat_gram": "src/repro/kernels/gram.py:45",
                "flash_attention": "src/repro/kernels/flash_attention.py:82"}
    launches = {"gram_row": main_launches["gram_row"],
                "combine": main_launches["combine"],
                "gram": rec_launches["gram"],
                "flat_gram_row": leaf_launches["flat_gram_row"],
                "flat_combine": leaf_launches["flat_combine"],
                "flat_gram": leaf_rec_launches["flat_gram"],
                "flash_attention": serve_launches["flash_attention"]}
    sources = {"gram_row": SRC, "combine": SRC, "gram": SRC,
               "flat_gram_row": FLAT_SRC, "flat_combine": FLAT_SRC,
               "flat_gram": FLAT_SRC, "flash_attention": FLASH_SRC}
    kernels = [dict(name=name, route="cuda", source=sources[name],
                    replaces=replaces[name], launches=launches[name],
                    **records[name])
               for name in replaces]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
