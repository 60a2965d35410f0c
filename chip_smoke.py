#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero (nothing is caught):

1. The card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions.
2. Build the CUDA kernels (``src/repro_torch/kernels/csrc/*.cu``, one
   ``nvcc`` per source, in parallel) and print ptxas's registers, shared
   memory and spills (``-Xptxas -v``) of the Hopper flash-attention design
   (with and without its log-sum-exp output), of K7b's Hopper design
   (its three kernels) and of K1 and K3-K6; K7's design, K7b's at d 64,
   K1, K5 and every m <= 16 instantiation of K3 and K6 must not spill,
   and every one of those instantiations must be in the report. ptxas's
   notes where it serialises a kernel's wgmma are printed.
3. The arena kernels K1-K3 against their plain PyTorch twins at the paper
   MLP's arena shape, (5633, 14, 512), with the paper bucket's real block
   -> system table: fp32 and bf16 buffers, both anchors of the Gram row,
   every anchor of the Gram (none, first, mean; exactly symmetric; exact
   on integer data), bit-identical repeat launches, the tickets left at
   zero; then timings of the kernel, the twin and (where one PyTorch call
   computes the same function) that call, beside the least time the card
   could take. K1 and K3 take 16-byte loads on this arena, and are timed
   in turns with their twins (no single call computes them). Every
   kernel's CUDA-graph replay time (device time without the host's time
   per call) is printed and recorded beside its eager time, as
   ``graph_ms``.
3b. The flat per-leaf kernels K4-K6 against their twins at the 8 paper
   leaves' buffers (14, n) and one stacked (14, 4, 131072) buffer: fp32
   and bf16, with and without the anchor, per-system tolerance, repeat
   launches bit-identical, integer-valued data exact, K6 exactly
   symmetric, the tickets left at zero; timings at the largest leaf, /l3/w
   (14, 2670000), with K4's time over ``torch.mv``'s, K5's over ``c @
   x``'s and K6's over ``x @ x.T``'s in the same call (fp32; bf16 has no
   library call: its GB/s), each with its CUDA-graph replay time, and
   K4's, K5's and K6's load width on the ragged n = 2670 leaf (one lane)
   and on /l3/w (16 bytes), with K6's CTA count.
4. The main path: ``paper_loop.train`` for 300 steps at the paper's full
   width (2,882,150 params), default DMDConfig, 1000 teacher rows. It must
   launch the Gram-row kernel 112 times and the combine kernel 8 times,
   and its loss must be finite and falling. At step 123 (the first
   complete window) the carried streaming Gram must match the Gram
   kernel's full recompute of the ring buffer.
5. The non-streaming path (``streaming_gram=False``) for 150 steps: 2 Gram
   and 2 combine launches, no Gram-row launch; its jump ratios and
   reverted steps are printed.
6. The per-leaf path (``arena=False``) for 300 steps: K4 896 launches (112
   records x 8 leaves), K5 64 (8 jumps x 8 leaves), no other kernel; loss
   finite and falling. At step 123 each leaf's carried Gram must match
   K6's recompute of its buffer and the arena route's Gram of the same
   system.
7. The per-leaf recompute path (``arena=False, streaming_gram=False``) for
   150 steps: K6 and K5 16 launches each, no K4; jump ratios and reverted
   steps printed.
8. The flash-attention kernel K7 against its plain twin: every prefill
   shape the serve phase launches, (1, 4096, 32, 4, 64) bf16 causal, and
   windowed, non-causal, ragged, Sq != Sk, d 16 and 128, GQA rep 1 and 8
   cases in fp32 and bf16; the Hopper design's tile edges (Sq, Sk of 127,
   128, 129, 257 at d 64 and 128, every mask, GQA rep 1 and 8, q/k/v as
   slices of one fused tensor); repeat launches bit-identical; timings at
   the 4096 shape and the largest serve prefill shape beside the bound and
   ``scaled_dot_product_attention``, with K7's time over SDPA's and its
   CUDA-graph replay time.
9. The serving path at TinyLlama-1.1B's full width (22 layers, d 2048,
   32/4 heads, vocab 32000, bf16, random weights from a seeded generator on
   the card) through ``repro_torch.launch.serve``: the launcher's stream of
   12 requests, 16 new tokens, 8 slots, greedy. Every request completes;
   K7 launches 22 times per prefill dispatch, every launch through its
   Hopper (wgmma) design, and no other kernel runs;
   each request's first-token logits match the exact-length
   prefill + decode loop; a run with a hot-swap every 8 steps; a 4096-token
   ``forward`` with 22 K7 launches and a finite loss.
10. The Trainer (``repro_torch.train.Trainer`` with ``MLPModel``) at the
   paper MLP's full width, on the teacher's rows, its non-jump steps
   replayed from CUDA graphs:
   (a) the default DMDConfig (arena, resident params, streaming Gram),
   Adam 1e-3, 300 steps on the phase-4 rows, graphed and eagerly (the
   same Trainer with ``cuda_graphs=False``): each launches K1 112 times
   (one per record step: the paper loop's schedule) and K2 8 times (one
   per jump), loss finite and falling, and the two runs' per-step losses
   and final params are bit-identical; a captured-then-replayed step
   (the plain one and the slot-0 record one) writes the same bits into
   every state tensor as the eager step on a copy, with the tickets left
   at zero; the carried Gram at step 123 matches K3's recompute; ms/step
   graphed, eager and of the plain graph's replay alone beside phase 4's
   ``paper_loop``; the device's busy share under ``torch.profiler`` over
   a graphed run, with its top kernels by device time.
   (b) ``arena=False``, graphed: K4 896 and K5 64 launches; its busy
   share too.
   (c) fig4's gated run (``benchmarks/paper_benches.py::_train_gated``):
   the validation-gated controller (shrink ladder 0.5, 0.25; meta-tuning
   at meta_lr 0.05), m 14, s 55, tol 1e-4, warmup 100, cooldown 10, 600
   steps on 1000 rows, gated on a disjoint 150-row validation fold of the
   same teacher and tested on another 150: K1 once per record step plus
   once per jump as K2's backward (290 + 20), K2 20, the gate's outcome
   counts printed, s_eff, relax_eff and ridge_eff finite and inside their
   clamps, loss finite and falling; the final train and test MSE beside
   an ungated run and a DMD-off run of the same rows and steps (printed,
   not required to win).
11. The paper's problem on its own dataset (``data/pollutant.py``):
   (a) ``solve_dataset`` at the paper's scale, 1000 LHS samples on the
   96 x 48 grid with 2670 probes and the 4000-iteration cap, seed 0: the
   Blasius shooting and velocity fields on the host, the march on the
   card, every sample at once; the seconds of each, the per-sample
   iteration counts (min, median, max, how many at the cap); Y finite,
   |X| <= 1, the shapes; 8 samples (the fastest, the slowest, 6 spread)
   marched again on the CPU: iteration counts equal or off by one and c3
   within 5 * tol absolute (the CPU tests' bound against the reference).
   (b) The 80/20 split (seed 2) and the launcher's ``run`` for 3000
   epochs on the 800 training rows, the arena route, with DMD off (no
   kernel launch) and with the launcher's DMD (m 14, s 55, tol 1e-4,
   warmup 100, cooldown 10: jumps at 123 + 24k, 120 of them) on the
   reference example's route: no Gram carried, so K3 recomputes it and K2
   combines once per jump, and K1 never runs. Loss finite and falling
   before the first jump, train and test MSE every 200 epochs, the
   per-jump loss ratios, the accepted and reverted steps, ms/step, and the
   test MSE beside DMD off's and beside the streaming route's of PR 18
   (printed, not required).
   (c) fig4's gated Trainer (phase 10(c)'s controller, graphed) for 3000
   steps on 650 of the training rows, gated on the other 150, tested on
   the 200 test rows: it streams the Gram, as the reference's Trainer
   does, so K1 once per record and once per jump as K2's backward, K2
   once per jump; outcome counts, knobs and final MSE beside (b)'s.
12. Checkpoints (``checkpoint/``, ``Trainer.save`` / ``restore``) and the
   weights channel at full width, each preemption a real SIGTERM sent to
   this process from ``on_metrics``:
   (a) phase 10(a)'s Trainer preempted mid-window (a record step of the
   second window, a record of it already taken) and on the second jump
   step, both read from the schedule; a fresh Trainer resumes on the
   same directory to step 300 with new CUDA graphs. Its losses and its
   final state must equal phase 10(a)'s graphed run bit for bit, K1 and
   K2 must launch 112 and 8 times over the two halves, and the tickets
   end at zero. Save ms and restore ms (host clock, synchronised) and the
   checkpoint's bytes on disk are printed.
   (b) phase 10(c)'s gated run preempted on a jump step and resumed: every
   controller field (counters, s_eff, relax_eff, ridge_eff) and the final
   params bit-identical to 10(c)'s; K1 and K2 as there, summed.
   (c) a checkpoint of the per-leaf route (``arena=False``) restored into
   the arena route and one of the arena route into the per-leaf route:
   every restored leaf equals the writer's leaf-wise state bit for bit;
   each reader runs 30 more steps (K1/K2 or K4/K5 once per record and
   jump).
   (d) TinyLlama-1.1B (phase 9's model) through ``WeightsChannel``: the
   params scaled by 1.001 published once, a running engine polls them
   after its second step (requests in flight and queued), an engine
   cold-started on ``load``; the loaded params equal the published ones
   bit for bit, the requests admitted after the swap give the cold
   engine's tokens, the version stamps are right and nothing is dropped.
   Publish, poll and load seconds and the bytes on disk are printed.
   Temporary directories live in the checkout (``.chip_smoke_*``) and are
   removed.
13. The paper's own DMD configuration (``get_config("pollutant-mlp")``:
   classic DMD by eigendecomposition, one host eig per jump) and bucket
   scope (one Koopman system per arena bucket: K1-K3 with the bucket's
   all-zeros block table, n_sys 1, every CTA feeding one ticket):
   (a) ``pollutant_regression --full``'s DMD (eig mode, tol 1e-10,
   unanchored, no affine term, no trust region, warmup 28, no cooldown,
   moments kept) through the launcher's ``run`` for 3000 epochs on phase
   11's 800 training rows (DMD off is 11(b)'s run: same rows, same init),
   on 11(b)'s route: K3 and K2 once per jump, no K1, one host eig per
   jump, the tickets at zero, the loss finite and falling before the
   first jump; the jump ratios, the reverted steps, the guard's
   fallbacks, ms/step and the final MSE beside 11(b)'s. A run whose every
   jump is reverted must equal 11(b)'s DMD off step for step (the moments
   are kept); otherwise its first accepted step is printed.
   (b) ``paper_loop`` at bucket scope, 300 steps: K1 112 at n_sys 1, K2
   8, the tickets at zero, ``plan_table`` with scope "bucket" and n_solve
   1 on every leaf; at step 123 the carried (1, m, m) Gram against K3's
   recompute with the zeros table and against the sum of phase 4's
   per-system Grams (within 1e-4 of max |G|); jump ratios and reverts
   beside phase 4's.
   (c) eig mode at leaf scope on the main path, 300 steps: K1 112, K2 8,
   8 host eigs of 8 systems; ratios and reverts beside phase 4's matpow.
   (d) the Trainer at bucket scope in eig mode, 300 steps, graphed and
   eager: K1 112, K2 8, one host eig per jump and none in a capture;
   losses and state bit-identical.
   (e) (d)'s Trainer preempted by SIGTERM mid-window and on a jump step,
   resumed by a fresh Trainer: losses and final state bit-identical to
   (d)'s graphed run; K1 112 plus the current window's rows the restore
   replays, K2 8, K3 once per save and once for the restore's template;
   at the mid-window step, the current window's entries of the summed K3
   rebuild against the carried Gram (printed) and, after the K1 replay,
   bit-identical to it.
   A bucket-scope checkpoint restored into a leaf-scope Trainer and the
   other way round: every restored leaf bit-identical to the writer's
   leaf-wise state; 30 more steps each, counted.
   (f) ``spectrum_table`` at step 123 in both scopes, from the carried
   Grams and from K3's recompute (one launch each): |lambda|max at the
   config's tol 1e-4 (5-7 kept modes, the smallest at the fp32 noise
   floor: printed, finite) and at tol 1e-2 (2 kept modes: the four rows
   within 2e-3).
   (g) K1 and K3 at the bucket-scope shape (5633, 14, 512), n_sys 1,
   against their twins, timed eager and as CUDA-graph replays beside the
   one PyTorch call that computes the same function (anchor none, the
   paper configuration's): ``torch.einsum("bmn,bn->m")`` and
   ``torch.einsum("bmn,bkn->mk")``; recorded as the ``bucket_*`` fields
   of K1's and K3's records in the kernels' line.
14. The paper benches (``repro_torch.benchmarks.paper_benches``), the
   six suites of ``python -m repro_torch.benchmarks.run`` at full size:
   first the kernels at the benches' new shapes against their twins and
   timed eagerly (in turns with the twin or the library call) and as
   CUDA-graph replays beside their bound (the ``bench_*`` fields of their
   records): K4-K6 at streaming_gram's (14, 1, 4000000) leaf, K3 and K2 at
   fig4's arena. Then each suite, its launches counted (sec3: K3 = K2 =
   11; streaming_gram: K4 25, K5 22, K6 11; staggered_jump: K1 per
   recording bucket and record, K2 per jumped bucket; controller: K1 per
   record of its two Trainers, K2 per jump and per timed jump step; fig3:
   K3 = K2 = the reference's jump counts; fig4: K3 20, K2 40, K1 310, of
   which its gated Trainer's 13 ``fit`` calls make 290 records + 20 as
   K2's backward), its rows in the schema of the committed reference
   ``BENCH_<suite>.json`` with the same schedule-determined and analytic
   fields (fig3's jump counts 21/21/21/17/17/17/14/14/14, fig4's 20 gate
   outcomes, staggered_jump's 285 / 1141 jump steps and 72083200 /
   72016000 bytes, streaming_gram's and sec3's analytic rows), every
   number finite and every measured one positive; each summary row
   printed beside the reference's (the inits differ, so the values are
   compared, not required equal). fig4's runs are checked from that one
   counted suite run: the gated Trainer's outcomes and summed
   ``graph_stats``, and its DMD run (``_train``: no guard, every jump
   recomputing the Gram) held against the same run on the CPU through the
   twins from the same seeded init: equal jump count, both curves finite,
   the curve within 1e-5 before the first jump, the first jump's loss
   ratio within ``FIG4_TOL`` (2e-3), and after it every sampled train and
   test MSE within ``FIG4_ENVELOPE`` of the CPU run's, the reference's own
   spread between two fp32-perturbed runs. K2 at fig4's arena is timed
   in turns with ``torch.einsum("bmn,bm->bn")`` on the block-gathered
   coefficients (the same function, checked against the twin).
15. TinyLlama-1.1B training ("tinyllama-train"). First K7b, the
   flash-attention backward (``kernels/csrc/flash_bwd.cu``), against its
   twin (autograd through K7's twin) in fp32 and bf16, row by row
   (``BWD_ROW_TOL``): one microbatch's attention (2, 4096, 32, 4, 64)
   causal, GQA rep 1 and 8, windows, non-causal, d 16-128, lengths
   127-257 at d 64 and 128; at the first, a sound bf16 control must pass
   the same limit and a wrong design must fail it; repeat launches
   bit-identical; bf16 at d 64 and 128 through K7b's Hopper design, every
   other case through the sm_80-unit kernels; K7's log-sum-exp output
   within ``LSE_ATOL`` of its twin and K7's output unchanged by it. K7b
   timed at (2, 4096, 32, 4, 64) bf16 eager and replayed beside its bound
   (10 d flops per seen pair and head at the bf16 peak) and in turns with
   the backward of ``scaled_dot_product_attention``. Then the launcher's
   ``run`` (``launch/train.py``) at TinyLlama's full widths, bf16, cut to
   ``LM_LAYERS`` layers (the state's bytes at 22 layers are printed and
   must exceed 90% of the card), with the config's DMD (m 14, s 55, fp32
   ring, leaf scope, warm-up 24 = steps // 4), adamw with clip and the
   cosine schedule, grad_accum 4 and remat "block", on the synthetic token
   stream at 8 x 4096 for 96 steps with CUDA graphs. Launches exactly: K1
   once per bucket per record, K2 once per bucket per jump, K7 2 x layers x
   4 per step (all through the wgmma design), K7b layers x 4 per step
   (all through its Hopper design);
   at least two jumps; finite losses, the last 10's mean below the first
   10's; ms/step, tokens/s and peak memory beside the reckoned state. K1
   and K2 on that run's own rings, every bucket, against their twins (K1's
   in float64) and timed (the ``lm_buckets`` fields of their records).
   Once the run's Trainer and state are dropped, without the garbage
   collector, at most ``LM_LEFT_BYTES`` more is allocated than before it
   (the graphs' shared pool went with them). Then 40 steps
   eagerly from the same init: at the first jump the carried Grams equal
   K3's recompute of the ring, and the losses and the params after 40
   steps equal the graphed run's bit for bit.
   The script's wall time is printed before the kernels' line.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import gc
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs.base import (ArchConfig, DMDConfig,  # noqa: E402
                                      DMDControllerConfig, ModelConfig,
                                      OptimizerConfig, TrainConfig)
from repro_torch.configs.pollutant_mlp import PAPER_SIZES  # noqa: E402
from repro_torch.core import arena as arena_mod  # noqa: E402
from repro_torch.core import dmd as dmd_math  # noqa: E402
from repro_torch.core.accelerator import DMDAccelerator  # noqa: E402
from repro_torch.core.paths import (by_path, keystr_leaves,  # noqa: E402
                                    leaves_with_paths, map_with_paths,
                                    tree_map)
from repro_torch.data import pollutant  # noqa: E402
from repro_torch.data.synthetic import synthetic_regression  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import arena as ka  # noqa: E402
from repro_torch.kernels import combine as kc  # noqa: E402
from repro_torch.kernels import device as kd  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import gram as kg  # noqa: E402
from repro_torch.kernels import gram_row as kgr  # noqa: E402
from repro_torch.benchmarks import paper_benches as pb  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.launch import pollutant_regression  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.mlp_net import MLPModel, init_mlp  # noqa: E402
from repro_torch.models.mlp_net import mlp_forward, mse_loss  # noqa: E402
from repro_torch.serve import WeightsChannel  # noqa: E402
from repro_torch.train import Trainer, loop as train_loop  # noqa: E402
from repro_torch.train import paper_loop  # noqa: E402
from repro_torch.train.step import state_resident  # noqa: E402

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
# every wrapper's launch counter, and the design counters of the backward
# launches (K1 as K2's backward, K4 as K5's)
COUNTERS = (ka.LAUNCHES, kgr.LAUNCHES, kc.LAUNCHES, kg.LAUNCHES,
            kf.LAUNCHES, ka.BWD_LAUNCHES, kgr.BWD_LAUNCHES)
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
DESIGNS = {"flash_attention_wgmma": "flash_attention",
           "flash_attention_bwd_wgmma": "flash_attention_bwd",
           "gram_row_bwd": "gram_row", "flat_gram_row_bwd": "flat_gram_row"}


def all_counts():
    return {k: v for counter in COUNTERS for k, v in counter.items()}


def counts():
    return {k: v for counter in COUNTERS for k, v in counter.items()
            if k not in DESIGNS}


def require_counts(what, want):
    """Every kernel of `want` launched exactly so often, all others 0; a
    design counter never exceeds its kernel's count."""
    got = counts()
    full = {k: want.get(k, 0) for k in got}
    require(got == full, f"{what}: launches {got}, expected {full}")
    every = all_counts()
    for design, kernel in DESIGNS.items():
        require(every[design] <= got[kernel], f"{what}: {design} "
                f"{every[design]} > {kernel} {got[kernel]}")
    return got


def require_wgmma(what, kernel="flash_attention", tag="K7"):
    """Every K7 launch (or K7b call, with `kernel` flash_attention_bwd)
    since the counts were set to 0 ran the Hopper design."""
    n, w = kf.LAUNCHES[kernel], kf.LAUNCHES[kernel + "_wgmma"]
    require(n > 0 and w == n, f"{what}: {w} of {n} {tag} launches through "
            "the wgmma design")
    print(f"{what}: {w} of {n} {tag} launches through the wgmma design")


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
    bandwidth-bound pass at these sizes). Recorded beside every kernel's
    eager time, as ``graph_ms``."""
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


def check_close(name, got, want, rows, rtol=RTOL):
    """|got - want| <= rtol * max(1, max |want|) within each of `rows`
    leading rows (one per system, or one per block); returns the largest
    error."""
    diff = (got - want).abs().reshape(rows, -1).amax(dim=1)
    limit = rtol * want.abs().reshape(rows, -1).amax(dim=1).clamp_min(1.0)
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
        for anchor in ({}, {"anchor_first": True}, {"anchor_mean": True}):
            got = ka.gram(x, seg, **anchor)
            want = ka.gram_ref(x, seg.block_sys, seg.n_sys, **anchor)
            errs["gram"] = max(errs["gram"], check_close(
                f"gram {tag} {anchor}", got, want, seg.n_sys))
            require(torch.equal(got, ka.gram(x, seg, **anchor)),
                    f"gram {tag} not repeatable")
            require(torch.equal(got, got.transpose(1, 2)),
                    f"gram {tag} {anchor} not exactly symmetric")
        # integer data, values in {-1, 0, 1}: every partial sum stays below
        # 2**24, so every order of summation gives the same fp32 result
        xi = torch.randint(-1, 2, (nb, m, bn), generator=torch.Generator(
            device=dev).manual_seed(4), device=dev).to(dtype)
        for anchor_first in (False, True):
            got = ka.gram(xi, seg, anchor_first=anchor_first)
            want = ka.gram_ref(xi, seg.block_sys, seg.n_sys,
                               anchor_first=anchor_first)
            require(torch.equal(got, want), f"gram {tag} integer "
                    f"anchor_first={anchor_first}: not exact, max diff "
                    f"{max_err(got, want)}")
        del xi
        got = ka.combine(x, c, seg)
        want = ka.combine_ref(x, c, seg.block_sys)
        errs["combine"] = check_close(f"combine {tag}", got, want, nb)
        require(torch.equal(got, ka.combine(x, c, seg)),
                f"combine {tag} not repeatable")
        torch.cuda.synchronize()
        require(not kd.tickets(x.device, kd.stream(), seg.n_sys).any(),
                f"gram_row / gram {tag}: tickets not left at zero")
        # K1's per-call choices on the main path's arena and query
        vec, qslot = kd.vector_lanes(x, q), kd.query_slot(x, q, axis=1)
        require(vec and qslot == slot, f"K1 on the paper arena {tag}: "
                f"16-byte loads {vec}, query slot {qslot}")
        print(f"K1 load path on the paper arena {tag}: 16 bytes per row per "
              f"step, query read as slot {qslot}, "
              f"{ka.grid_ctas(nb, m, kd.sm_count(x.device))} CTAs")
        # K3's: the same load width rule on the buffer alone, K1's grid at
        # one CTA per SM
        require(kd.vector_lanes(x), f"K3 on the paper arena {tag}: 16-byte "
                "loads False")
        ctas, n_part = ka.gram_grid(nb, m, seg.n_sys, kd.sm_count(x.device))
        print(f"K3 load path on the paper arena {tag}: 16-byte rows (16- or "
              f"8-byte units by gram.cuh's GramLoads), {ctas} CTAs, {n_part} "
              "partial floats, one launch")

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
            if name in ("gram_row", "gram"):
                k_ms, p_ms = in_turns(kern, twin)
            else:
                k_ms, p_ms = cuda_ms(kern), cuda_ms(twin)
            l_ms = cuda_ms(lib) if lib is not None else None
            extra = {"graph_ms": graph_ms(kern)}
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"kernel {name} {tag}: kernel_ms {k_ms} ref_ms {p_ms} "
                  f"bound_ms {b_ms} ({b_by}) library_ms {l_ms} graph_ms "
                  f"{extra['graph_ms']} max_abs_err {errs[name]} GB/s "
                  f"{nbytes / k_ms / 1e6}")
            if name in ("gram_row", "gram"):
                print(f"{'K1' if name == 'gram_row' else 'K3'} {(nb, m, bn)} "
                      f"{tag}: kernel / twin {k_ms / p_ms} (same call, in "
                      f"turns); {nbytes / k_ms / 1e6} GB/s, {b_ms / k_ms} of "
                      f"the bound; CUDA-graph replay {extra['graph_ms']} ms, "
                      f"{b_ms / extra['graph_ms']} of the bound")
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
        require(not kd.tickets(x32.device, kd.stream(), n_sys).any(),
                f"flat kernels {(m_, n_sys, n)}: tickets not left at zero")
    print(f"flat kernels: {len(shapes)} shapes x fp32/bf16 x random/integer "
          f"match their twins")
    # K4's and K5's two load paths: one lane per load on the ragged leaf,
    # 16 bytes on /l3/w (both were checked against the twin just above)
    for path, want in ((next(p for p, n in leaves.items() if n == 2670),
                        False), ("/l3/w", True)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.zeros((m, 1, leaves[path]), dtype=dtype, device=dev)
            for kernel, vec in (("K4", kd.vector_lanes(x, x[m - 1])),
                                ("K5", kd.vector_lanes(x)),
                                ("K6", kd.vector_lanes(x))):
                require(vec is want,
                        f"{kernel} on {path} {dtype}: 16-byte loads {vec}")
                grid = ""
                if kernel == "K6":
                    _, ctas, n_part = kg.grid(x, kd.sm_count(dev))
                    grid = (f", {ctas} CTAs, {n_part} partial floats, one "
                            "launch")
                width = "16 bytes" if vec else "one lane"
                if kernel == "K6" and vec:
                    width = "16-byte rows (16- or 8-byte units by gram.cuh)"
                print(f"{kernel} load path on {path} (n {leaves[path]}) "
                      f"{str(dtype).removeprefix('torch.')}: {width} per row "
                      f"per step{grid}")

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
            k_ms, l_ms = in_turns(kern, lib)
            extra = {"graph_ms": graph_ms(kern)}
            p_ms = cuda_ms(twin)
            a_ms = cuda_ms(anchored) if anchored is not None else None
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"kernel {name} {tag} /l3/w {(m, n)}: kernel_ms {k_ms} "
                  f"anchored_ms {a_ms} ref_ms {p_ms} bound_ms {b_ms} "
                  f"({b_by}) library_ms {l_ms} graph_ms {extra['graph_ms']} "
                  f"max_abs_err {errs[name]} GB/s {nbytes / k_ms / 1e6}")
            if name == "flat_gram_row":
                print(f"K4 /l3/w {tag}: " + (
                    f"kernel / torch.mv {k_ms / l_ms} (same call, in turns)"
                    if l_ms else f"no library call; {nbytes / k_ms / 1e6} "
                    f"GB/s, {b_ms / k_ms} of the bound"))
            if name in ("flat_combine", "flat_gram"):
                kernel, call = (("K5", "c @ x") if name == "flat_combine"
                                else ("K6", "x @ x.T"))
                print(f"{kernel} /l3/w {tag}: " + (
                    f"kernel / {call} {k_ms / l_ms} (same call, in turns)"
                    if l_ms else "no library call")
                    + f"; {nbytes / k_ms / 1e6} GB/s, {b_ms / k_ms} of the "
                    f"bound; CUDA-graph replay {extra['graph_ms']} ms, "
                    f"{b_ms / extra['graph_ms']} of the bound")
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
        require(torch.equal(got, got.transpose(1, 2)),
                f"flat_gram {tag} not exactly symmetric")
    got = kc.combine(x, c)
    close("flat_combine", got, kc.combine_ref(x, c))
    require(torch.equal(got, kc.combine(x, c)),
            f"flat_combine {tag} not repeatable")


# kernels whose ptxas report must show no spill: K7's Hopper design, K1, K5,
# K7b's Hopper design at the LM's head size 64, and K3 and K6
# (arena_gram_k, gram_flat) where m <= 16
NO_SPILL = ("flash_wgmma", "arena_row", "combine_flat", "bwd_rows_wgmma<64>",
            "bwd_dkdv_wgmma<64>", "bwd_dq_wgmma<64>")
# K7b's Hopper kernels, which ptxas must report at d 64 and 128
BWD_KERNELS = ("bwd_rows_wgmma", "bwd_dkdv_wgmma", "bwd_dq_wgmma")
NO_SPILL_M16 = ("arena_gram_k", "gram_flat")


def _kernel_name(mangled):
    """flash_wgmma<64> and flash_wgmma<64,lse> (K7), bwd_rows_wgmma<64>,
    bwd_dkdv_wgmma<64> and bwd_dq_wgmma<64> (K7b's Hopper design),
    row_part<float,16,vec=1> (K4), arena_row<...>
    (K1), combine_flat<...> (K5), arena_gram_k<...> (K3) and
    gram_flat<...> (K6) from ptxas's mangled names, with their MMAX (None
    for K7 and K7b)."""
    if m := re.search(r"flash_wgmmaILi(\d+)E", mangled):
        lse = ",lse" if "ProblemLse" in mangled else ""   # with its LSE
        return f"flash_wgmma<{m.group(1)}{lse}>", None
    if m := re.search(r"(bwd_(?:rows|dkdv|dq)_wgmma)ILi(64|128)E", mangled):
        return f"{m.group(1)}<{m.group(2)}>", None       # K7b, Hopper
    if m := re.search(r"(row_part|arena_row|combine_flat|arena_gram_k|"
                      r"gram_flat)I(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                      mangled):
        dtype = "float" if m.group(2) == "f" else "bf16"
        return (f"{m.group(1)}<{dtype},{m.group(3)},vec={m.group(4)}>",
                int(m.group(3)))
    return None, None


def report_ptxas():
    """Phase 2: registers, shared memory and spills of the Hopper K7 design
    and of K1 and K3-K6, from ptxas -v; those in NO_SPILL, and K3's and
    K6's instantiations for m <= 16, must not spill. Every K3 and K6
    instantiation must be in the report."""
    seen = set()
    for mangled, res in sorted(_build.kernel_resources(
            _build.ptxas_log()).items()):
        name, mmax = _kernel_name(mangled)
        if name is None:
            continue
        seen.add(name)
        print(f"ptxas {name}: {res.get('registers')} registers, static smem "
              f"{res['smem']} B, stack {res.get('stack')} B, spill stores "
              f"{res.get('spill_stores')} B, spill loads "
              f"{res.get('spill_loads')} B")
        if name.startswith(NO_SPILL) or (name.startswith(NO_SPILL_M16)
                                         and mmax <= 16):
            require(res.get("spill_stores") == 0 and
                    res.get("spill_loads") == 0, f"{name} spills: {res}")
    want = {f"{k}<{d},{mm},vec={v}>" for k in NO_SPILL_M16
            for d in ("float", "bf16") for mm in (8, 16, 32) for v in (0, 1)}
    want |= {f"{k}<{d}>" for k in BWD_KERNELS for d in (64, 128)}
    want |= {f"flash_wgmma<{d}{lse}>" for d in (64, 128)
             for lse in ("", ",lse")}
    require(want <= seen, f"ptxas report lacks {sorted(want - seen)}")
    # ptxas's notes where it serialises a kernel's wgmma (it then waits for
    # each product before the next instruction): printed, not required
    for line in _build.ptxas_log().splitlines():
        if "wgmma" in line and "serialized" in line:
            print(f"ptxas note: {line.strip()}")


# ms/step of each counted paper-loop run, by name
MS_PER_STEP = {}
JUMPS = {}                    # path -> (jump loss ratios, reverted steps)
TABLES = {}                   # path -> its accelerator's plan_table()
WINDOW = {}                   # scope -> the 124-step run (step 123's state)
RUNS_11B = {}                 # phase 11(b) run -> its per-step losses


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
    MS_PER_STEP[what] = wall / STEPS * 1e3
    JUMPS[what] = (res.jumps, res.reverted)
    print(f"{what}: {STEPS} steps in {wall} s, ms/step "
          f"{wall / STEPS * 1e3}, launches {launches}, jumps "
          f"{len(res.jumps)}, reverted {res.reverted}")
    if cfg.mode == "eig":
        eig = dmd_math.eig_stats()
        n_sys = sum(b.gram_lead(cfg.scope)
                    for b in res.acc.arena_for(res.params).values())
        print(f"{what}: host eig round trips {eig['calls']} of "
              f"{eig['systems']} systems, the guard's matpow fallbacks "
              f"{eig['fallbacks']}")
        require((eig["calls"], eig["systems"]) == (
            len(res.jumps), len(res.jumps) * n_sys),
            f"{what}: host eigs {eig}, expected one per jump")
    if cfg.enabled and cfg.arena:
        TABLES[what] = res.acc.plan_table()
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
    WINDOW["leaf"] = res
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
          f"{res.losses[0]} -> {res.losses[-1]}; jump ratios {res.jumps}, "
          f"reverted {res.reverted}")
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
        g_ms = graph_ms(lambda: kf.flash_attention(q, k, v))
        print(f"K7 {case[:6]}: CUDA-graph replay {g_ms} ms, {b_ms / g_ms} "
              "of the bound")
        if record is None:
            record = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=l_ms, max_abs_err=err,
                          graph_ms=g_ms)
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


# -- phase 10: the Trainer ---------------------------------------------------

# fig4's gated run (benchmarks/paper_benches.py::_train_gated): the
# validation-gated controller with the shrink ladder and meta-tuning
GATED_CTRL = pb.GATED_CTRL
GATED_DMD = dict(m=14, s=55, tol=1e-4, warmup_steps=100, cooldown_steps=10)
GATED_STEPS, VAL_ROWS = 600, 150


def _trainer_acfg(dmd, rows=ROWS):
    return ArchConfig(model=ModelConfig(name="pollutant-mlp", family="mlp"),
                      dmd=dmd, optimizer=OptimizerConfig(name="adam",
                                                         lr=paper_loop.LR),
                      train=TrainConfig(global_batch=rows, seq_len=1),
                      shapes=())


def _fit_counted(what, trainer, batch, steps, want, ungated=False):
    """One Trainer.fit from a fresh state, counted (the counts set to 0
    just before, read just after), timed on the host clock around a
    synchronised run; loss finite and falling. An ungated run takes every
    jump, and at this config the jumps raise the loss (the paper loop's
    guard reverts all 8 of phase 4's; ROADMAP Queue 3: the trust region's
    fp32 quadratic form), so there the loss must fall over the Adam steps
    before the first jump, and each jump's effect is printed. Returns
    (state, losses, wall, launches, outcomes)."""
    losses, outcomes = [], []

    def on_m(t, m):
        losses.append(m["loss"])
        if "ctrl_outcome" in m:
            outcomes.append(m["ctrl_outcome"])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    st = trainer.fit(iter(lambda: batch, None), steps, on_metrics=on_m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = require_counts(what, want)
    loss = torch.stack(losses).cpu().numpy()
    require(np.isfinite(loss).all(), f"{what}: non-finite loss")
    jumps = [t for t in range(steps) if trainer.acc.should_apply(t)]
    last = jumps[0] if ungated and jumps else steps - 1
    require(loss[last] < loss[0],
            f"{what}: loss did not fall: {loss[0]} -> {loss[last]} (step "
            f"{last})")
    print(f"{what}: {steps} steps in {wall} s, ms/step "
          f"{wall / steps * 1e3}, launches {launches}, graphs "
          f"{trainer.graph_stats}, loss {loss[0]} -> {loss[last]} at step "
          f"{last}, {loss[-1]} at the end")
    if ungated and jumps:
        print(f"{what}: loss at each jump step and the step after: "
              + ", ".join(f"{t}: {loss[t]} -> {loss[t + 1]}" for t in jumps
                          if t + 1 < steps))
    return st, loss, wall, launches, outcomes


def _clone_state(st):
    return map_with_paths(lambda _, x: x.clone(), st)


def check_graph_steps(dev, acfg, batch):
    """A captured-then-replayed train step writes the same bits into every
    state tensor as the same step run eagerly on a copy of the state: the
    plain step (its capture at step 1) and the slot-0 record step (its
    capture at step 134, the second window), at full width. Then the
    replay time of the plain graph alone. Returns its ms per step."""
    tr = Trainer(MLPModel(PAPER_SIZES), acfg, device=dev)
    st = state_resident(tr.acc, tr.acfg, tr.init_state())
    graphed = train_loop._GraphedSteps(tr.train_step, dev)
    checked = []
    for t in range(135):
        slots = tr.acc.slots(t)
        key = train_loop.graph_key(slots)
        twin = None
        if key in graphed.warm and key not in graphed.graphs:
            twin = _clone_state(st)
            tr.train_step(twin, batch, slots)
        graphed(st, batch, slots, key)
        if twin is not None:
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(leaves_with_paths(st), leaves_with_paths(twin)))
            require(same, f"graph key {key} at step {t}: the replayed step "
                    "differs from the eager step")
            checked.append((t, key))
            del twin
        if tr.acc.apply_groups(t):
            st, _ = tr.dmd_step(st, tr.acc.relax_vector(t),
                                groups=tr.acc.apply_groups(t))
    require([t for t, _ in checked] == [1, 134] and checked[1][1] == (0,),
            f"graph checks ran at {checked}")
    torch.cuda.synchronize()
    for handle in (graphed.side.cuda_stream, kd.stream()):
        require(not kd.tickets(dev, handle, 1).any(),
                "tickets not left at zero after the replays")
    print(f"trainer: captured steps bit-identical to eager steps at {checked}"
          " (every state tensor); tickets at zero after the replays")
    graph, _, _ = graphed.graphs[train_loop.PLAIN]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        graph.replay()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 100 * 1e3
    dev_ms = cuda_ms(graph.replay, iters=100)
    print(f"trainer: plain-step graph replay {host_ms} ms/step (host clock, "
          f"synchronised), {dev_ms} ms/step (CUDA events)")
    return host_ms


def _device_us(evt):
    """An event's own device time in us (0 for host events), under the
    attribute names torch.profiler has used."""
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total",
                 "device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profiled_busy(what, trainer, batch, steps):
    """Busy share of the device under torch.profiler over one fit: summed
    kernel time over the profiled wall (one stream at a time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(iter(lambda: batch, None), steps)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    rows = sorted(((_device_us(e), e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print(f"{what}: profiled wall {pwall} s, no device time in the trace "
              "(busy share not measured)")
        return None
    print(f"{what}: profiled wall {pwall} s ({pwall / steps * 1e3} ms/step), "
          f"device kernel time {busy_us / 1e6} s, busy share "
          f"{busy_us / 1e6 / pwall}, idle share {1 - busy_us / 1e6 / pwall}")
    print(f"{what}: top kernels by device time (us total, launches, share, "
          "name):")
    for us, count, key in rows[:8]:
        print(f"  {us:12.1f} {count:6d} {us / busy_us:7.3f}  {key[:90]}")
    return busy_us / 1e6 / pwall


def run_trainer(dev, X, Y, paper_ms):
    """Phase 10: the Trainer at full width. (a) the default DMDConfig
    (arena, resident, streaming) graphed and eager; (b) arena=False; (c)
    fig4's gated run with meta-tuning, beside an ungated and a DMD-off run
    of the same rows. Returns {phase: launches} and the witnesses phase 12
    resumes against: (a)'s graphed run (losses, final state) and (c)'s
    gated run (final state, its rows, its config)."""
    batch = {"x": torch.as_tensor(X, device=dev),
             "y": torch.as_tensor(Y, device=dev)}
    acfg = _trainer_acfg(DMDConfig())
    want = {"gram_row": 112, "combine": 8}
    out = {}

    # (a) graphed against eager, same init and batches
    tr_g = Trainer(MLPModel(PAPER_SIZES), acfg, device=dev)
    st_g, loss_g, wall_g, out["a"], _ = _fit_counted(
        "trainer (a) graphed", tr_g, batch, STEPS, want, ungated=True)
    tr_e = Trainer(MLPModel(PAPER_SIZES), acfg, device=dev,
                   cuda_graphs=False)
    st_e, loss_e, wall_e, _, _ = _fit_counted(
        "trainer (a) eager", tr_e, batch, STEPS, want, ungated=True)
    same_loss = np.array_equal(loss_g, loss_e)
    same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_paths(st_g.params), leaves_with_paths(st_e.params)))
    print(f"trainer (a): graphed run vs eager run: losses bit-identical "
          f"{same_loss}, final params bit-identical {same_params}")
    require(same_loss and same_params,
            "trainer (a): the graphed run differs from the eager run")
    replay_ms = check_graph_steps(dev, acfg, batch)
    print(f"trainer (a) ms/step: graphed {wall_g / STEPS * 1e3}, eager "
          f"{wall_e / STEPS * 1e3}, plain-step replay {replay_ms}; phase 4 "
          f"paper_loop {paper_ms}")
    # step 123 closes the first window: carried Gram against K3
    tr = Trainer(MLPModel(PAPER_SIZES), acfg, device=dev)
    st = tr.fit(iter(lambda: batch, None), 124)
    require(tr.acc.slot(123) == 13, "step 123 is not slot m-1")
    arenas, agrams = st.dmd_buffers["__arena__"], st.dmd_gram["__arena__"]
    for key, b in tr.acc.arena_for(st.params).items():
        _require_gram(f"trainer {key} carried vs K3", agrams[key], ka.gram(
            arenas[key], b.tables_on(dev), anchor_first=True))
    _profiled_busy("trainer (a) graphed, profiled",
                   Trainer(MLPModel(PAPER_SIZES), acfg, device=dev), batch,
                   STEPS)

    # (b) the per-leaf route
    acfg_b = _trainer_acfg(dataclasses.replace(DMDConfig(), arena=False))
    _, _, _, out["b"], _ = _fit_counted(
        "trainer (b) per-leaf graphed",
        Trainer(MLPModel(PAPER_SIZES), acfg_b, device=dev), batch, STEPS,
        {"flat_gram_row": 112 * 8, "flat_combine": 8 * 8}, ungated=True)
    _profiled_busy("trainer (b) per-leaf graphed, profiled",
                   Trainer(MLPModel(PAPER_SIZES), acfg_b, device=dev), batch,
                   STEPS)

    # (c) fig4's gated run: 1000 training rows, a disjoint 150-row
    # validation fold (the gate) and a 150-row test fold, one teacher
    Xa, Ya = synthetic_regression(seed=0, n=ROWS + 2 * VAL_ROWS,
                                  n_out=PAPER_SIZES[-1])
    rows = {name: {"x": torch.as_tensor(Xa[lo:hi], device=dev),
                   "y": torch.as_tensor(Ya[lo:hi], device=dev)}
            for name, lo, hi in (("train", 0, ROWS),
                                 ("val", ROWS, ROWS + VAL_ROWS),
                                 ("test", ROWS + VAL_ROWS, None))}
    gated = DMDConfig(**GATED_DMD,
                      controller=DMDControllerConfig(**GATED_CTRL))
    tr_c = Trainer(MLPModel(PAPER_SIZES), _trainer_acfg(gated), device=dev,
                   val_batch=rows["val"])
    n_rec = sum(tr_c.acc.should_record(t) for t in range(GATED_STEPS))
    n_jump = sum(tr_c.acc.should_apply(t) for t in range(GATED_STEPS))
    st_c, _, _, out["c"], outcomes = _fit_counted(
        "trainer (c) gated", tr_c, rows["train"], GATED_STEPS,
        {"gram_row": n_rec + n_jump, "combine": n_jump})
    bwd = ka.BWD_LAUNCHES["gram_row_bwd"]
    require(bwd == n_jump, f"trainer (c): {bwd} K1 backward launches, "
            f"expected {n_jump}")
    print(f"trainer (c): {n_rec} records, {n_jump} jumps: K1 {n_rec} + "
          f"{bwd} as K2's backward, K2 {n_jump}; outcomes accept "
          f"{outcomes.count(2)}, scaled {outcomes.count(1)}, reject "
          f"{outcomes.count(0)} ({outcomes})")
    ccfg, c = gated.controller, st_c.controller
    s_eff, relax, ridge = (c.s_eff.cpu().numpy(), c.relax_eff.cpu().numpy(),
                           c.ridge_eff.cpu().numpy())
    require(np.isfinite(s_eff).all() and np.isfinite(relax).all()
            and np.isfinite(ridge).all(), "trainer (c): non-finite knobs")
    require(((s_eff >= max(ccfg.s_min, 1.0)) & (s_eff <= GATED_DMD["s"])
             ).all() and ((relax >= ccfg.relax_floor) & (relax <= 1.0)).all()
            and ((ridge >= 0.0) & (ridge <= ccfg.ridge_max)).all(),
            f"trainer (c): knobs outside their clamps: s_eff {s_eff}, "
            f"relax_eff {relax}, ridge_eff {ridge}")
    print(f"trainer (c): s_eff {s_eff}, relax_eff {relax}, ridge_eff "
          f"{ridge}")
    finals = {"gated": st_c}
    for name, dmd in (("ungated", DMDConfig(**GATED_DMD)),
                      ("dmd-off", DMDConfig(enabled=False))):
        tr = Trainer(MLPModel(PAPER_SIZES), _trainer_acfg(dmd), device=dev)
        n_rec = sum(tr.acc.should_record(t) for t in range(GATED_STEPS))
        n_jump = sum(tr.acc.should_apply(t) for t in range(GATED_STEPS))
        finals[name], _, _, _, _ = _fit_counted(
            f"trainer (c) {name}", tr, rows["train"], GATED_STEPS,
            {"gram_row": n_rec, "combine": n_jump}, ungated=n_jump > 0)
    for name, st in finals.items():
        mse = {split: float(mse_loss(st.params, rows[split]["x"],
                                     rows[split]["y"]))
               for split in ("train", "test")}
        print(f"trainer (c) final MSE {name}: train {mse['train']} test "
              f"{mse['test']}")
    return out, {"a": (loss_g, st_g), "c": (st_c, rows, gated)}


# -- phase 11: the paper's problem -------------------------------------------

# the paper's dataset at its scale (§4: 1000 LHS samples, 2670 probes) on
# the reference's default 96 x 48 grid and iteration cap
POLLUTANT = dict(n_samples=1000, nx=96, ny=48, n_points=PAPER_SIZES[-1],
                 n_iter=4000, seed=0)
EPOCHS = 3000                 # the paper's
# the launcher's DMD run (examples/pollutant_regression.py's default)
PAPER_DMD = dict(m=14, s=55, tol=1e-4, warmup_steps=100, cooldown_steps=10)
# 11(b)'s DMD run when it carried streaming Grams (NVIDIA H100 80GB HBM3,
# 700 W, PR 18), and 13(a)'s (PR 20)
STREAMING_11B = "0.012318, 14 of 120 jumps accepted"
STREAMING_13A = "212 of 212 jumps reverted, equal to DMD off"
# the card's march against the port's CPU march of the same samples
# (tests/test_torch_data.py's bound against the reference): each sample's
# iteration count equal or off by one, c3 within 5 * tol absolute
CPU_SAMPLES, MARCH_TOL = 8, 1e-5


def check_pollutant_data(dev):
    """Phase 11(a): the dataset on the card, 8 samples' c3 held against
    the CPU march. Returns (data, solve)."""
    data, solve = pollutant.solve_dataset(device=dev, **POLLUTANT)
    n, it, cap = POLLUTANT["n_samples"], solve.iters, POLLUTANT["n_iter"]
    print(f"pollutant (a): {n} samples at {POLLUTANT['nx']}x"
          f"{POLLUTANT['ny']}, {POLLUTANT['n_points']} probes: shooting + "
          f"velocity fields {solve.shoot_s} s (host), march {solve.march_s} "
          f"s (card, synchronised); iterations min {it.min()} median "
          f"{np.median(it)} max {it.max()}, {int((it >= cap).sum())} at the "
          f"cap {cap}; c3 max {solve.c3.max()}")
    require(data["X"].shape == (n, 6) and data["Y"].shape == (
        n, POLLUTANT["n_points"]), f"pollutant (a): shapes {data['X'].shape}"
            f" {data['Y'].shape}")
    require(np.isfinite(data["Y"]).all(), "pollutant (a): non-finite Y")
    require(np.abs(data["X"]).max() <= 1.0, "pollutant (a): |X| > 1")
    peak = np.abs(data["Y"]).max(axis=1)
    print(f"pollutant (a): Y's largest |value| per sample: quantiles 50/90/"
          f"99/100% {np.quantile(peak, [0.5, 0.9, 0.99, 1.0]).tolist()}, "
          f"{int((peak > 10).sum())} samples above 10 (y_scale "
          f"{data['y_scale']}, y_mean {data['y_mean']})")
    # 8 samples: the fastest, the slowest and 6 spread over the batch
    pick = sorted({int(it.argmin()), int(it.argmax()),
                   *np.linspace(0, n - 1, CPU_SAMPLES - 2).astype(int).tolist()})
    p = data["params_raw"][pick]
    X, Y = pollutant.make_grid(POLLUTANT["nx"], POLLUTANT["ny"])
    eta, f, fp = pollutant.solve_blasius_batch(p[:, 3], p[:, 4], p[:, 5])
    ux, uy = zip(*(pollutant.velocity_field(r[3], r[4], r[5], X, Y,
                                            (eta, f[i], fp[i]))
                   for i, r in enumerate(p)))
    dx, dy = 2.0 / (POLLUTANT["nx"] - 1), 1.0 / (POLLUTANT["ny"] - 1)
    t0 = time.perf_counter()
    *_, c3, it_cpu = pollutant.march(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            np.stack(ux), np.stack(uy), p[:, 2], p[:, 0], p[:, 1],
            *pollutant.source_fields(X, Y))), dx, dy, n_iter=cap,
        tol=MARCH_TOL)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(c3.numpy() - solve.c3[pick]).max())
    steps = np.abs(it_cpu.numpy() - it[pick])
    print(f"pollutant (a): samples {pick} card vs CPU march ({cpu_s} s): "
          f"iterations {it[pick].tolist()} vs {it_cpu.tolist()}, max |c3 "
          f"diff| {err} (bit-identical "
          f"{np.array_equal(c3.numpy(), solve.c3[pick])})")
    require(steps.max() <= 1 and err <= 5 * MARCH_TOL,
            f"pollutant (a): card vs CPU: iterations off by {steps.max()}, "
            f"c3 off by {err}")
    return data


def _jump_summary(jumps):
    j = np.asarray(jumps)
    return (f"{len(j)} jumps, loss ratio min {j.min()} median "
            f"{np.median(j)} max {j.max()}, {int((j <= 1).sum())} <= 1")


def run_pollutant_loop(dev, split):
    """Phase 11(b): the launcher's ``run`` for EPOCHS epochs on the 800
    training rows, DMD off and on (arena route, no carried Gram), counted;
    train and test MSE every 200 epochs. Returns ({run: (train MSE, test
    MSE)}, the DMD run's launches)."""
    (Xtr, Ytr), (Xte, Yte) = split
    on = DMDConfig(**PAPER_DMD)
    sched = DMDAccelerator(on, device=dev)
    jumps = [t for t in range(EPOCHS) if sched.should_apply(t)]
    require(jumps == list(range(123, EPOCHS, 24)),
            f"pollutant (b): jumps at {jumps[:4]} ...")
    finals = {}
    for name, cfg, want in (
            ("dmd-off", DMDConfig(enabled=False), {}),
            ("dmd", on, {"gram": len(jumps), "combine": len(jumps)})):
        what = f"pollutant (b) {name}"
        print(f"{what}: the launcher's run, (epoch, train MSE, test MSE):")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = pollutant_regression.run(Xtr, Ytr, Xte, Yte, PAPER_SIZES, cfg,
                                       EPOCHS, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = require_counts(what, want)
        require(res.grams is None, f"{what}: a Gram was carried")
        loss = res.losses
        last = jumps[0] if name == "dmd" else EPOCHS - 1
        require(np.isfinite(loss).all(), f"{what}: non-finite loss")
        require(loss[last] < loss[0], f"{what}: loss did not fall: "
                f"{loss[0]} -> {loss[last]} (step {last})")
        print(f"{what}: {EPOCHS} epochs in {wall} s, ms/step "
              f"{wall / EPOCHS * 1e3} (train + test MSE every 200), launches"
              f" {launches}, loss {loss[0]} -> {loss[last]} at step {last}")
        if res.jumps:
            accepted = sorted(set(jumps) - set(res.reverted))
            print(f"{what}: {_jump_summary(res.jumps)}; accepted "
                  f"{len(accepted)}: {accepted}; reverted "
                  f"{len(res.reverted)}: {res.reverted}")
            dmd_launches = launches
        finals[name] = res.curve[-1][1:]
        RUNS_11B[name] = res.losses
    (tr_b, te_b), (tr_d, te_d) = finals["dmd-off"], finals["dmd"]
    print(f"pollutant (b) final MSE: train dmd-off {tr_b} dmd {tr_d} (off / "
          f"dmd {tr_b / tr_d}); test dmd-off {te_b} dmd {te_d} (off / dmd "
          f"{te_b / te_d}); DMD beats the baseline on test: {te_d < te_b}; "
          f"the streaming route's test MSE (PR 18): {STREAMING_11B}")
    return finals, dmd_launches


def run_pollutant_gated(dev, split, finals):
    """Phase 11(c): fig4's gated Trainer, graphed, for EPOCHS steps on 650
    of the training rows, gated on the other 150, tested on the test
    rows."""
    (Xtr, Ytr), (Xte, Yte) = split
    fit = len(Xtr) - VAL_ROWS

    def rows(x, y):
        return {"x": torch.as_tensor(x, device=dev),
                "y": torch.as_tensor(y, device=dev)}
    train, val = rows(Xtr[:fit], Ytr[:fit]), rows(Xtr[fit:], Ytr[fit:])
    test = rows(Xte, Yte)
    gated = DMDConfig(**GATED_DMD,
                      controller=DMDControllerConfig(**GATED_CTRL))
    tr = Trainer(MLPModel(PAPER_SIZES), _trainer_acfg(gated, fit),
                 device=dev, val_batch=val)
    n_rec = sum(tr.acc.should_record(t) for t in range(EPOCHS))
    n_jump = sum(tr.acc.should_apply(t) for t in range(EPOCHS))
    st, _, _, _, outcomes = _fit_counted(
        "pollutant (c) gated", tr, train, EPOCHS,
        {"gram_row": n_rec + n_jump, "combine": n_jump})
    bwd = ka.BWD_LAUNCHES["gram_row_bwd"]
    require(bwd == n_jump, f"pollutant (c): {bwd} K1 backward launches, "
            f"expected {n_jump}")
    c = st.controller
    print(f"pollutant (c): {n_rec} records, {n_jump} jumps (K1 {n_rec} + "
          f"{bwd}, K2 {n_jump}); outcomes accept {outcomes.count(2)}, "
          f"scaled {outcomes.count(1)}, reject {outcomes.count(0)}; s_eff "
          f"{c.s_eff.cpu().numpy()}, relax_eff {c.relax_eff.cpu().numpy()}, "
          f"ridge_eff {c.ridge_eff.cpu().numpy()}")
    mse = {name: float(mse_loss(st.params, b["x"], b["y"]))
           for name, b in (("train", train), ("val", val), ("test", test))}
    for name, b in (("train", train), ("val", val), ("test", test)):
        with torch.no_grad():
            row = ((mlp_forward(st.params, b["x"])
                    - b["y"]) ** 2).mean(dim=1)
        top = torch.topk(row, 3)
        print(f"pollutant (c) {name} fold: max |Y| "
              f"{float(b['y'].abs().max())}, largest per-row MSE "
              f"{top.values.tolist()} (rows {top.indices.tolist()})")
    (tr_b, te_b), (tr_d, te_d) = finals["dmd-off"], finals["dmd"]
    print(f"pollutant (c) final MSE: gated train {mse['train']} (its {fit} "
          f"rows) val {mse['val']} test {mse['test']}; (b) dmd-off train "
          f"{tr_b} test {te_b}, dmd train {tr_d} test {te_d}")


def run_pollutant(dev):
    """Phase 11: the paper's problem on its own dataset. Returns the split
    and (b)'s final MSEs, which phase 13(a) reuses, and (b)'s DMD run's
    launches."""
    data = check_pollutant_data(dev)
    split = pollutant.train_test_split(data, 0.8)
    finals, launches = run_pollutant_loop(dev, split)
    run_pollutant_gated(dev, split, finals)
    return split, finals, launches


# -- phase 12: checkpoints and the weights channel ---------------------------

def _timed(fn, sink):
    """`fn` wrapped to append its host-clock ms (synchronised) to `sink`."""
    def call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _preempted_fit(trainer, batch, steps, at, sink):
    """fit with SIGTERM sent to this process from on_metrics at step `at`
    (the Trainer's handler then saves step at + 1 and returns); the
    per-step losses go to `sink`. Returns the state and the launches."""
    def on_m(t, m):
        sink.append(m["loss"])
        if t == at:
            os.kill(os.getpid(), signal.SIGTERM)
    torch.cuda.synchronize()
    reset_counts()
    st = trainer.fit(iter(lambda: batch, None), steps, on_metrics=on_m)
    torch.cuda.synchronize()
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    require(int(st.step) == at + 1, f"preempted at {at}: state at step "
            f"{int(st.step)}")
    return st, counts()


def _resumed_fit(trainer, batch, steps, sink):
    torch.cuda.synchronize()
    reset_counts()
    st = trainer.fit(iter(lambda: batch, None), steps,
                     on_metrics=lambda t, m: sink.append(m["loss"]))
    torch.cuda.synchronize()
    return st, counts()


def _same_tree(a, b):
    la, lb = keystr_leaves(a), keystr_leaves(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def _preempt_and_resume(what, dev, make, batch, steps, at, want_losses,
                        want_state, want_launches):
    """Preempt a fresh Trainer (``make(dir)``) by SIGTERM at step `at`,
    resume a fresh one on the same checkpoint dir to `steps`: the losses
    after the restore, the final state and the launches summed over the
    two halves must equal the uninterrupted run's. Prints save ms,
    restore ms and the checkpoint's bytes."""
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as d:
        tr1, save_ms, restore_ms = make(d), [], []
        tr1.save = _timed(tr1.save, save_ms)
        first = []
        _, n1 = _preempted_fit(tr1, batch, steps, at, first)
        nbytes = _dir_bytes(Path(d) / f"step_{at + 1}")
        tr2 = make(d)
        tr2.restore = _timed(tr2.restore, restore_ms)
        second = []
        st, n2 = _resumed_fit(tr2, batch, steps, second)
    launches = {k: n1[k] + n2[k] for k in n1}
    full = {k: want_launches.get(k, 0) for k in launches}
    require(launches == full, f"{what}: launches {n1} + {n2}, expected "
            f"{full}")
    got = torch.stack(first + second).cpu().numpy()
    same_loss = np.array_equal(got, want_losses)
    same_state = _same_tree(st, want_state)
    torch.cuda.synchronize()
    tickets = kd.tickets(dev, kd.stream(), 1).any()
    print(f"{what}: preempted at step {at}, resumed to {steps}: losses "
          f"after the restore bit-identical {same_loss}, final state "
          f"bit-identical {same_state}; launches {n1} + {n2}; save ms "
          f"{save_ms}, restore ms {restore_ms}, checkpoint bytes {nbytes}")
    require(same_loss and same_state, f"{what}: the resumed run differs "
            "from the uninterrupted run")
    require(not tickets, f"{what}: tickets not left at zero")
    return save_ms, restore_ms, nbytes


def run_checkpoint(dev, X, Y, witness):
    """Phase 12: checkpoints and the weights channel at full width."""
    t_phase = time.perf_counter()
    batch = {"x": torch.as_tensor(X, device=dev),
             "y": torch.as_tensor(Y, device=dev)}
    acfg = _trainer_acfg(DMDConfig())
    acc = DMDAccelerator(acfg.dmd, device=dev)
    jumps = [t for t in range(STEPS) if acc.apply_groups(t)]
    mid = next(t for t in range(jumps[0] + 1, jumps[1])
               if acc.should_record(t) and acc.slot(t) >= 1)
    loss_w, st_w = witness["a"]
    print(f"checkpoint (a): the schedule's jumps {jumps}; mid-window "
          f"step {mid} (slot {acc.slot(mid)}), jump step {jumps[1]}")

    # (a) the main path preempted mid-window and on a jump step
    for at in (mid, jumps[1]):
        _preempt_and_resume(
            f"checkpoint (a) at {at}", dev,
            lambda d: Trainer(MLPModel(PAPER_SIZES), acfg, device=dev,
                              checkpoint_dir=d),
            batch, STEPS, at, loss_w, st_w, {"gram_row": 112, "combine": 8})

    # (b) fig4's gated run preempted on a jump step
    st_c, rows, gated = witness["c"]
    acfg_c = _trainer_acfg(gated)
    acc_c = DMDAccelerator(gated, device=dev)
    n_rec = sum(acc_c.should_record(t) for t in range(GATED_STEPS))
    gjumps = [t for t in range(GATED_STEPS) if acc_c.apply_groups(t)]
    at = gjumps[len(gjumps) // 2]
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as d:
        first, second = [], []
        _, n1 = _preempted_fit(Trainer(
            MLPModel(PAPER_SIZES), acfg_c, device=dev, checkpoint_dir=d,
            val_batch=rows["val"]), rows["train"], GATED_STEPS, at, first)
        st, n2 = _resumed_fit(Trainer(
            MLPModel(PAPER_SIZES), acfg_c, device=dev, checkpoint_dir=d,
            val_batch=rows["val"]), rows["train"], GATED_STEPS, second)
    launches = {k: n1[k] + n2[k] for k in n1}
    want = {k: 0 for k in launches}
    want.update(gram_row=n_rec + len(gjumps), combine=len(gjumps))
    require(launches == want, f"checkpoint (b): launches {n1} + {n2}, "
            f"expected {want}")
    ctrl = {f: (getattr(st.controller, f).cpu().numpy(),
                getattr(st_c.controller, f).cpu().numpy())
            for f in st_c.controller._fields}
    same_ctrl = all(np.array_equal(a, b) for a, b in ctrl.values())
    same_params = _same_tree(st.params, st_c.params)
    print(f"checkpoint (b) gated: preempted on jump step {at} of {gjumps}, "
          f"resumed to {GATED_STEPS}: controller bit-identical {same_ctrl} "
          f"(accepts {ctrl['accepts'][0]}, scaled {ctrl['scaled'][0]}, "
          f"rejects {ctrl['rejects'][0]}, s_eff {ctrl['s_eff'][0]}, "
          f"relax_eff {ctrl['relax_eff'][0]}, ridge_eff "
          f"{ctrl['ridge_eff'][0]}), final params bit-identical "
          f"{same_params}; launches {n1} + {n2}")
    require(same_ctrl and same_params, "checkpoint (b): the resumed gated "
            "run differs from the uninterrupted one")

    # (c) the per-leaf route's checkpoint into the arena route, and back
    n = mid
    for w_arena in (False, True):
        cfgs = {a: _trainer_acfg(dataclasses.replace(DMDConfig(), arena=a))
                for a in (w_arena, not w_arena)}
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix=".chip_smoke_") as d:
            tr_w = Trainer(MLPModel(PAPER_SIZES), cfgs[w_arena], device=dev,
                           checkpoint_dir=d)
            st_w8 = tr_w.fit(iter(lambda: batch, None), n)
            tr_w.save(st_w8, n)
            written = tr_w.acc.state_leafwise(st_w8)
            tr_r = Trainer(MLPModel(PAPER_SIZES), cfgs[not w_arena],
                           device=dev, checkpoint_dir=d)
            back = tr_r.restore()
            same = _same_tree(tr_r.acc.state_leafwise(back), written)
            del back, written, st_w8
            st_r, launches = _resumed_fit(tr_r, batch, n + 30, [])
        rec = sum(acc.should_record(t) for t in range(n, n + 30))
        jmp = sum(acc.should_apply(t) for t in range(n, n + 30))
        if w_arena:                 # the per-leaf route: one launch a leaf
            n_leaf = len(leaves_with_paths(st_r.params))
            want = {"flat_gram_row": n_leaf * rec,
                    "flat_combine": n_leaf * jmp}
        else:
            want = {"gram_row": rec, "combine": jmp}
        want = {k: want.get(k, 0) for k in launches}
        loss = float(mse_loss(st_r.params, batch["x"], batch["y"]))
        names = {True: "arena", False: "per-leaf"}
        print(f"checkpoint (c): {names[w_arena]} -> "
              f"{names[not w_arena]} at step {n}: every restored leaf "
              f"bit-identical {same}; 30 more steps: launches {launches}, "
              f"train MSE {loss}")
        require(same, "checkpoint (c): a restored leaf differs")
        require(launches == want and np.isfinite(loss),
                f"checkpoint (c): launches {launches}, expected {want}; "
                f"MSE {loss}")
    run_channel(dev)
    print(f"checkpoint: phase 12 wall {time.perf_counter() - t_phase} s")


def run_channel(dev):
    """Phase 12(d): the weights channel at TinyLlama-1.1B's full width."""
    model, params, hot = launch_serve.build("tinyllama-1.1b", device=dev)
    prompts = launch_serve.request_stream(12, model.cfg.vocab_size)
    bumped = tree_map(lambda t: t * 1.001, params)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as d:
        ch = WeightsChannel(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ch.publish(bumped, 1)
        pub_s = time.perf_counter() - t0
        nbytes = _dir_bytes(d)
        for p in prompts:
            hot.submit(p)
        done = hot.step() + hot.step()
        queued = hot.queue_len
        require(queued > 0 and hot.active_slots > 0, "channel: nothing in "
                "flight or queued at the poll")
        t0 = time.perf_counter()
        version = ch.poll(hot, params)
        torch.cuda.synchronize()
        poll_s = time.perf_counter() - t0
        require(version == 1 and ch.poll(hot, params) is None
                and hot.version == 1, f"channel: poll gave {version}, "
                f"engine at {hot.version}")
        done += hot.run_until_drained()
        hot.sync()
        t0 = time.perf_counter()
        loaded = ch.load(params)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    require(_same_tree(loaded, bumped), "channel: the loaded params differ "
            "from the published ones")
    del bumped
    cold = launch_serve.make_engine(model, loaded)
    rc = {r.uid: r for r in launch_serve.serve(cold, prompts)[0]}
    rh = {r.uid: r for r in done}
    after = sorted(u for u, r in rh.items() if r.version_start == 1)
    during = sorted(u for u, r in rh.items() if r.version_start == 0)
    same = [rh[u].tokens == rc[u].tokens for u in after]
    logits = max(float(np.abs(rh[u].last_logits - rc[u].last_logits).max())
                 for u in after) if after else None
    stamps = sorted({(rh[u].version_start, rh[u].version_end)
                     for u in during})
    print(f"channel: tinyllama-1.1b {model.param_count(params)} bf16 params"
          f", {nbytes} bytes on disk: publish {pub_s} s "
          f"({nbytes / pub_s / 1e9} GB/s), poll (load + stage + swap) "
          f"{poll_s} s, load {load_s} s ({nbytes / load_s / 1e9} GB/s)")
    print(f"channel: {len(during)} requests in flight at the poll (version "
          f"{stamps}), {len(after)} admitted after it; their tokens equal "
          f"the cold engine's: {sum(same)} of {len(after)}, max |last "
          f"logits diff| "
          f"{logits}; dropped {hot.stats['dropped']} / "
          f"{cold.stats['dropped']}")
    require(len(rh) == len(rc) == len(prompts), "channel: requests lost")
    require(after and all(same), "channel: the requests admitted after the "
            "swap differ from the cold engine's")
    require(all((rh[u].version_start, rh[u].version_end) == (0, 1)
                for u in during) and all(
        (r.version_start, r.version_end) == (0, 0) for r in rc.values()),
        "channel: wrong version stamps")
    require(hot.stats["dropped"] == cold.stats["dropped"] == 0,
            "channel: dropped requests")


# -- phase 13: the paper's DMD configuration and bucket scope ---------------

def _require_tickets(what, dev):
    torch.cuda.synchronize()
    require(not kd.tickets(dev, kd.stream(), 1).any(),
            f"{what}: tickets not left at zero")


def run_paper_full(dev, split, finals):
    """Phase 13(a): ``pollutant_regression --full``'s DMD through the
    launcher's ``run`` on phase 11's training rows for EPOCHS epochs,
    counted."""
    (Xtr, Ytr), (Xte, Yte) = split
    cfg = pollutant_regression.full_dmd_config()
    sched = DMDAccelerator(cfg, device=dev)
    jumps = [t for t in range(EPOCHS) if sched.should_apply(t)]
    what = "paper config (a) --full"
    print(f"{what}: the launcher's run, (epoch, train MSE, test MSE):")
    dmd_math.reset_eig_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = pollutant_regression.run(Xtr, Ytr, Xte, Yte, PAPER_SIZES, cfg,
                                   EPOCHS, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = require_counts(what, {"gram": len(jumps),
                                     "combine": len(jumps)})
    _require_tickets(what, dev)
    eig = dmd_math.eig_stats()
    require((eig["calls"], eig["systems"]) == (len(jumps), 8 * len(jumps)),
            f"{what}: host eigs {eig}, expected one per jump of 8 systems")
    loss = res.losses
    require(np.isfinite(loss).all(), f"{what}: non-finite loss")
    require(loss[jumps[0]] < loss[0], f"{what}: loss did not fall before "
            f"the first jump: {loss[0]} -> {loss[jumps[0]]}")
    print(f"{what}: {EPOCHS} epochs in {wall} s, ms/step "
          f"{wall / EPOCHS * 1e3} (train + test MSE every 200), "
          f"{len(jumps)} jumps (first {jumps[:3]}), launches {launches}; "
          f"host eig round trips {eig['calls']} of {eig['systems']} "
          f"systems, the guard's matpow fallbacks {eig['fallbacks']}; loss "
          f"{loss[0]} -> {loss[jumps[0]]} at the first jump, {loss[-1]} at "
          f"the end")
    print(f"{what}: {_jump_summary(res.jumps)}; reverted "
          f"{len(res.reverted)} of {len(jumps)} (the streaming route, PR "
          f"20: {STREAMING_13A})")
    print(f"{what}: jump loss ratios {res.jumps}")
    print(f"{what}: reverted steps {res.reverted}")
    tr_f, te_f = res.curve[-1][1:]
    (tr_b, te_b), (tr_d, te_d) = finals["dmd-off"], finals["dmd"]
    # the moments are kept across jumps, so a run whose every jump is
    # reverted is the DMD-off run, step for step
    same = np.array_equal(loss, RUNS_11B["dmd-off"])
    print(f"paper config (a) final MSE: train --full {tr_f}, 11(b) dmd-off "
          f"{tr_b}, 11(b) dmd {tr_d}; test --full {te_f}, dmd-off {te_b}, "
          f"dmd {te_d}; every per-step loss equal to 11(b) dmd-off's: "
          f"{same}")
    if len(res.reverted) == len(jumps):
        require(same, f"{what}: every jump reverted, yet the losses differ "
                "from 11(b)'s DMD off")
    else:
        print(f"{what}: first accepted jump at step "
              f"{min(set(jumps) - set(res.reverted))}")


def run_bucket_path(dev, X, Y, phase4_grams):
    """Phase 13(b): the main path at bucket scope, counted; the step-123
    Gram against K3 and against phase 4's per-system Grams."""
    cfg = dataclasses.replace(DMDConfig(), scope="bucket")
    launches = run_streaming(dev, X, Y, "bucket path", cfg,
                             {"gram_row": 112, "combine": 8})
    _require_tickets("bucket path", dev)
    table = TABLES["bucket path"].splitlines()
    print("bucket path plan_table:\n" + "\n".join(table))
    head = table[0].split()
    rows = [dict(zip(head, ln.split())) for ln in table[1:]]
    require(all(r["scope"] == "bucket" and r["n_solve"] == "1"
                for r in rows), "bucket path: plan_table rows not at "
            "scope bucket, n_solve 1")
    res = paper_loop.train(X, Y, PAPER_SIZES, cfg, 124, device=dev)
    WINDOW["bucket"] = res
    (b,) = res.acc.arena_for(res.params).values()
    buf, g = res.buffers["__arena__"][b.key], res.grams["__arena__"][b.key]
    require(tuple(g.shape) == (1, 14, 14), f"bucket Gram {tuple(g.shape)}")
    full = ka.gram(buf, b.tables_on(dev, "bucket"), anchor_first=True)
    _require_gram("bucket carried vs K3 (zeros table)", g[0], full[0])
    summed = torch.stack(list(phase4_grams.values())).sum(dim=0)
    _require_gram("bucket carried vs the sum of phase 4's 8 systems", g[0],
                  summed)
    for what in ("main path", "bucket path"):
        ratios, rev = JUMPS[what]
        print(f"bucket (b) {what}: jump ratios {ratios}, reverted {rev}")
    return launches


def run_eig_path(dev, X, Y):
    """Phase 13(c): eig mode at leaf scope on the main path."""
    cfg = dataclasses.replace(DMDConfig(), mode="eig")
    dmd_math.reset_eig_stats()
    launches = run_streaming(dev, X, Y, "eig path", cfg,
                             {"gram_row": 112, "combine": 8})
    for what in ("main path", "eig path"):
        ratios, rev = JUMPS[what]
        print(f"eig (c) {what}: jump ratios {ratios}, reverted {rev}")
    return launches


def run_bucket_eig_trainer(dev, X, Y):
    """Phase 13(d): the Trainer at bucket scope in eig mode, graphed and
    eager. Returns its witness (graphed losses and state) and config."""
    batch = {"x": torch.as_tensor(X, device=dev),
             "y": torch.as_tensor(Y, device=dev)}
    acfg = _trainer_acfg(dataclasses.replace(DMDConfig(), scope="bucket",
                                             mode="eig"))
    want = {"gram_row": 112, "combine": 8}
    runs = {}
    for name, graphs in (("graphed", True), ("eager", False)):
        tr = Trainer(MLPModel(PAPER_SIZES), acfg, device=dev,
                     cuda_graphs=graphs)
        dmd_math.reset_eig_stats()
        st, loss, wall, _, _ = _fit_counted(
            f"trainer (d) bucket eig {name}", tr, batch, STEPS, want,
            ungated=True)
        eig = dmd_math.eig_stats()
        require((eig["calls"], eig["systems"]) == (8, 8),
                f"trainer (d) {name}: host eigs {eig}, expected 8 of 1 "
                "system each")
        if graphs:
            require(tr.graph_stats["captured"] > 0, "trainer (d): nothing "
                    "captured")
        print(f"trainer (d) {name}: host eigs {eig['calls']} (the guard's "
              f"fallbacks {eig['fallbacks']}), graphs {tr.graph_stats}")
        runs[name] = (st, loss, wall)
    (st_g, loss_g, wall_g), (st_e, loss_e, wall_e) = runs["graphed"], \
        runs["eager"]
    same_loss = np.array_equal(loss_g, loss_e)
    same_state = _same_tree(st_g, st_e)
    print(f"trainer (d): graphed vs eager: losses bit-identical {same_loss},"
          f" final state bit-identical {same_state}; ms/step graphed "
          f"{wall_g / STEPS * 1e3}, eager {wall_e / STEPS * 1e3}")
    require(same_loss and same_state, "trainer (d): the graphed run differs "
            "from the eager run")
    _require_tickets("trainer (d)", dev)
    return (loss_g, st_g), acfg, batch


def run_bucket_checkpoint(dev, witness, acfg, batch):
    """Phase 13(e): (d)'s Trainer preempted and resumed; bucket <-> leaf
    scope restores."""
    loss_w, st_w = witness
    acc = DMDAccelerator(acfg.dmd, device=dev)
    jumps = [t for t in range(STEPS) if acc.apply_groups(t)]
    mid = next(t for t in range(jumps[0] + 1, jumps[1])
               if acc.should_record(t) and acc.slot(t) >= 1)

    def replayed(step):
        """K1 rows a bucket-scope restore at `step` replays."""
        k = acc.slot(step - 1)
        return k + 1 if k >= 0 and not acc.should_apply(step - 1) else 0
    for at in (mid, jumps[1]):
        _preempt_and_resume(
            f"bucket checkpoint (e) at {at}", dev,
            lambda d: Trainer(MLPModel(PAPER_SIZES), acfg, device=dev,
                              checkpoint_dir=d),
            batch, STEPS, at, loss_w, st_w,
            {"gram_row": 112 + replayed(at + 1), "combine": 8, "gram": 2})
    # why the restore replays K1: at the mid-window save, the current
    # window's entries of the summed K3 rebuild against the carried ones
    tr = Trainer(MLPModel(PAPER_SIZES), acfg, device=dev)
    st = tr.fit(iter(lambda: batch, None), mid + 1)
    table = tr.acc.arena_for(st.params)
    agrams = arena_mod.split_state(st.dmd_gram)[0]
    lw = tr.acc.state_leafwise(st)
    summed = arena_mod.grams_from_leafwise(table, by_path(lw.dmd_gram),
                                           "bucket")
    k = acc.slot(mid) + 1
    diff = {key: max_err(summed[key][:, :k, :k], g[:, :k, :k])
            for key, g in agrams.items()}
    arena_mod.restream_grams(summed, arena_mod.split_state(
        st.dmd_buffers)[0], table, acfg.dmd, mid + 1)
    same = all(torch.equal(summed[key][:, :k, :k], g[:, :k, :k])
               for key, g in agrams.items())
    print(f"bucket checkpoint (e) at {mid}: the current window's {k} x {k} "
          f"entries of the summed K3 rebuild vs the carried Gram: max |diff|"
          f" {diff}; after the K1 replay bit-identical {same}")
    require(same, "bucket checkpoint (e): the replayed rows differ from "
            "the carried ones")
    del tr, st, lw, summed, agrams
    n = mid
    for w_scope, r_scope in (("bucket", "leaf"), ("leaf", "bucket")):
        cfgs = {s: _trainer_acfg(dataclasses.replace(acfg.dmd, scope=s))
                for s in (w_scope, r_scope)}
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix=".chip_smoke_") as d:
            tr_w = Trainer(MLPModel(PAPER_SIZES), cfgs[w_scope], device=dev,
                           checkpoint_dir=d)
            st_wn = tr_w.fit(iter(lambda: batch, None), n)
            torch.cuda.synchronize()
            reset_counts()
            tr_w.save(st_wn, n)
            torch.cuda.synchronize()
            save_k3 = counts()["gram"]
            require(save_k3 == (w_scope == "bucket"), f"bucket checkpoint "
                    f"(e): a {w_scope}-scope save launched K3 {save_k3} "
                    "times")
            written = tr_w.acc.state_leafwise(st_wn)
            tr_r = Trainer(MLPModel(PAPER_SIZES), cfgs[r_scope], device=dev,
                           checkpoint_dir=d)
            back = restore_checkpoint(d, tr_r.acc.state_leafwise(
                tr_r.init_state()))
            same = _same_tree(back, written)
            del back, written, st_wn
            st_r, launches = _resumed_fit(tr_r, batch, n + 30, [])
        rec = sum(acc.should_record(t) for t in range(n, n + 30))
        jmp = sum(acc.should_apply(t) for t in range(n, n + 30))
        bucket_r = r_scope == "bucket"
        want = {"gram_row": rec + (replayed(n) if bucket_r else 0),
                "combine": jmp, "gram": int(bucket_r)}
        want = {k: want.get(k, 0) for k in launches}
        loss = float(mse_loss(st_r.params, batch["x"], batch["y"]))
        print(f"bucket checkpoint (e): {w_scope} scope -> {r_scope} scope at "
              f"step {n}: every restored leaf bit-identical {same}; the "
              f"save launched K3 {save_k3} times; 30 more steps: launches "
              f"{launches}, train MSE {loss}")
        require(same, "bucket checkpoint (e): a restored leaf differs")
        require(launches == want and np.isfinite(loss),
                f"bucket checkpoint (e): launches {launches}, expected "
                f"{want}; MSE {loss}")


def _lam_max(table):
    row = table.splitlines()[1].split()
    return int(row[3]), float(row[4])


def run_spectrum(dev):
    """Phase 13(f): spectrum_table at step 123 in both scopes, from the
    carried Grams and from K3's recompute."""
    got = {}
    for scope in ("leaf", "bucket"):
        res = WINDOW[scope]
        for tol in (None, 1e-2):
            acc = res.acc
            if tol is not None:
                acc = DMDAccelerator(dataclasses.replace(acc.cfg, tol=tol),
                                     device=dev)
                acc.arena_for(res.params)
            carried = acc.spectrum_table(res.buffers, res.grams)
            torch.cuda.synchronize()
            reset_counts()
            recomputed = acc.spectrum_table(res.buffers)
            torch.cuda.synchronize()
            require_counts(f"spectrum (f) {scope} recompute", {"gram": 1})
            print(f"spectrum (f) {scope} scope, tol {acc.cfg.tol}, carried:"
                  f"\n{carried}\nspectrum (f) {scope} scope, tol "
                  f"{acc.cfg.tol}, K3's recompute (1 launch):\n{recomputed}")
            got[(scope, tol, "carried")] = _lam_max(carried)
            got[(scope, tol, "K3")] = _lam_max(recomputed)
    # at the config's tol 1e-4 the smallest kept modes sit at the fp32
    # noise floor (the kept rank itself moves between a carried Gram and
    # its recompute): printed, finite required; at tol 1e-2 two modes are
    # kept well above it and the four rows must agree
    for tol, rtol in ((None, None), (1e-2, 2e-3)):
        vals = {k: v for k, v in got.items() if k[1] == tol}
        lam = [v[1] for v in vals.values()]
        spread = (max(lam) - min(lam)) / max(lam)
        print(f"spectrum (f) tol {tol or 'of the config'}: (rank, |lam|max) "
              f"{vals}; relative spread {spread} (limit {rtol})")
        require(np.isfinite(lam).all() and (rtol is None or spread <= rtol),
                f"spectrum (f): |lam|max {lam}, spread {spread} > {rtol}")


def check_bucket_kernels(dev, records):
    """Phase 13(g): K1 and K3 at the bucket-scope shape, n_sys 1, against
    their twins and timed beside the einsum that computes the same
    function; the times go into K1's and K3's records."""
    params = init_mlp(torch.Generator().manual_seed(0), PAPER_SIZES,
                      device=dev)
    (bucket,) = DMDAccelerator(DMDConfig(scope="bucket"),
                               device=dev).arena_for(params).values()
    seg = bucket.tables_on(dev, "bucket")
    nb, m, bn = bucket.n_blocks, bucket.m, bucket.block_n
    require(seg.n_sys == 1 and (nb, m, bn) == (5633, 14, 512),
            f"bucket-scope table: {seg.n_sys} systems, {(nb, m, bn)}")
    x = torch.randn((nb, m, bn), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    q = x[:, m - 1, :]
    xbytes = x.numel() * 4
    runs = {
        "gram_row": (lambda: ka.gram_row(x, q, seg),
                     lambda: ka.gram_row_ref(x, q, seg.block_sys, 1),
                     lambda: torch.einsum("bmn,bn->m", x, q)[None],
                     xbytes + m * 4, 2.0 * nb * m * bn, "K1"),
        "gram": (lambda: ka.gram(x, seg),
                 lambda: ka.gram_ref(x, seg.block_sys, 1),
                 lambda: torch.einsum("bmn,bkn->mk", x, x)[None],
                 xbytes + m * m * 4, 2.0 * nb * m * m * bn, "K3"),
    }
    for name, (kern, twin, lib, nbytes, flops, tag) in runs.items():
        got, want, call = kern(), twin(), lib()
        err = check_close(f"{tag} bucket scope", got, want, 1)
        check_close(f"{tag} bucket scope vs einsum", call, want, 1)
        require(torch.equal(got, kern()), f"{tag} bucket scope not "
                "repeatable")
        _require_tickets(f"{tag} bucket scope", dev)
        k_ms, l_ms = in_turns(kern, lib)
        p_ms = cuda_ms(twin)
        k_graph, l_graph = graph_ms(kern), graph_ms(lib)
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"{tag} bucket scope (5633, 14, 512) n_sys 1 float32 anchor "
              f"none: kernel_ms {k_ms} graph_ms {k_graph}, einsum ms {l_ms} "
              f"graph_ms {l_graph} (kernel / einsum {k_ms / l_ms}, replays "
              f"{k_graph / l_graph}), twin ms {p_ms}, bound_ms {b_ms} "
              f"({b_by}), {b_ms / k_graph} of the bound replayed, "
              f"max_abs_err {err}")
        records[name].update(
            bucket_ms=k_ms, bucket_graph_ms=k_graph, bucket_plain_ms=p_ms,
            bucket_library_ms=l_ms, bucket_library_graph_ms=l_graph,
            bucket_bound_ms=b_ms, bucket_max_abs_err=err)


def run_paper_config(dev, X, Y, phase4_grams, split, finals, records):
    """Phase 13: the paper's DMD configuration and bucket scope. Returns
    {path: launches}."""
    t_phase = time.perf_counter()
    run_paper_full(dev, split, finals)
    out = {"bucket": run_bucket_path(dev, X, Y, phase4_grams),
           "eig": run_eig_path(dev, X, Y)}
    witness, acfg, batch = run_bucket_eig_trainer(dev, X, Y)
    run_bucket_checkpoint(dev, witness, acfg, batch)
    del witness
    run_spectrum(dev)
    WINDOW.clear()
    check_bucket_kernels(dev, records)
    print(f"paper config: phase 13 wall {time.perf_counter() - t_phase} s")
    return out


# -- phase 14: the paper benches ---------------------------------------------

# fig4's size (benchmarks/paper_benches.py::fig4_runs): the 900-row
# teacher split 600 / 150 / 150, the MLP (6, 40, 200, 400), 600 steps. Its
# DMD run (``_train``: no guard) on the card against the CPU's twins from
# the same seeded init: the curve within 1e-5 before the first jump (fp32
# summation order), the first jump's loss ratio within FIG4_TOL (the CPU
# tests' bound after a jump), and after it each sampled train and test MSE
# within FIG4_ENVELOPE (relative) of the CPU run's. The jumps after the
# first are decided by fp32 rounding: the rank mask at tol 1e-4 reads
# eigenvalue ratios of 1e-8, under fp32's 1.2e-7. So the bound there is the
# reference's own spread: per sampled step (0, 50, ..., 550, 599), the
# largest relative difference between two of the reference's runs from
# this init scaled by 1 + k * 1e-7, k in 0, +-1, +-2, +-3, +-5, +-10
# (examples/torch_noise_floor.py --case fig4, on the CPU).
FIG4_SIZES, FIG4_STEPS = (6, 40, 200, 400), 600
FIG4_TOL = 2e-3
FIG4_ENVELOPE = (0.0, 0.0, 0.0, 114.3714, 5.7297, 1.1974, 0.677, 2.9489, 1.024,
                 0.6281, 0.4601, 0.3476, 0.3057)
# the suites' timed repetitions (their defaults): sec3, streaming_gram and
# staggered_jump take one warm-up call and BENCH_REPS timed ones; the
# controller times each jump step once warm and CTRL_REPS times
BENCH_REPS, CTRL_REPS = 10, 7


def _windows(cfg, steps):
    """(records, jumps) of a one-group schedule over `steps` steps."""
    acc = DMDAccelerator(cfg, device="cpu")
    return (sum(acc.should_record(t) for t in range(steps)),
            sum(acc.should_apply(t) for t in range(steps)))


def _counted(what, fn, want):
    """fn(), its launches counted (set to 0 just before, required equal to
    `want` just after) and its wall printed."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"{what}: {wall} s, launches {require_counts(what, want)}")
    return out


def check_fig4(runs):
    """Phase 14: fig4's runs from the counted suite run: the gated
    Trainer's outcomes and graph stats, and the DMD run against the same
    run on the CPU."""
    n_rec, n_jump = _windows(DMDConfig(**pb.FIG4_DMD), FIG4_STEPS)
    what = "benches fig4 gated"
    curve, outcomes, graphs, wall = runs["gated"]
    bwd = ka.BWD_LAUNCHES["gram_row_bwd"]
    require(bwd == n_jump, f"{what}: {bwd} K1 backward launches, expected "
            f"{n_jump}")
    require(sum(outcomes.values()) == n_jump,
            f"{what}: outcomes {outcomes} for {n_jump} jumps")
    require(np.isfinite(np.asarray(curve)).all(), f"{what}: non-finite MSE")
    print(f"{what}: {FIG4_STEPS} steps in {wall} s ({wall / FIG4_STEPS * 1e3}"
          f" ms/step, 13 fit calls and their curve MSEs included), K1 "
          f"{n_rec} + {bwd} backward, K2 {n_jump}; outcomes (0 reject, 1 "
          f"scaled, 2 accept) {outcomes}; graph_stats summed over the fit "
          f"calls {graphs}; final (step, train MSE, test MSE) {curve[-1]}")

    what = "benches fig4 dmd"
    X, Y, _, _, Xte, Yte = pb.fig4_split()
    first = next(t for t in range(FIG4_STEPS)
                 if DMDAccelerator(DMDConfig(**pb.FIG4_DMD),
                                   device="cpu").should_apply(t))
    card, j_card = runs["dmd"]
    t0 = time.perf_counter()
    cpu, j_cpu = pb._train(DMDConfig(**pb.FIG4_DMD), FIG4_SIZES, X, Y, Xte,
                           Yte, FIG4_STEPS, device="cpu")
    cpu_s = time.perf_counter() - t0
    card, cpu = np.asarray(card), np.asarray(cpu)
    require(card.shape == cpu.shape == (len(FIG4_ENVELOPE), 3),
            f"{what}: curves of {card.shape} and {cpu.shape} samples")
    before = card[:, 0] < first
    rel = np.abs(card[:, 1:] / cpu[:, 1:] - 1).max(axis=1)
    n = min(len(j_card), len(j_cpu))
    rel_j = np.abs(np.asarray(j_card[:n]) / np.asarray(j_cpu[:n]) - 1)
    env = np.asarray(FIG4_ENVELOPE)
    print(f"{what}: card against the CPU's twins ({cpu_s} s there): "
          f"{len(j_card)} and {len(j_cpu)} jumps; curve rel diff before the "
          f"first jump (step {first}) {rel[before].max()}, first jump ratio "
          f"{rel_j[0]}, after it per sampled step {rel[~before].tolist()} "
          f"against the reference's envelope {env[~before].tolist()} (at "
          f"most {(rel[~before] / env[~before]).max()} of it)")
    print(f"{what}: card jump ratios {j_card}")
    print(f"{what}: CPU jump ratios {j_cpu}")
    print(f"{what}: card (step, train MSE, test MSE) {card.tolist()}")
    require(len(j_card) == len(j_cpu) == n_jump,
            f"{what}: {len(j_card)} jumps on the card, {len(j_cpu)} on the "
            f"CPU, {n_jump} scheduled")
    require(np.isfinite(card).all() and np.isfinite(cpu).all(),
            f"{what}: a non-finite MSE")
    require(rel[before].max() <= 1e-5 and rel_j[0] <= FIG4_TOL
            and (rel[~before] <= env[~before]).all(),
            f"{what}: card against CPU {rel.tolist()} (bound 1e-5 before "
            f"step {first}, then {env[~before].tolist()}), first jump ratio "
            f"off by {rel_j[0]} (bound {FIG4_TOL})")


def _staggered_want():
    """K1 and K2 launches of ``staggered_jump`` at its defaults: one K1 per
    recording bucket per fill step, one K2 per bucket per timed jump."""
    params = init_mlp(torch.Generator().manual_seed(0), (6, 800, 800, 800),
                      device="cpu")
    k1 = k2 = 0
    stag = pb.staggered_config(14)
    for cfg in (dataclasses.replace(stag, groups=()), stag):
        acc = DMDAccelerator(cfg, device="cpu")
        table = acc.arena_for(params).values()
        k1 += sum(acc.groups[b.group].should_record(t) for b in table
                  for t in range(pb.staggered_fill(acc)))
        k2 += (1 + BENCH_REPS) * len(table)
    return {"gram_row": k1, "combine": k2}


def _bench_want(name, ref_rows):
    """The launches of suite `name` at its defaults."""
    if name == "sec3_overhead":
        return {"gram": 1 + BENCH_REPS, "combine": 1 + BENCH_REPS}
    if name == "streaming_gram":
        m = 14
        return {"flat_gram_row": m + 1 + BENCH_REPS,
                "flat_combine": 2 * (1 + BENCH_REPS),
                "flat_gram": 1 + BENCH_REPS}
    if name == "staggered_jump":
        return _staggered_want()
    if name == "controller":
        n_rec, n_jump = _windows(DMDConfig(**GATED_DMD), 450)
        return {"gram_row": 2 * n_rec,
                "combine": 2 * n_jump + 2 * (1 + CTRL_REPS)}
    if name == "fig3":
        n = sum(int(r.split(",")[-1]) for r in ref_rows[1:])
        return {"gram": n, "combine": n}
    if name == "fig4":
        n_rec, n_jump = _windows(DMDConfig(**GATED_DMD), FIG4_STEPS)
        return {"gram": n_jump, "combine": 2 * n_jump,
                "gram_row": n_rec + n_jump}
    raise KeyError(name)


def time_bench_kernels(dev, records):
    """Phase 14: the kernels at the benches' new shapes, against their
    twins and timed (eager in turns with the twin or the library call, and
    replayed in a CUDA graph): K4-K6 at streaming_gram's (14, 1, 4000000)
    leaf (fp32, anchored where the bench anchors), K3 (anchored) and K2 at
    fig4's arena. Recorded as the ``bench_*`` fields of each kernel's
    record."""
    m, n = 14, 4_000_000
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((m, 1, n), generator=g, device=dev)
    c = torch.randn((1, m), generator=g, device=dev)
    _check_flat(f"{(m, 1, n)} float32", x, c, 1, False)
    q, x2, c1 = x[m - 1], x.view(m, n), c.view(m)
    xbytes = x.numel() * 4
    params = init_mlp(torch.Generator().manual_seed(0), FIG4_SIZES,
                      device=dev)
    (bucket,) = DMDAccelerator(DMDConfig(**GATED_DMD), device=dev).arena_for(
        params).values()
    seg = bucket.tables_on(dev)
    ab = (bucket.n_blocks, bucket.m, bucket.block_n)
    xa = torch.randn(ab, generator=g, device=dev)
    ca = torch.randn((seg.n_sys, bucket.m), generator=g, device=dev)
    cg = ca[seg.block_sys.to(dev, torch.long)]      # each block's row of c
    abytes = xa.numel() * 4
    runs = {
        "flat_gram_row": (
            (m, 1, n), lambda: kgr.gram_row(x, q, anchor_first=True),
            lambda: kgr.gram_row_ref(x, q, anchor_first=True),
            lambda: torch.mv(x2, q.view(n)), xbytes + m * 4, 2.0 * m * n),
        "flat_combine": (
            (m, 1, n), lambda: kc.combine(x, c), lambda: kc.combine_ref(x, c),
            lambda: c1 @ x2, xbytes + n * 4 + m * 4, 2.0 * m * n),
        "flat_gram": (
            (m, 1, n), lambda: kg.gram(x, anchor_first=True),
            lambda: kg.gram_ref(x, anchor_first=True), lambda: x2 @ x2.T,
            xbytes + m * m * 4, 2.0 * m * m * n),
        "gram": (
            ab, lambda: ka.gram(xa, seg, anchor_first=True),
            lambda: ka.gram_ref(xa, seg.block_sys, seg.n_sys,
                                anchor_first=True), None,
            abytes + seg.n_sys * m * m * 4, 2.0 * xa.numel() * m),
        "combine": (
            ab, lambda: ka.combine(xa, ca, seg),
            lambda: ka.combine_ref(xa, ca, seg.block_sys),
            lambda: torch.einsum("bmn,bm->bn", xa, cg).reshape(-1),
            abytes + bucket.n_blocks * bucket.block_n * 4 + ca.numel() * 4,
            2.0 * xa.numel()),
    }
    for name, (shape, kern, twin, lib, nbytes, flops) in runs.items():
        rows = 1 if name.startswith("flat") else (
            seg.n_sys if name == "gram" else bucket.n_blocks)
        err = check_close(f"{name} {shape}", kern(), twin(), rows)
        if lib is None:
            k_ms, p_ms = in_turns(kern, twin)
            l_ms = None
        else:
            if name == "combine":         # the same function, one call
                check_close(f"einsum {shape}", lib(), twin(), rows)
            k_ms, l_ms = in_turns(kern, lib)
            p_ms = cuda_ms(twin)
        r_ms = graph_ms(kern)
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"bench kernel {name} {shape} float32: kernel_ms {k_ms} "
              f"graph_ms {r_ms} ref_ms {p_ms} library_ms {l_ms} bound_ms "
              f"{b_ms} ({b_by}), {b_ms / r_ms} of the bound replayed, "
              f"max_abs_err {err}")
        records[name].update(
            bench_shape=list(shape), bench_ms=k_ms, bench_graph_ms=r_ms,
            bench_plain_ms=p_ms, bench_library_ms=l_ms, bench_bound_ms=b_ms,
            bench_max_abs_err=err)
    _require_tickets("bench kernels", dev)


def run_benches(dev, records):
    """Phase 14: the kernels at the benches' shapes, then the six paper
    benches on the card, each counted and held to the committed reference
    file's schema and fixed fields."""
    t_phase = time.perf_counter()
    time_bench_kernels(dev, records)
    for name, fn in bench_run.suites(quick=False, device=dev):
        ref = json.loads((ROOT / f"BENCH_{name}.json").read_text())["rows"]
        what = f"benches {name}"
        if name == "fig4":
            runs = _counted(what, lambda: pb.fig4_runs(device=dev),
                            _bench_want(name, ref))
            rows = pb.fig4_rows(runs)
            check_fig4(runs)
        else:
            rows = _counted(what, fn, _bench_want(name, ref))
        errs = pb.schema_errors(rows, ref)
        require(not errs, f"{what}: out of the reference's schema: "
                f"{errs[:4]}")
        mine, theirs = pb.fixed_fields(name, rows), pb.fixed_fields(name, ref)
        require(mine == theirs, f"{what}: schedule and analytic fields "
                f"{mine} against the reference's {theirs}")
        measured = pb.measured_values(name, rows)
        require(measured and all(v > 0 for v in measured),
                f"{what}: measured values {measured}")
        for row, r in zip(rows, ref):
            label = row.split(",")[1]
            if not ((name == "fig4" and label.isdigit()) or label in (
                    "curve_fixed", "curve_gated", "gate")):
                print(f"{what}: {row}  | reference (its CPU run): {r}")
    print(f"benches: phase 14 wall {time.perf_counter() - t_phase} s")


# -- phase 15: TinyLlama-1.1B training --------------------------------------

# the depth cut: the deepest TinyLlama whose training run stays under ~90%
# of an 80 GB card (PERF.md §4: 22 layers need 79 GB of state alone; 15,
# 16 and 17 ran out of memory by their first record step in
# examples/torch_lm_depth.py; 14 peaked at 0.76 of the card; NVIDIA H100
# 80GB HBM3, 700 W)
LM_LAYERS = 14
LM_STEPS, LM_BATCH, LM_SEQ = 96, 8, 4096
# the graphed run's prefix held to an eager run: 40 steps, or through the
# first jump where that comes later
LM_EAGER_STEPS = 40
# K1 on the LM's rings is held to a float64 twin that anchors explicitly
# (``_gram_row_f64``), as K1 does, at RTOL. The fp32 twin's partials
# identity <qa, x_j> - <qa, x_0> cancels where the snapshots are close: its
# own distance from the float64 twin is printed beside K1's.
# what the graphed run may leave allocated once its Trainer and state are
# dropped: the kernels' per-stream ticket buffers and tables, not a step's
# activations (the shared graph pool held 14.7 GiB at 14 layers)
LM_LEFT_BYTES = 256 * 2 ** 20
# eager record steps traced by torch.profiler, just before the first jump:
# the step's device time by kernel family (PERF.md §5)
LM_PROFILED = 3
# kernel families of the step's trace, by substrings of the kernel's name
LM_FAMILIES = (("K7b", ("bwd_dkdv", "bwd_dq", "bwd_delta", "bwd_rows")),
               ("K7", ("flash_wgmma", "flash_bf16", "flash_f32")),
               ("K1", ("arena_row",)),
               ("GEMM", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
               ("elementwise", ("elementwise_kernel",)))
FLASH_BWD_SRC = "src/repro_torch/kernels/csrc/flash_bwd.cu"
# K7b against its twin (autograd through flash_attention_ref) on unit-normal
# q, k, v and dO, row by row: every row of dq (one query and head), of dk
# and of dv (one key and kv head) within ||kernel - twin|| <= BWD_ROW_TOL *
# ||twin||. The twin's dq is the one given K7's output as K7b receives it
# (``out=``): the output's own rounding shifts a whole dq row, not K7b. A
# design that loses a share f of a row's terms reads about sqrt(f) there,
# whatever the row's size. The bf16 limit sits between a sound bf16 design
# (``_bwd_control``: the twin's arithmetic with K7b's bf16 roundings, which
# must pass) and a deliberately wrong one (the same with the last BWD_DROP
# queries blind to the first BWD_DROP keys, about 1.6% of those rows'
# terms at the LM's length, which must fail); both are read at the LM's
# shape on every run (PERF.md §6).
BWD_ROW_TOL = {torch.float32: 2e-4, torch.bfloat16: 1.2e-2}
BWD_DROP = 64
# K7's log-sum-exp output against lse_ref, absolute (values ~ ln S)
LSE_ATOL = 1e-4
# a row whose twin's norm is under ROW_FLOOR times the gradient's
# root-mean-square row norm (the first query's dq is 0) is held to that
ROW_FLOOR = 1e-1
# (B, S, H, K, d, causal, window), Sq = Sk: one microbatch's attention in
# the LM phase first, then GQA rep 1 and 8, windows, non-causal, d 16-128
# and the tile edges (64 keys per dK/dV CTA, 64 queries per dQ CTA, inner
# tiles of 32 / 16)
LM_ATTN = (2, LM_SEQ, 32, 4, 64, True, 0)
BWD_CASES = (
    [LM_ATTN, (2, 256, 8, 2, 64, True, 0), (1, 200, 8, 8, 128, True, 0),
     (1, 160, 8, 1, 64, False, 0), (1, 256, 4, 2, 64, True, 48),
     (2, 100, 4, 2, 16, False, 30), (1, 96, 4, 4, 48, True, 0)]
    + [(1, s, 8, 1, d, True, 0) for d in (64, 128)
       for s in (127, 128, 129, 257)])


def row_err(got, want):
    """The largest ||got - want|| / ||want|| over the rows (last axis) of
    two (B, S, heads, d) gradients. A row whose twin is (near) zero, as
    the first query's dq is, is measured against ROW_FLOOR times the
    gradient's root-mean-square row norm instead."""
    diff = (got.float() - want.float()).norm(dim=-1)
    norm = want.float().norm(dim=-1)
    floor = ROW_FLOOR * float(norm.square().mean().sqrt())
    return float((diff / norm.clamp_min(max(floor, 1e-30))).max())


def _bwd_control(q, k, v, out, dout, *, drop=0):
    """K7b's arithmetic in plain PyTorch at a causal case, one batch row at
    a time: P from the twin's log-sum-exp, rounded to bf16 for dV; dS =
    P (dP - D) rounded to bf16 for dK and dQ; D from the bf16 output; fp32
    sums; the gradients rounded to bf16. With `drop`, the deliberately
    wrong design: the last `drop` queries do not see the first `drop`
    keys."""
    B, S, H, d = q.shape
    K = k.shape[2]
    rep = H // K
    lse = kf.lse_ref(q, k)
    grads = []
    for b in range(B):
        qb, kb, vb, ob, gb = (t[b:b + 1].float()
                              for t in (q, k, v, out, dout))
        s, _ = kf._scores_ref(q[b:b + 1], k[b:b + 1], True, 0)
        p = torch.exp(s - lse[b:b + 1, :, :, None])      # (1, H, S, S)
        del s
        if drop:
            p[..., -drop:, :drop] = 0
        kr, vr = (t.repeat_interleave(rep, dim=2) for t in (kb, vb))
        dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), gb)
        D = (gb * ob).sum(-1).transpose(1, 2)[..., None]  # (1, H, S, 1)
        ds = (p * (torch.einsum("bqhd,bkhd->bhqk", gb, vr) - D))
        del p
        ds = ds.bfloat16().float()
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) / d ** 0.5
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qb) / d ** 0.5
        del ds
        grads.append([dq] + [t.reshape(1, S, K, rep, d).sum(3)
                             for t in (dk, dv)])
    return [torch.cat(t).to(q.dtype) for t in zip(*grads)]


def _bwd_case(case, dtype, dev, seed):
    """K7 with its log-sum-exp and K7b on one case against the twins;
    returns ({gradient: row error, "max_abs": largest |kernel - twin|},
    the log-sum-exp's error, inputs, forward outputs)."""
    B, S, H, K, d, causal, window = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((B, S, H, d), (B, S, K, d), (B, S, K, d),
                                   (B, S, H, d)))
    out, lse = kf.flash_attention_lse(q, k, v, causal=causal, window=window)
    require(torch.equal(out, kf.flash_attention(q, k, v, causal=causal,
                                                window=window)),
            f"K7 {case} {dtype}: the log-sum-exp output changed the output")
    lse_err = float((lse - kf.lse_ref(q, k, causal=causal, window=window))
                    .abs().max())
    require(lse_err <= LSE_ATOL, f"K7 {case} {dtype}: log-sum-exp off its "
            f"twin by {lse_err} > {LSE_ATOL}")
    w0 = kf.LAUNCHES["flash_attention_bwd_wgmma"]
    got = kf.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                 window=window)
    again = kf.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                   window=window)
    require(kf.LAUNCHES["flash_attention_bwd_wgmma"] - w0 ==
            2 * kf.uses_wgmma(dtype, d), f"K7b {case} {dtype}: wrong design "
            "launched")
    want = kf.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                      window=window, out=out)
    errs = {"max_abs": max(max_err(a.float(), w.float())
                           for a, w in zip(got, want))}
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        require(a.dtype == dtype and a.shape == w.shape, f"K7b {case} {name}")
        require(torch.equal(a, b), f"K7b {case} {dtype} {name}: repeat "
                "launches differ")
        errs[name] = row_err(a, w)
        require(errs[name] <= BWD_ROW_TOL[dtype], f"K7b {case} {dtype} "
                f"{name}: a row off its twin by {errs[name]} of its norm > "
                f"{BWD_ROW_TOL[dtype]}")
    if case == LM_ATTN and dtype == torch.bfloat16:
        # the limit admits a sound bf16 design and refuses a wrong one
        for what, drop in (("control", 0), ("wrong", BWD_DROP)):
            ctl = _bwd_control(q, k, v, out, dout, drop=drop)
            errs[what] = {n: row_err(a, w) for n, a, w in
                          zip(("dq", "dk", "dv"), ctl, want)}
            del ctl
        tol = BWD_ROW_TOL[dtype]
        require(max(errs["control"].values()) <= tol, f"K7b {case}: the "
                f"bf16 control reads {errs['control']}, over {tol}")
        require(min(errs["wrong"].values()) > tol, f"K7b {case}: the wrong "
                f"design reads {errs['wrong']}, not all over {tol}")
    del want
    return errs, lse_err, (q, k, v, dout), (out, lse)


def check_flash_bwd(dev):
    """Phase 15, first: K7b against its twin on every case in fp32 and bf16,
    then timed at the LM's attention shape in bf16 beside its bound and
    beside the backward of scaled_dot_product_attention. Returns K7b's
    record."""
    worst, lse_worst = {}, 0.0
    n = 0
    for case in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            errs, lse_err, _, _ = _bwd_case(case, dtype, dev, seed=300 + n)
            key = str(dtype).split(".")[-1]
            worst[key] = max([worst.get(key, 0.0)] +
                             [errs[g] for g in ("dq", "dk", "dv")])
            lse_worst = max(lse_worst, lse_err)
            if "control" in errs:
                print(f"flash bwd {case} bf16: row error per gradient, "
                      f"kernel { {g: errs[g] for g in ('dq', 'dk', 'dv')} }, "
                      f"bf16 control {errs['control']}, wrong design "
                      f"(last {BWD_DROP} queries blind to the first "
                      f"{BWD_DROP} keys) {errs['wrong']}; limit "
                      f"{BWD_ROW_TOL[dtype]}")
            n += 1
    torch.cuda.empty_cache()
    print(f"flash bwd: {n} cases match the twins row by row within "
          f"{BWD_ROW_TOL} (largest row error {worst}); log-sum-exp within "
          f"{lse_worst} <= {LSE_ATOL}; repeat launches bit-identical; the "
          "log-sum-exp output leaves K7's output unchanged")
    errs, _, (q, k, v, dout), (out, lse) = _bwd_case(
        LM_ATTN, torch.bfloat16, dev, seed=7)
    err = max(errs[g] for g in ("dq", "dk", "dv"))
    torch.cuda.empty_cache()
    B, S, H, K, d = LM_ATTN[:5]
    kern = lambda: kf.flash_attention_bwd(q, k, v, out, dout, lse)  # noqa
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    with torch.enable_grad():
        o_lib = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True)
    d_lib = dout.transpose(1, 2)
    lib = lambda: torch.autograd.grad(o_lib, leaves, d_lib,  # noqa: E731
                                      retain_graph=True)
    k_ms, l_ms = in_turns(kern, lib, iters=20)
    p_ms = cuda_ms(lambda: kf.flash_attention_bwd_ref(q, k, v, dout),
                   iters=3, warmup=1)
    g_ms = graph_ms(kern)
    pairs = _flash_pairs(S, S, True, 0)
    flops = 10.0 * d * pairs * B * H          # S, dP, dV, dK, dQ
    nbytes = 2 * (3 * q.numel() + 3 * k.numel() + 2 * q.numel()) \
        + 4 * lse.numel()                     # q,k,v,O,dO in; dq,dk,dv out
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    print(f"kernel flash_attention_bwd bf16 {LM_ATTN[:5]} causal: kernel_ms "
          f"{k_ms} graph_ms {g_ms} ref_ms {p_ms} sdpa_bwd_ms {l_ms} "
          f"bound_ms {b_ms} ({b_by}) row error {err} TFLOP/s "
          f"{flops / k_ms / 1e9}")
    print(f"K7b {LM_ATTN[:5]}: kernel / sdpa backward {k_ms / l_ms} (same "
          f"call, in turns); {b_ms / k_ms} of the bound eager, "
          f"{b_ms / g_ms} replayed")
    del o_lib, leaves
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=l_ms, max_abs_err=errs["max_abs"],
                row_err=err, control_row_err=errs["control"],
                wrong_row_err=errs["wrong"], graph_ms=g_ms,
                shape=list(LM_ATTN[:5]))


def _gram_row_f64(x, q, block_sys, n_sys, anchor, chunk=1 << 16):
    """K1's float64 twin, a block range at a time: the anchor subtracted
    from every row and from the query before the products, as K1 does."""
    out = torch.zeros((n_sys, x.shape[1]), dtype=torch.float64,
                      device=x.device)
    idx = block_sys.to(x.device, torch.long)
    for a in range(0, x.shape[0], chunk):
        xs, qs = x[a:a + chunk].double(), q[a:a + chunk].double()
        if anchor:
            qs = qs - xs[:, 0, :]
            xs = xs - xs[:, 0:1, :]
        out.index_add_(0, idx[a:a + chunk],
                       torch.bmm(xs, qs.unsqueeze(-1)).squeeze(-1))
    return out


def _combine_twin(x, c, block_sys, chunk=1 << 16):
    """K2's twin a block range at a time (its float64 copy of the LM's ring
    would not fit beside it)."""
    return torch.cat([ka.combine_ref(x[a:a + chunk], c, block_sys[a:a + chunk])
                      for a in range(0, x.shape[0], chunk)])


def check_lm_buckets(dev, trainer, state, records):
    """K1 and K2 on the LM's own rings (the graphed run's state), every
    bucket, against their twins, timed eager and replayed beside their
    bounds; K1 in turns with its twin (no single PyTorch call computes a
    segmented row), K2 with ``einsum`` on the block-gathered coefficients.
    Recorded as the ``lm_buckets`` fields of K1's and K2's records."""
    table = trainer.acc.arena_for(state.params)
    bufs = state.dmd_buffers["__arena__"]
    anchor = trainer.acfg.dmd.anchor == "first"
    for name in ("gram_row", "combine"):
        records[name]["lm_buckets"] = []
    for key, b in table.items():
        x, seg = bufs[key], b.tables_on(dev)
        nb, m, bn = x.shape
        q = x[:, m - 1, :]
        idx = seg.block_sys.to(dev, torch.long)
        c = torch.randn((seg.n_sys, m), generator=torch.Generator(
            device=dev).manual_seed(9), device=dev)
        cg = c[idx]
        xbytes = x.numel() * x.element_size()
        runs = {
            "gram_row": (
                lambda: ka.gram_row(x, q, seg, anchor_first=anchor),
                lambda: ka.gram_row_ref(x, q, seg.block_sys, seg.n_sys,
                                        anchor_first=anchor), None,
                xbytes + seg.n_sys * m * 4, 2.0 * x.numel(), seg.n_sys),
            "combine": (
                lambda: ka.combine(x, c, seg),
                lambda: _combine_twin(x, c, seg.block_sys),
                lambda: torch.einsum("bmn,bm->bn", x, cg),
                xbytes + nb * bn * 4 + c.numel() * 4, 2.0 * x.numel(), nb),
        }
        exact = _gram_row_f64(x, q, seg.block_sys, seg.n_sys, anchor)
        for name, (kern, twin, lib, nbytes, flops, rows) in runs.items():
            if name == "gram_row":
                err = check_close(f"{name} LM bucket {key} (float64 twin)",
                                  kern().double(), exact, rows)
                print(f"LM bucket {key}: K1's largest distance from the "
                      f"float64 twin {err}, the fp32 twin's "
                      f"{max_err(twin().double(), exact)}")
            else:
                err = check_close(f"{name} LM bucket {key}", kern(), twin(),
                                  rows)
            require(torch.equal(kern(), kern()), f"{name} LM bucket {key}: "
                    "repeat launches differ")
            if lib is None:
                k_ms, p_ms = in_turns(kern, twin, iters=10)
                l_ms = None
            else:
                check_close(f"einsum LM bucket {key}", lib().reshape(-1),
                            twin(), rows)
                k_ms, l_ms = in_turns(kern, lib, iters=10)
                p_ms = cuda_ms(twin, iters=1, warmup=1)
            r_ms = graph_ms(kern, iters=5)
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"LM bucket {key} {(nb, m, bn)} n_sys {seg.n_sys} "
                  f"{x.dtype}: {name} kernel_ms {k_ms} graph_ms {r_ms} "
                  f"ref_ms {p_ms} library_ms {l_ms} bound_ms {b_ms} "
                  f"({b_by}), {b_ms / r_ms} of the bound replayed, "
                  f"max_abs_err {err}")
            records[name]["lm_buckets"].append(dict(
                bucket=key, shape=[nb, m, bn], n_sys=seg.n_sys, ms=k_ms,
                graph_ms=r_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=b_ms, max_abs_err=err))
            torch.cuda.empty_cache()
        del exact
    _require_tickets("LM bucket kernels", dev)


def _flat_params(state):
    """The state's params (resident buffers and per-leaf leaves) on the
    host, by path."""
    return {path: x.detach().to("cpu", copy=True)
            for path, x in leaves_with_paths(state.params) if x is not None}


def _lm_fit(acfg, model, steps, on_step, cuda_graphs=True):
    """One run of the launcher's ``run`` from fresh params, the counts set
    to 0 just before (read them just after); ``on_step(t, trainer,
    state)`` after every step, on the resident state the loop updates in
    place. Returns (trainer, state, losses, per-step seconds)."""
    trainer = launch_train.make_trainer(acfg, model, cuda_graphs=cuda_graphs)
    state = launch_train.fresh_state(trainer)
    losses, stamps = [], [time.perf_counter()]

    def on_metrics(t, m):
        losses.append(float(m["loss"]))        # synchronises
        stamps.append(time.perf_counter())
        on_step(t, trainer, state)
    reset_counts()
    launch_train.run(acfg, model, steps=steps, trainer=trainer, state=state,
                     log_every=0, on_metrics=on_metrics)
    torch.cuda.synchronize()
    return trainer, state, losses, np.diff(stamps)


def _live_cuda_tensors(n=8):
    """The n largest CUDA tensors the collector can reach, by bytes."""
    found = []
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                found.append((obj.numel() * obj.element_size(),
                              tuple(obj.shape), obj.dtype))
        except ReferenceError:  # a weak proxy whose referent is gone
            continue
    return sorted(found, key=lambda t: t[0], reverse=True)[:n]


def _lm_breakdown(prof, wall_s, steps):
    """Device ms per step by kernel family, the busy share over the traced
    wall, and the top kernels."""
    fams, rows = {}, []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0:
            continue
        rows.append((us, evt.count, evt.key))
        name = evt.key.lower()
        fam = next((f for f, keys in LM_FAMILIES
                    if any(k in name for k in keys)), "other")
        fams[fam] = fams.get(fam, 0.0) + us
    busy = sum(fams.values())
    if busy <= 0:
        print("tinyllama-train profile: no device time in the trace (busy "
              "share not measured)")
        return
    per_step = {f: us / steps / 1e3 for f, us in sorted(
        fams.items(), key=lambda kv: -kv[1])}
    print(f"tinyllama-train profile ({steps} eager record steps): wall {wall_s / steps * 1e3} ms/step, device "
          f"{busy / steps / 1e3} ms/step, busy share {busy / 1e6 / wall_s}; "
          f"device ms/step by family {per_step}; shares "
          f"{ {f: us / busy for f, us in fams.items()} }")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {us / steps / 1e3:10.3f} ms/step {count // steps:6d} a step "
              f"{us / busy:7.3f}  {key[:100]}")


def run_lm_train(dev, records):
    """Phase 15. Returns the graphed run's launches."""
    t_phase = time.perf_counter()
    # the earlier phases' objects (engines, Trainers and their graph pools
    # held in reference cycles) leave the card before the LM's state
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    print(f"tinyllama-train: {held} bytes allocated before the phase"
          + (f"; largest live CUDA tensors {_live_cuda_tensors()}"
             if held > 2 ** 30 else ""))
    records["flash_attention_bwd"] = check_flash_bwd(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    full = launch_train.configure("tinyllama-1.1b", steps=LM_STEPS)
    n_full = launch_train.param_count(launch_train.make_model(full, device=dev))
    need_full = sum(launch_train.state_bytes(full, n_full).values())
    acfg = launch_train.configure(
        "tinyllama-1.1b", steps=LM_STEPS, global_batch=LM_BATCH, seq=LM_SEQ,
        n_layers=LM_LAYERS)
    mc = acfg.model
    require((mc.d_model, mc.n_heads, mc.n_kv_heads, mc.head_dim, mc.d_ff,
             mc.vocab_size, mc.dtype, acfg.parallel.grad_accum,
             acfg.parallel.remat, acfg.dmd.m, acfg.dmd.s,
             acfg.dmd.warmup_steps) ==
            (2048, 32, 4, 64, 5632, 32000, "bfloat16", 4, "block", 14, 55,
             LM_STEPS // 4), f"LM config {mc} {acfg.dmd} {acfg.parallel}")
    model = launch_train.make_model(acfg, device=dev)
    n_params = launch_train.param_count(model)
    need = launch_train.check_fits(acfg, n_params, total)
    print(f"tinyllama-train: {full.model.n_layers} layers {n_full} params: "
          f"state {need_full} bytes ({need_full / total} of the card's "
          f"{total}); cut to {LM_LAYERS} layers {n_params} params: state "
          f"{need} bytes {launch_train.state_bytes(acfg, n_params)} "
          f"({need / total} of the card)")
    require(need_full > launch_train.CARD_FRACTION * total,
            "the full depth fits: the cut is not needed")

    # the schedule's launches: K1 once per bucket per record, K2 once per
    # bucket per jump, K7 twice per layer and microbatch (remat), K7b once
    ga = acfg.parallel.grad_accum
    want = {"flash_attention": 2 * LM_LAYERS * ga * LM_STEPS,
            "flash_attention_bwd": LM_LAYERS * ga * LM_STEPS}
    # the schedule (a function of the DMD config) gives the jumps, and the
    # eager run's length: LM_EAGER_STEPS, or through the first jump
    acc = launch_train.make_trainer(acfg, model).acc
    jumps = [t for t in range(LM_STEPS) if acc.apply_groups(t)]
    require(len(jumps) >= 2, f"tinyllama-train: {len(jumps)} jumps")
    require(acc.slot(jumps[0]) == acfg.dmd.m - 1,
            f"tinyllama-train: the first jump at {jumps[0]} does not close a "
            "window")
    eager_steps = max(LM_EAGER_STEPS, jumps[0] + 1)
    witness = {}

    def at_step(t, trainer, state):
        if t == eager_steps - 1:
            witness["graphed"] = _flat_params(state)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before_fit = torch.cuda.memory_allocated(dev)
    trainer, state, losses, secs = _lm_fit(acfg, model, LM_STEPS, at_step)
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    table = trainer.acc.arena_for(state.params)
    want["gram_row"] = sum(acc.slots(t)[b.group] >= 0
                           for t in range(LM_STEPS) for b in table.values())
    want["combine"] = sum(b.group in acc.apply_groups(t)
                          for t in jumps for b in table.values())
    require_counts("tinyllama-train graphed", want)
    require_wgmma("tinyllama-train graphed")
    require_wgmma("tinyllama-train graphed", "flash_attention_bwd", "K7b")
    reset_counts()
    print(f"tinyllama-train graphed: launches {launches}; jumps at {jumps}; "
          f"graphs {trainer.graph_stats}; buckets "
          f"{[(k, b.n_blocks, b.m, b.block_n) for k, b in table.items()]}")
    require(np.isfinite(losses).all(), "tinyllama-train: non-finite loss")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    require(last < first, f"tinyllama-train: loss {first} -> {last}")
    tokens = LM_BATCH * LM_SEQ
    g_ms = float(np.mean(secs[1:])) * 1e3
    # a step's time once every graph is captured (median: the jumps aside)
    g_med = float(np.median(secs[jumps[0] + 1:])) * 1e3
    print(f"tinyllama-train losses {losses}")
    print(f"tinyllama-train graphed: loss mean of the first 10 {first}, of "
          f"the last 10 {last}; ms/step {g_ms} (steps 1-{LM_STEPS - 1}, "
          f"host clock, synchronised per step; step 0 {secs[0] * 1e3}; "
          f"median after the first jump {g_med}), {tokens / g_ms * 1e3} "
          f"tokens/s; peak allocated {peak} bytes "
          f"({peak / 2 ** 30} GiB, {peak / total} of the card) beside the "
          f"reckoned state {need} bytes")
    check_lm_buckets(dev, trainer, state, records)
    table_keys = sorted(table)
    records["flash_attention"]["train_launches"] = launches["flash_attention"]
    # the state, the graphs and their shared pool leave with their last
    # reference, without the garbage collector
    del trainer, state, table
    after_fit = torch.cuda.memory_allocated(dev)
    print(f"tinyllama-train: {before_fit} bytes allocated before the "
          f"graphed run, {after_fit} once its Trainer and state are dropped "
          "(no gc.collect)")
    require(after_fit - before_fit <= LM_LEFT_BYTES,
            f"tinyllama-train: {after_fit - before_fit} bytes outlive the "
            f"graphed run > {LM_LEFT_BYTES}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced = range(eager_steps - 1 - LM_PROFILED, eager_steps - 1)
    require(all(acc.slots(t)[0] >= 0 for t in traced) and
            not any(acc.apply_groups(t) for t in traced),
            f"tinyllama-train: traced steps {list(traced)} are not plain "
            "record steps")

    def at_step_eager(t, trainer, state):
        if t == traced[0] - 1:
            torch.cuda.synchronize()
            prof.start()
            witness["t_prof"] = time.perf_counter()
        if t == traced[-1]:
            torch.cuda.synchronize()
            witness["prof_wall"] = time.perf_counter() - witness["t_prof"]
            prof.stop()
        if t == jumps[0]:
            # the first jump's window is complete: the carried Grams equal
            # K3's recompute of the ring
            tab = trainer.acc.arena_for(state.params)
            bufs = state.dmd_buffers["__arena__"]
            grams = state.dmd_gram["__arena__"]
            for key, b in tab.items():
                full_g = ka.gram(bufs[key], b.tables_on(dev),
                                 anchor_first=True)
                _require_gram(f"LM step {t} {key} carried vs K3",
                              grams[key], full_g)
            witness["gram"] = sorted(tab)
        if t == eager_steps - 1:
            witness["eager"] = _flat_params(state)
            witness["eager_peak"] = torch.cuda.max_memory_allocated(dev)

    _, _, losses_e, secs_e = _lm_fit(acfg, model, eager_steps,
                                     at_step_eager, cuda_graphs=False)
    reset_counts()
    # eager ms/step over the steps before the traced ones
    e_ms = float(np.mean(secs_e[1:traced[0]])) * 1e3
    e_med = float(np.median(secs_e[1:traced[0]])) * 1e3
    _lm_breakdown(prof, witness["prof_wall"], LM_PROFILED)
    del prof
    require(len(witness.get("gram", ())) == len(table_keys),
            "tinyllama-train: the carried Grams were not checked")
    require(losses[:eager_steps] == losses_e,
            f"tinyllama-train: graphed losses differ from eager in the "
            f"first {eager_steps} steps")
    a, b = witness["graphed"], witness["eager"]
    require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
            f"tinyllama-train: params after {eager_steps} steps differ "
            "between the graphed and the eager run")
    print(f"tinyllama-train: graphed = eager bit for bit over the first "
          f"{eager_steps} steps (losses and every param); ms/step graphed "
          f"{g_ms}, eager {e_ms} ({tokens / e_ms * 1e3} tokens/s; median "
          f"{e_med}); eager peak allocated {witness['eager_peak']} bytes "
          f"({witness['eager_peak'] / total} of the card)")
    del witness
    torch.cuda.empty_cache()
    print(f"tinyllama-train: phase 15 wall {time.perf_counter() - t_phase} s")
    return launches


def main():
    t_start = time.perf_counter()
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
    run_recompute_path(
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
    _, witness = run_trainer(dev, X, Y, MS_PER_STEP["main path"])
    split, finals, pollutant_launches = run_pollutant(dev)
    run_checkpoint(dev, X, Y, witness)
    del witness
    bucket_launches = run_paper_config(dev, X, Y, arena_grams, split, finals,
                                       records)["bucket"]
    run_benches(dev, records)
    torch.cuda.empty_cache()
    lm_launches = run_lm_train(dev, records)

    replaces = {"gram_row": "src/repro/kernels/arena.py:206",
                "combine": "src/repro/kernels/arena.py:294",
                "gram": "src/repro/kernels/arena.py:258",
                "flat_gram_row": "src/repro/kernels/gram_row.py:48",
                "flat_combine": "src/repro/kernels/combine.py:27",
                "flat_gram": "src/repro/kernels/gram.py:45",
                "flash_attention": "src/repro/kernels/flash_attention.py:82",
                # no Pallas kernel: the gradient jax.grad takes of the
                # reference's jnp attention core
                "flash_attention_bwd": "src/repro/models/attention.py:59"}
    launches = {"gram_row": main_launches["gram_row"],
                "combine": main_launches["combine"],
                "gram": pollutant_launches["gram"],
                "flat_gram_row": leaf_launches["flat_gram_row"],
                "flat_combine": leaf_launches["flat_combine"],
                "flat_gram": leaf_rec_launches["flat_gram"],
                "flash_attention": serve_launches["flash_attention"],
                "flash_attention_bwd": lm_launches["flash_attention_bwd"]}
    sources = {"gram_row": SRC, "combine": SRC, "gram": SRC,
               "flat_gram_row": FLAT_SRC, "flat_combine": FLAT_SRC,
               "flat_gram": FLAT_SRC, "flash_attention": FLASH_SRC,
               "flash_attention_bwd": FLASH_BWD_SRC}
    records["gram_row"]["bucket_launches"] = bucket_launches["gram_row"]
    kernels = [dict(name=name, route="cuda", source=sources[name],
                    replaces=replaces[name], launches=launches[name],
                    **records[name])
               for name in replaces]
    print(f"chip_smoke: wall {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
