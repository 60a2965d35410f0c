#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero (nothing is caught):

1. The card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions.
2. Build the CUDA kernels (``src/repro_torch/kernels/csrc/*.cu``, one
   ``nvcc`` per source, in parallel) and print ptxas's registers, shared
   memory and spills (``-Xptxas -v``) of the Hopper flash-attention design
   (with and without its log-sum-exp output, and at a key offset), of
   K7b's Hopper design
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
   windowed, non-causal, ragged, Sq != Sk, d 16 and 128, GQA rep 1, 7 and
   8 cases in fp32 and bf16 (Whisper's encoder, 1500 x 1500 non-causal,
   and its cross-attention, 64 and 1000 queries over 1500 keys, among
   them); the Hopper design's tile edges (Sq, Sk of 127,
   128, 129, 257 at d 64 and 128, every mask, GQA rep 1 and 8, q/k/v as
   slices of one fused tensor); repeat launches bit-identical; timings at
   the 4096 shape and the largest serve prefill shape beside the bound and
   ``scaled_dot_product_attention``, with K7's time over SDPA's and its
   CUDA-graph replay time. A row that sees no key must be exactly 0.
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
   ring, leaf scope, warm-up 18 = steps // 4), adamw with clip and the
   cosine schedule, grad_accum 4 and remat "block", on the synthetic token
   stream at 8 x 4096 for 72 steps with CUDA graphs (jumps at 41 and 65). Launches exactly: K1
   once per bucket per record, K2 once per bucket per jump, K7 2 x layers x
   4 per step (all through the wgmma design), K7b layers x 4 per step
   (all through its Hopper design);
   at least two jumps; finite losses, the last 10's mean below the first
   10's; ms/step, tokens/s and peak memory beside the reckoned state. K1
   and K2 on that run's own rings, every bucket, against their twins (K1's
   in float64) and timed (the ``lm_buckets`` fields of their records).
   Once the run's Trainer and state are dropped, without the garbage
   collector, at most ``LM_LEFT_BYTES`` more is allocated than before it
   (the graphs' shared pool went with them). Then 42 steps (through the
   first jump) eagerly from the same init: at the first jump the carried
   Grams equal K3's recompute of the ring, and the losses and the params
   after 42 steps equal the graphed run's bit for bit.
16. The MoE family (``models/moe.py``). First K7 at one Qwen3 sequence's
   attention, (1, 4096, 32, 4, 128), and K7b at one Qwen3 microbatch's,
   (2, 4096, 32, 4, 128), bf16 causal, against their twins, timed beside
   their bounds and SDPA (the ``moe_d128`` fields of their records).
   (a) Qwen3-30B-A3B served at full width and depth through the
   launcher's ``build`` (48 layers, 30,532,110,336 params, the weights
   once on the card: the engine serves the drawn tensors): the launcher's
   stream with K7 48 a prefill dispatch and nothing else, every request
   complete; decode and prefill ms; every request's first-token logits
   against the same padded prompt run by hand (prefill at its bucket, one
   decode step at true_len - 1; capacity depends on the padding, so the
   exact-length loop is not the yardstick) within ``SERVE_LOGIT_TOL``; a
   4096-token ``forward`` (K7 48, all through the wgmma design). The hot
   swap is not run: it stages a second copy. (b) One Qwen3 MoE layer on
   64 tokens, forward and backward, twice on the card (bit-identical) and
   on the CPU: the same routing but at near-ties (``MOE_NEAR``, counted),
   out, aux and gradients within ``MOE_LAYER_TOL``. (c) Qwen3 trained
   through the launcher's ``run`` at full width cut to ``MOE_LAYERS``
   layers (48 and 3 layers' state is printed and must exceed 90% of the
   card), the config's DMD on every param (m 8, s 40, bf16 ring), adamw,
   grad_accum 4, remat, 8 x 4096 a step for ``MOE_STEPS`` steps graphed:
   K7 2 x layers x 4 a step, K7b layers x 4 (all through the Hopper
   designs), K1 per bucket per record, K2 per bucket per jump; loss
   falling; ms/step, tokens/s, peak beside the reckoned state; K1 and K2
   on the run's bf16 rings against their twins and bounds (the
   ``moe_buckets`` fields; K1 on the bf16 ring of the bf16 params within
   ``K1_TWIN_FACTOR`` of the chunked fp32 twin's distance from the float64
   twin, on the fp32 params' bucket within RTOL of it); then eagerly through the first jump (the
   carried Grams against K3, a profile of 3 record steps) and graphed =
   eager bit for bit. Both runs' median ms a step by kind (a graph key's
   warm-up, capture or replay; plain, record, jump) and the device time
   by kernel family of the same 3 plain steps replayed and eager. (d) Llama4-Maverick's widths at one dense-MoE pair
   (2 layers, top-1 routing and the shared expert): (a)'s serving checks
   and 4096-token ``forward`` (K7 2).
17. The SSM and hybrid families (``models/ssm.py``), phase 17 "ssm": K7
   and K7b at zamba2's attention, (1, 4096, 32, 32, 80) bf16 causal on the
   sm_80-unit designs, timed beside SDPA and SDPA's backward. (a)
   Mamba2-2.7B at full width and depth (64 layers, 2,702,255,616 params,
   seeded random weights drawn on the card): greedy generation of 8 and
   then 128 equal-length 64-token prompts, 16 new tokens, through
   ``prefill`` and ``decode_step``, twice (bit-identical); prefill ms,
   decode ms, tokens/s, peak; the decode logits against ``forward``'s at
   the same positions printed in bf16, and held within SERVE_LOGIT_TOL in
   fp32 at full depth and in bf16 cut to SSM_BF16_LAYERS (mamba2 only:
   see SSM_BF16_HELD); a 4096-token forward (no kernel launch: the SSD is
   plain tensor work, as in the reference). (b)
   Zamba2-2.7B (54 layers, 2,340,466,848 params) the same at batch 8; K7
   once per shared-block invocation (9) a prefill and a forward. (c) One
   Mamba-2 block and one zamba super-block (6 Mamba-2 blocks and the
   shared attention + MLP) at full width in fp32 on 512 tokens, forward,
   backward, prefill and one decode step, card twice bit-identical and
   against the CPU within SSM_BLOCK_TOL. (d) mamba2-train and (e)
   zamba2-train: the launcher's ``run`` at full width cut to
   ``SSM_TRAIN_LAYERS`` (the full depth's reckoned state is printed and
   must exceed 90% of the card), the config's DMD on every param (m 14,
   s 55, bf16 ring, warm-up cut to 0 and cool-down to 5: the jump at
   step 18), adamw 3e-4,
   remat, the config's microbatch of 1 x 4096 tokens but ``SSM_ACCUM`` = 2
   of them a step (the config's grad_accum is 8), 19 steps
   graphed and then eagerly (``train_cell``): K1 per bucket per record, K2 per bucket per
   jump, K7 twice and K7b once per shared-block invocation and
   microbatch; graphed = eager bit for bit (losses and every param); ms a
   step by kind, peak beside the reckoned state; K1 and K2 on the run's
   own rings (``check_ring_buckets``: K1 on the bf16 ring within
   ``K1_TWIN_FACTOR`` of the chunked fp32 twin's distance from the
   float64 twin); the device time by kernel family (the SSD's fp32
   products apart) of 3 eager plain steps. (f) K1's error
   and time on the MoE ring and both SSM rings, side by side.
18. The remaining dense decoders, phase 18 "dense": K7 and K7b at
   granite's MQA attention, (1, 4096, 48, 1, 128) causal (one KV head for
   48 query heads), and at gemma's local attention, (1, 4096, 32, 16,
   128) causal with window 1024, bf16, through their Hopper designs,
   against their twins, timed beside their bounds (the pairs the window
   lets through) and SDPA (its forward and backward with the same mask).
   (a) MiniCPM-2B at full width and depth through the launcher's
   ``build`` (40 layers, 36 MHA heads of 64, 2,724,915,456 params): the
   launcher's stream (K7 40 a prefill dispatch, all through the wgmma
   design, nothing else), decode ms, every request's first-token logits
   against the exact-length loop within SERVE_LOGIT_TOL, a hot swap every
   8 steps, a 4096-token ``forward``. (b) Granite-20B (52 layers, MQA,
   the plain GELU MLP, 20,315,756,544 params, the weights once on the
   card): the same without the hot swap (two copies need 81 GB). (c)
   Gemma3-27B (62 layers: 10 super-blocks of 5 window layers and a global
   one, then 2 window layers; 27,008,319,744 params) generating through
   ``prefill`` / ``decode_step``, which the engine refuses for ring
   caches as the reference's does: 8 prompts of 64 tokens and one of
   ``GEMMA_LONG`` tokens (every ring wraps), 16 new tokens each, twice
   bit for bit; K7 62 a prefill; the bf16 decode logits against
   ``forward``'s printed; a 4096-token ``forward``; then in fp32 at
   ``GEMMA_FP32_LAYERS`` (two super-blocks and the 2-layer tail) the
   decode logits held to ``forward``'s within SERVE_LOGIT_TOL, also
   through wrapped rings; one super-block at full width in fp32 (window
   cut to ``GEMMA_BLOCK_WINDOW`` so that ``GEMMA_BLOCK_TOKENS`` tokens
   wrap the rings), forward, backward, prefill and a decode step, card
   twice bit for bit and against the CPU within SSM_BLOCK_TOL. (d)
   minicpm-train, granite-train and gemma3-train through ``train_cell``
   at full width cut to ``DENSE_TRAIN_LAYERS`` (the full depth's reckoned
   state must exceed 90% of the card), the config's DMD on every param
   (bf16 rings: m 14 for minicpm, 8 for the others), warm-up 0 and
   cool-down ``DENSE_COOLDOWN``, ``DENSE_ACCUM`` microbatches of 1 x 4096
   a step; K7 and K7b all through their Hopper designs; graphed = eager
   bit for bit. gemma3-train's cut keeps only window layers: the global
   layer is trained on the CPU against the reference
   (tests/test_torch_dense_archs.py).
19. The last two architectures, phase 19 "vlm-encdec": K7 at Qwen2-VL's
   GQA, (1, 4096, 28, 4, 128) causal (rep 7), and at Whisper's encoder
   (8, 1500, 1500, 8, 8, 64), cross-attention (8, 4096 queries over 1500
   keys) and prefill (64 over 1500), non-causal; K7b at (2, 4096, 28, 4,
   128) and at both of Whisper's non-causal shapes; bf16 through their
   Hopper designs, against their twins, timed beside their bounds and
   SDPA (phase 15's K7b cases carry Sq and Sk apart since this phase,
   with Sq != Sk at the tile edges both ways at d 64 and 128). (a)
   Qwen2-VL-7B at full width and depth (28 layers, 7,615,487,488 params,
   the serve launcher's draw; the engine refuses M-RoPE batches, as the
   reference's) generating through ``prefill`` / ``decode_step``: 8
   prompts of a 4 x 4 stub image block and text, the M-RoPE streams
   (``data/tokens.py::image_positions``) continuing from the grid's
   maximum, 16 new tokens, twice bit for bit; K7 28 a prefill and none in
   decode; the bf16 decode logits against ``forward``'s printed; a
   4096-token ``forward``; the fp32 decode path held to ``forward``'s at
   full depth (30.5 GB); one block at full width in fp32 under streams
   that differ, card twice bit for bit and against the CPU within
   SSM_BLOCK_TOL. (b) Whisper-base (6 + 6 layers, 88,175,616 params) the
   same for 8 stub frame sequences (8, 1500, 512) fp32: K7 18 a prefill
   (6 encoder, 6 self, 6 cross), none in decode; cross_k and cross_v in
   their own storage. (c) qwen2-vl-train through ``train_cell`` at full
   width cut to ``VLM_TRAIN_LAYERS`` (the full depth's reckoned state,
   274 GB, must exceed 90% of the card) under the M-RoPE streams of a
   ``VLM_TRAIN_GRID`` image block opening each sequence, the config's DMD (m 10, s 40, bf16 ring), remat; (d) whisper-train at
   full width and depth (6.35 GB of state) on the stream's frames,
   ``WHISPER_TRAIN_ROWS`` sequences a microbatch, the config's DMD (m 14,
   s 55, fp32 ring), no remat (K7 and K7b 18 a microbatch); both
   ``DENSE_ACCUM`` microbatches a step, warm-up 0, cool-down
   ``DENSE_COOLDOWN``, graphed = eager bit for bit, K1 and K2 on their
   own rings.
20. The audit layer (``repro_torch.audit``), phase 20 "audit": (a) the
   paper MLP's audit at full width (2,882,150 params, the config's eig-mode
   DMD) on the card: all ten passes green, each audited step's op count
   equal to the same build's on the CPU (kernel calls are single opaque
   ops on either device), train_step and record_update launching K1 once,
   both jumps K2 once. (b) The plain train step, a record step and
   record_update under ``torch.cuda.set_sync_debug_mode("error")``: no
   host sync. (c) Each of the six mutations at ``pollutant-mlp
   --reduced`` fails exactly its pass. (d) The serve audit (``serve/
   audit.py``'s config and waves) at TinyLlama-1.1B's full width and
   depth, phase 9's seeded weights: no program built after the warm-up,
   the registry within its ceiling, nothing dropped, no cache-shaped
   tensor made in decode, every slot-table cache tensor kept over the
   run, K7 22 a prefill dispatch; then ``force-recompile`` bites. No
   kernel is added; the phase's wall time is printed. The six mutations
   are those a one-device build has (``force-allgather`` needs a mesh:
   phase 21(e)).
21. The mesh, phase 21 "mesh" (``run_mesh_phase``): four ranks spawned
   on the one card (``launch/mesh.py::run_ranks``, gloo on CUDA tensors,
   a FileStore in a ``.chip_smoke_*`` directory), after the kernels were
   built here, so that no two ranks build them; a rank that fails fails
   the script. (0) gloo's all_reduce, broadcast and list all_gather on
   CUDA tensors. (a) The data passes per block on a (2, 2) mesh
   (``distributed/checks.py``'s rank-side checks, which the CPU tests run
   too): the lane-sharded arena at TinyLlama-1.1B's full-width shard
   shapes and the reference test's system-sharded bucket (the override
   ("stacked", ("fsdp", None, "tp"))), arena and per-leaf routes: K1 / K4
   streamed and K3 / K6 recomputed per block plus one all-reduce against
   each rank's kernels on the full ring (RTOL; bit for bit on a sparse
   integer trajectory), K2 / K5 per block equal the full combine's block
   bit for bit (a bucket's K2 without a collective), K1-K3 against their
   twins on the block, a record making all-reduces only; rank 0 times
   each pass on its block (the others wait) beside its bound, and the
   all-reduce of a K1 row and of K3's Grams. (b) TinyLlama-1.1B at full
   width cut to ``MESH_LAYERS`` on the (2, 2) mesh, eager (DMD on every
   param, bf16 ring of 4, the jump at step 4, AdamW), tensor-parallel
   over "model" (each rank on its heads, ffn columns and vocabulary
   rows), against the same run
   on one rank, eager, here: losses within ``MESH_LOSS_TOL`` (up to the
   jump, after it), the final params within ``MESH_PARAM_TOL`` leaf by
   leaf (the L2 distance over the L2 distance the leaf moved) and two
   planted faults outside it (one rank trained on the first half of
   every batch, as a data rank whose gradient sum were lost; the initial
   params), the coefficients the same bits on every rank before and
   after their broadcast, K1 and K2 launched on every rank, K7 and K7b
   12 times each on every rank at its ``MESH_HEADS`` (16 / 2 heads of
   64), all through their wgmma designs, no param block all-gathered
   over "model" and the activation all-reduces over "model" totalling
   their analytic bytes (``_tp_activation_bytes``), record_update's
   collectives all-reduces totalling the analytic bytes; step ms, peak
   bytes per rank beside the gather-everything compute's. (c) (b)'s checkpoint at ``MESH_SAVE`` restored onto (4, 1) and
   onto one rank here, run to (b)'s last step: losses as (b)'s within
   ``MESH_LOSS_TOL``, every restored running Gram equal to K3's
   recompute of its restored ring over the window's rows. (d) The int8
   pod sync on a (2, 1, 2) mesh: error <= scale * 1.01, one int32
   all-reduce over "pod". (e) The audit of the reduced TinyLlama under
   ``--mesh 2x2``: clean with record_update's one all-reduce of the
   analytic bytes and no param block gathered over "model", and
   ``force-allgather`` and ``force-gather-model`` each fail exactly
   collective-budget. (f) ``TP_FAMILIES`` (MiniCPM-2B's 36 MHA heads
   padded to 48 and moved, Granite-20B's one replicated kv head and GELU
   MLP, Qwen3-30B-A3B's 64 of 128 experts a rank, Mamba2-2.7B's 40 of 80
   heads a rank) at full width, one layer each, on the (2, 2) mesh
   against one rank on the same params and one microbatch of 2 x 1024
   tokens (``distributed/checks.py::tp_gradients``): the loss within
   ``TP_LOSS_TOL`` and each param block's gradient within
   ``TP_GRAD_TOL`` of its leaf's norm, the planted faults
   (``TP_FAULTS``: MiniCPM's MLP row-parallel all-reduce dropped,
   Mamba2's ``norm_scale`` sum over "model" dropped) outside them, K7
   and K7b through wgmma on every rank of the attention families, no
   param block gathered over "model". (g) kv-SP (k and v split by
   sequence over "model", q whole on every rank, the blocks' attention
   merged by their log-sum-exps): ``KV_SP_CELLS`` at full width on the
   (2, 2) mesh against one rank (``tp_gradients``, one microbatch of 2 x
   1024 tokens), TinyLlama-1.1B at one layer in the reference's
   ``--reduced`` layout (head_tp False) and Whisper-base at full depth as
   its config lays it out (head_tp None: kv-SP in all 18 attention
   calls, 1500 frames): the loss within ``TP_LOSS_TOL``, each gradient
   block within ``TP_GRAD_TOL`` of its leaf's norm, no param block
   gathered over "model", the attention's collectives over "model"
   equal to their analytic bytes site by site (``_kv_sp_sites``), every
   K7 and K7b launch through wgmma and those of a rank past the first's
   self-attention at a key offset (``LAUNCHES[..._offset]``), and the
   planted faults (``KV_SP_FAULTS``: the merge without its weights, dq
   without its sum over "model") outside the limits; (e)'s audit runs
   kv-SP (its merge's collectives made). Then, the card to itself, K7 and
   K7b with a key offset against their twins (``KV_SP_CHECKS`` in fp32
   and bf16, both designs), the planted blind CTAs (``KV_SP_BLIND``: out
   0, log-sum-exp -1e30, zero gradients, no hang), the merge of two
   halves against the whole and K7b on the merged output against its
   twin, and ``KV_SP_CASES`` timed beside their bounds and SDPA under
   the same boolean mask. The phase's wall time is printed.
   The script's wall time is printed before the kernels' line.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
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
from repro_torch.distributed import checks as mesh_checks  # noqa: E402
from repro_torch.distributed.checks import rel_err  # noqa: E402
from repro_torch.data.tokens import (image_positions,  # noqa: E402
                                     stream_kwargs, synthetic_lm_batches)
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
           "flash_attention_offset": "flash_attention",
           "flash_attention_bwd_offset": "flash_attention_bwd",
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
    """flash_wgmma<64>, flash_wgmma<64,lse> and flash_wgmma<64,off> (K7:
    with its log-sum-exp; at a key offset, with it), bwd_rows_wgmma<64>,
    bwd_dkdv_wgmma<64> and bwd_dq_wgmma<64> (K7b's Hopper design),
    row_part<float,16,vec=1> (K4), arena_row<...>
    (K1), combine_flat<...> (K5), arena_gram_k<...> (K3) and
    gram_flat<...> (K6) from ptxas's mangled names, with their MMAX (None
    for K7 and K7b)."""
    if m := re.search(r"flash_wgmmaILi(\d+)E", mangled):
        extra = (",lse" if "ProblemLse" in mangled        # with its LSE
                 else ",off" if "ProblemOff" in mangled else "")
        return f"flash_wgmma<{m.group(1)}{extra}>", None
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
    want |= {f"flash_wgmma<{d}{extra}>" for d in (64, 128)
             for extra in ("", ",lse", ",off")}
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
    (1, 512, 512, 28, 4, 128, True, 0),       # Qwen2-VL's GQA, rep 7
    (2, 1500, 1500, 8, 8, 64, False, 0),      # Whisper's encoder
    (2, 64, 1500, 8, 8, 64, False, 0),        # its prefill's cross-attention
    (1, 1000, 1500, 8, 8, 64, False, 0),      # its cross-attention, Sq < Sk
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


def _offset(case):
    """A case's key offset: its ninth entry, 0 where it has none."""
    return case[8] if len(case) > 8 else 0


def _flash_pairs(Sq, Sk, causal, window, k_offset=0):
    """Visible (query, key) pairs of one head: the work the data needs."""
    return int(kf._mask(Sq, Sk, causal, window, "cpu", k_offset).sum())


def _check_flash_case(case, dtype, dev, seed, qkv=None):
    """K7 on one case against its twin; both launches through the design
    its dtype and d select. A row that sees no key must be exactly 0.
    `qkv` replaces the drawn inputs."""
    causal, window, off = case[6], case[7], _offset(case)
    q, k, v = qkv or _flash_inputs(case, dtype, dev, seed)
    w0 = kf.LAUNCHES["flash_attention_wgmma"]
    got = kf.flash_attention(q, k, v, causal=causal, window=window,
                             k_offset=off)
    require(torch.equal(got, kf.flash_attention(q, k, v, causal=causal,
                                                window=window,
                                                k_offset=off)),
            f"flash {case} {dtype} not repeatable")
    require(kf.LAUNCHES["flash_attention_wgmma"] - w0 ==
            2 * kf.uses_wgmma(dtype, case[5]),
            f"flash {case} {dtype}: wrong design launched")
    want = kf.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  k_offset=off)
    rows = kf._mask(case[1], case[2], causal, window, dev, off).any(dim=1)
    diff = (got[:, rows].float() - want[:, rows].float()).abs()
    atol, rtol = FLASH_TOL[dtype]
    limit = atol + rtol * want[:, rows].float().abs()
    require(torch.isfinite(got.float()).all(), f"flash {case}: non-finite")
    require(not (got[:, ~rows] != 0).any(), f"flash {case} {dtype}: a row "
            "that sees no key is not 0")
    err = float(diff.max()) if diff.numel() else 0.0
    require(bool((diff <= limit).all()), f"flash {case} {dtype}: max "
            f"|kernel - twin| {err} beyond {atol} + {rtol}|twin|")
    return err, (q, k, v)


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
        rec = time_flash(case, dev)
        if record is None:
            record = rec
    return record


def _sdpa_mask(Sq, Sk, causal, window, dev, k_offset=0):
    """SDPA's (is_causal, attn_mask) for K7's mask: is_causal alone where
    there is no window and no key offset, else the boolean mask itself."""
    if not window and not k_offset:
        return causal, None
    return False, kf._mask(Sq, Sk, causal, window, dev, k_offset)


def time_flash(case, dev, seed=7):
    """K7 on one bf16 case against its twin, timed eager (in turns with
    SDPA under the same mask) and replayed beside its bound (the pairs
    the mask lets through); returns its record."""
    err, (q, k, v) = _check_flash_case(case, torch.bfloat16, dev, seed)
    B, Sq, Sk, H, K, d, causal, window = case[:8]
    off = _offset(case)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    is_causal, mask = _sdpa_mask(Sq, Sk, causal, window, dev, off)
    kern = lambda: kf.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                      window=window, k_offset=off)
    k_ms, l_ms = in_turns(
        kern, lambda: sdpa(qt, kt, vt, is_causal=is_causal, attn_mask=mask,
                           enable_gqa=True))
    p_ms = cuda_ms(lambda: kf.flash_attention_ref(
        q, k, v, causal=causal, window=window, k_offset=off), iters=5)
    flops = 4.0 * d * _flash_pairs(Sq, Sk, causal, window, off) * B * H
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    mask_s = ("causal" if causal else "non-causal") + (
        f" window {window}" if window else "") + (
        f" k_offset {off}" if off else "")
    print(f"kernel flash_attention bf16 {case[:6]} {mask_s}: kernel_ms "
          f"{k_ms} ref_ms {p_ms} sdpa_ms {l_ms} bound_ms {b_ms} ({b_by})"
          f" max_abs_err {err} TFLOP/s {flops / k_ms / 1e9}")
    print(f"K7 {case[:6]}: kernel / sdpa {k_ms / l_ms} (same call, in "
          f"turns); {b_ms / k_ms} of the bound")
    g_ms = graph_ms(kern)
    print(f"K7 {case[:6]}: CUDA-graph replay {g_ms} ms, {b_ms / g_ms} "
          "of the bound")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=l_ms, max_abs_err=err, graph_ms=g_ms)


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

    del engine
    serve_breakdown("serve", model, params, prompts, dev)

    # first-token logits against the exact-length prefill + decode loop
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
    forward_4096("forward 4096", model, params, dev)
    return launches


def serve_breakdown(what, model, params, prompts, dev):
    """The engine's time by step kind, on a fresh engine: host clock around
    each engine step, synchronised (a step that admitted requests ran
    their prefill); then one prefill dispatch as the engine makes it, at
    the smallest and the largest (batch, prompt) bucket: fresh caches,
    then the prompt pass. Returns the decode-only steps' median ms."""
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
    del eng
    print(f"{what}: decode-only step ms median {float(np.median(dec_ms))} "
          f"(of {len(dec_ms)}); steps with prefill ms {pre_ms}")
    s_max = max(launch_serve.PROMPT_BUCKETS) + 16
    for shape in ((1, 16), (4, 64)):
        toks = torch.ones(shape, dtype=torch.long, device=dev)
        ms = cuda_ms(lambda: model.prefill(
            params, {"tokens": toks}, model.init_cache(shape[0], s_max)),
            iters=5, warmup=1)
        print(f"{what}: prefill dispatch {shape} ms {ms}")
    return float(np.median(dec_ms))


def forward_4096(what, model, params, dev, extra=None, n_k7=0):
    """One 4096-token sequence through ``loss`` (with `extra`'s entries in
    its batch: an enc-dec model's frames): K7 once per layer (`n_k7` where
    given), all through its Hopper design, and a finite loss. Returns the
    ms."""
    cfg = model.cfg
    n_k7 = n_k7 or cfg.n_layers
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(1, cfg.vocab_size, (1, 4096), generator=g,
                         device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, parts = model.loss(params, {"tokens": toks, **(extra or {})})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    require_counts(what, {"flash_attention": n_k7})
    require_wgmma(what)
    require(bool(torch.isfinite(loss)), f"{what}: loss {loss}")
    print(f"{what}: loss {float(loss)} (aux {float(parts['aux'])}) in {ms} "
          f"ms, {n_k7} K7 launches")
    return ms


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


def _device_rows(prof):
    """[(device us, launches, name)] of a finished profile's kernels (and
    copies), summed by name from its raw events: key_averages() parses every
    event into a FunctionEvent first, which took ~40 s for three eager SSM
    steps (~10^5 kernels a step). GPU-side spans of record_function ranges
    are left out: they cover kernels already counted."""
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation():
            continue
        us, n = rows.get(e.name(), (0.0, 0))
        rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return [(us, n, name) for name, (us, n) in rows.items()]


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
    rows = sorted(_device_rows(prof), reverse=True)
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
    # scope and n_solve are the last two columns (the spec column's
    # values hold spaces)
    head = table[0].split()[-2:]
    rows = [dict(zip(head, ln.split()[-2:])) for ln in table[1:]]
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
# 80GB HBM3, 700 W). It trained at 14 until phase 21 (the mesh) brought
# the script to 1,210.7 s on a slower host (phase 15 138.1 s of it): it
# trains at 4, one kind of layer, so the cut drops no code path; at 2
# since phase 21(f) brought the script to 1,042.9 s on an H100 80GB HBM3
# (700 W; phase 15 55.5 s of it)
LM_LAYERS = 2
# 72 steps (two jumps, at 41 and 65): the script's time left room for
# phase 17 at 96
LM_STEPS, LM_BATCH, LM_SEQ = 72, 8, 4096
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
               ("sort", ("sort",)),
               ("gather/scatter", ("gather", "scatter")),
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
# (B, Sq, Sk, H, K, d, causal, window), as K7's cases: one microbatch's
# attention in the LM phase first, then GQA rep 1 and 8, windows,
# non-causal, d 16-128 and the tile edges (64 keys per dK/dV CTA, 64
# queries per dQ CTA, inner tiles of 32 / 16; the Hopper design's 128 keys
# per dK/dV CTA, 64 queries per dQ tile), then Sq != Sk at those edges in
# both directions, at d 64 and 128 (cross-attention's shapes: phase 19)
LM_ATTN = (2, LM_SEQ, LM_SEQ, 32, 4, 64, True, 0)
BWD_CASES = (
    [LM_ATTN, (2, 256, 256, 8, 2, 64, True, 0),
     (1, 200, 200, 8, 8, 128, True, 0), (1, 160, 160, 8, 1, 64, False, 0),
     (1, 256, 256, 4, 2, 64, True, 48), (2, 100, 100, 4, 2, 16, False, 30),
     (1, 96, 96, 4, 4, 48, True, 0)]
    + [(1, s, s, 8, 1, d, True, 0) for d in (64, 128)
       for s in (127, 128, 129, 257)]
    + [case for d in (64, 128) for case in
       [(1, 129, 257, 8, 1, d, False, 0), (2, 257, 127, 4, 4, d, False, 0),
        (1, 64, 1500, 8, 8, d, False, 0), (1, 1500, 129, 8, 2, d, False, 0),
        (1, 127, 257, 8, 8, d, True, 0), (1, 257, 128, 4, 1, d, True, 0)]])


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
        s = kf._scores_ref(q[b:b + 1], k[b:b + 1], True, 0)[0]
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
    B, Sq, Sk, H, K, d, causal, window = case[:8]
    off = _offset(case)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((B, Sq, H, d), (B, Sk, K, d),
                                   (B, Sk, K, d), (B, Sq, H, d)))
    mask = dict(causal=causal, window=window, k_offset=off)
    out, lse = kf.flash_attention_lse(q, k, v, **mask)
    require(torch.equal(out, kf.flash_attention(q, k, v, **mask)),
            f"K7 {case} {dtype}: the log-sum-exp output changed the output")
    lse_err = float((lse - kf.lse_ref(q, k, **mask)).abs().max())
    require(lse_err <= LSE_ATOL, f"K7 {case} {dtype}: log-sum-exp off its "
            f"twin by {lse_err} > {LSE_ATOL}")
    w0 = kf.LAUNCHES["flash_attention_bwd_wgmma"]
    got = kf.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    again = kf.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    require(kf.LAUNCHES["flash_attention_bwd_wgmma"] - w0 ==
            2 * kf.uses_wgmma(dtype, d), f"K7b {case} {dtype}: wrong design "
            "launched")
    want = kf.flash_attention_bwd_ref(q, k, v, dout, out=out, **mask)
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
    return time_flash_bwd(LM_ATTN, dev)


def time_flash_bwd(case, dev, seed=7):
    """K7b on one bf16 case against its twin (row by row), timed eager (in
    turns with SDPA's backward) and replayed beside its bound; returns its
    record."""
    errs, _, (q, k, v, dout), (out, lse) = _bwd_case(
        case, torch.bfloat16, dev, seed=seed)
    err = max(errs[g] for g in ("dq", "dk", "dv"))
    torch.cuda.empty_cache()
    B, Sq, Sk, H, K, d, causal, window = case[:8]
    off = _offset(case)
    kern = lambda: kf.flash_attention_bwd(  # noqa: E731
        q, k, v, out, dout, lse, causal=causal, window=window, k_offset=off)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    is_causal, mask = _sdpa_mask(Sq, Sk, causal, window, dev, off)
    with torch.enable_grad():
        o_lib = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=is_causal, attn_mask=mask, enable_gqa=True)
    d_lib = dout.transpose(1, 2)
    lib = lambda: torch.autograd.grad(o_lib, leaves, d_lib,  # noqa: E731
                                      retain_graph=True)
    k_ms, l_ms = in_turns(kern, lib, iters=20)
    p_ms = cuda_ms(lambda: kf.flash_attention_bwd_ref(
        q, k, v, dout, causal=causal, window=window, k_offset=off), iters=3,
        warmup=1)
    g_ms = graph_ms(kern)
    pairs = _flash_pairs(Sq, Sk, causal, window, off)
    flops = 10.0 * d * pairs * B * H          # S, dP, dV, dK, dQ
    # q, O, dO in and dq out; k, v in and dk, dv out; the log-sum-exp in
    nbytes = 2 * 4 * (q.numel() + k.numel()) + 4 * lse.numel()
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    mask_s = ("causal" if causal else "non-causal") + (
        f" window {window}" if window else "") + (
        f" k_offset {off}" if off else "")
    print(f"kernel flash_attention_bwd bf16 {case[:6]} {mask_s}: kernel_ms "
          f"{k_ms} graph_ms {g_ms} ref_ms {p_ms} sdpa_bwd_ms {l_ms} "
          f"bound_ms {b_ms} ({b_by}) row error {err} TFLOP/s "
          f"{flops / k_ms / 1e9}")
    print(f"K7b {case[:6]}: kernel / sdpa backward {k_ms / l_ms} (same "
          f"call, in turns); {b_ms / k_ms} of the bound eager, "
          f"{b_ms / g_ms} replayed")
    del o_lib, leaves
    rec = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=l_ms, max_abs_err=errs["max_abs"], row_err=err,
               graph_ms=g_ms, shape=list(case[:6]), k_offset=off)
    if "control" in errs:
        rec.update(control_row_err=errs["control"],
                   wrong_row_err=errs["wrong"])
    return rec


# kv-SP's key offset (B, Sq, Sk, H, K, d, causal, window, k_offset) at the
# ranks' full-width shapes under a "model" axis of 2, timed: TinyLlama's
# 1024 tokens split in two (rank 0's keys, rank 1's at offset 512), Gemma3's
# window layer at 4096 (rank 1), Whisper's encoder (1500 frames, rank 1's
# 750) and its cross-attention (1024 queries over 750 frames,
# non-causal), and d 80 through the sm_80-unit design
KV_SP_CASES = {
    "kv-sp tinyllama r0": (1, 1024, 512, 32, 4, 64, True, 0, 0),
    "kv-sp tinyllama r1": (1, 1024, 512, 32, 4, 64, True, 0, 512),
    "kv-sp gemma window r1": (1, 4096, 2048, 32, 16, 128, True, 1024, 2048),
    "kv-sp whisper encoder r1": (1, 1500, 750, 8, 8, 64, False, 0, 750),
    "kv-sp whisper cross r1": (1, 1024, 750, 8, 8, 64, False, 0, 750),
    "kv-sp d80 r1": (1, 1024, 512, 32, 32, 80, True, 0, 512),
}
# checked in fp32 and bf16 (both designs), not timed: offsets at the tile
# edges, odd lengths, a window across the offset, non-causal
KV_SP_CHECKS = [(1, 300, 150, 8, 2, 64, True, 0, 150),
                (1, 257, 129, 4, 4, 128, True, 64, 128),
                (2, 200, 77, 4, 1, 80, True, 0, 123),
                (1, 129, 64, 8, 8, 64, False, 0, 65)]
# planted: the keys past every query, so that no row of any CTA sees a key
# (out 0, log-sum-exp -1e30, dq, dk and dv 0, and no hang), through the
# Hopper design (bf16 d 64) and the sm_80-unit ones (bf16 d 80, fp32)
KV_SP_BLIND = [(1, 256, 128, 8, 2, 64, True, 0, 256),
               (1, 256, 128, 8, 2, 80, True, 0, 300)]


def _check_blind(case, dtype, dev):
    """A KV_SP_BLIND case: every output exactly the no-key contract."""
    _, _, (q, k, v, dout), (out, lse) = _bwd_case(case, dtype, dev, seed=11)
    mask = dict(causal=case[6], window=case[7], k_offset=_offset(case))
    grads = kf.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    torch.cuda.synchronize()
    require(not out.any() and bool((lse == kf.NEG_INF).all())
            and not any(t.any() for t in grads), f"blind {case} {dtype}: "
            f"out {float(out.float().abs().max())}, lse "
            f"{float(lse.max())}, grads "
            f"{[float(t.float().abs().max()) for t in grads]}")


def _check_merge(dev, seed=13):
    """kv-SP at TinyLlama's shape on one card, in plain PyTorch around the
    kernels: K7 on the two halves of the keys (offsets 0 and 512) merged
    by their log-sum-exps equals K7 over all of them; K7b on each half
    given the merged output and log-sum-exp equals its twin on them
    (``flash_attention_bwd_ref(..., lse=)``), row by row. Returns the
    errors."""
    B, S, H, K, d = 1, 1024, 32, 4, 64
    g = torch.Generator(device=dev).manual_seed(seed)
    q, dout = (torch.randn((B, S, H, d), generator=g, device=dev).bfloat16()
               for _ in range(2))
    k, v = (torch.randn((B, S, K, d), generator=g, device=dev).bfloat16()
            for _ in range(2))
    halves = [(0, S // 2), (S // 2, S)]
    parts = [kf.flash_attention_lse(q, k[:, a:b], v[:, a:b], k_offset=a)
             for a, b in halves]
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(lse - m).transpose(1, 2)[..., None] for _, lse in parts]
    den = w[0] + w[1]
    out = ((parts[0][0].float() * w[0] + parts[1][0].float() * w[1])
           / den).bfloat16()
    L = (m + torch.log(den[..., 0]).transpose(1, 2)).contiguous()
    whole, lse = kf.flash_attention_lse(q, k, v)
    errs = {"out": max_err(out.float(), whole.float()),
            "lse": float((L - lse).abs().max())}
    atol, rtol = FLASH_TOL[torch.bfloat16]
    require(bool(((out.float() - whole.float()).abs()
                  <= atol + rtol * whole.float().abs()).all())
            and errs["lse"] <= LSE_ATOL, f"kv-SP merge: {errs}")
    for a, b in halves:
        got = kf.flash_attention_bwd(q, k[:, a:b], v[:, a:b], out, dout, L,
                                     k_offset=a)
        want = kf.flash_attention_bwd_ref(q, k[:, a:b], v[:, a:b], dout,
                                          k_offset=a, out=out, lse=L)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            errs[f"{name} [{a}, {b})"] = row_err(x, y)
    require(max(v_ for n, v_ in errs.items() if n[0] == "d")
            <= BWD_ROW_TOL[torch.bfloat16], f"kv-SP K7b on the merged "
            f"output: {errs}")
    return errs


def check_kv_sp_kernels(dev, records):
    """Phase 21(g), the kernels: K7 and K7b with a key offset against their
    twins (KV_SP_CHECKS in fp32 and bf16, KV_SP_CASES in bf16, the launches
    counted under the offset keys), the planted blind CTAs (KV_SP_BLIND),
    the merge of two halves against the whole (``_check_merge``), and
    KV_SP_CASES timed beside their bounds and SDPA under the same boolean
    mask, into `records`."""
    n = 0
    for case in KV_SP_CHECKS:
        for dtype in (torch.float32, torch.bfloat16):
            _check_flash_case(case, dtype, dev, seed=500 + n)
            _bwd_case(case, dtype, dev, seed=500 + n)
            n += 1
    blind = 0
    for case in KV_SP_BLIND:
        for dtype in (torch.float32, torch.bfloat16):
            _check_blind(case, dtype, dev)
            blind += 1
    merge = _check_merge(dev)
    print(f"kv-sp kernels: {n} offset cases match the twins (K7 within "
          f"{FLASH_TOL}, K7b row by row within {BWD_ROW_TOL}); {blind} blind "
          f"cases give out 0, log-sum-exp -1e30 and zero gradients; the "
          f"merge of two halves vs the whole and K7b on the merged output "
          f"{merge}")
    for tag, case in KV_SP_CASES.items():
        w0 = dict(kf.LAUNCHES)
        records["flash_attention"][tag] = time_flash(case, dev)
        records["flash_attention_bwd"][tag] = time_flash_bwd(case, dev)
        require(records["flash_attention_bwd"][tag]["row_err"]
                <= BWD_ROW_TOL[torch.bfloat16], f"kv-sp K7b {tag}: "
                f"{records['flash_attention_bwd'][tag]}")
        off = {k: kf.LAUNCHES[k] - w0[k] for k in
               ("flash_attention_offset", "flash_attention_bwd_offset")}
        require(min(off.values()) > 0 if _offset(case)
                else not any(off.values()), f"kv-sp {tag}: offset "
                f"launches {off}")
    records["flash_attention"]["kv_sp_merge"] = merge


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


def _lm_fit(acfg, model, steps, on_step, cuda_graphs=True, grid=None):
    """One run of the launcher's ``run`` from fresh params, the counts set
    to 0 just before (read them just after); ``on_step(t, trainer,
    state)`` after every step, on the resident state the loop updates in
    place. With `grid`, the Trainer's ``fit`` takes the launcher's stream
    with each batch's M-RoPE positions those of a sequence that opens with
    a stub image block of grid[0] x grid[1] patches (``image_positions``:
    the three streams differ there). Returns (trainer, state, losses,
    per-step seconds)."""
    trainer = launch_train.make_trainer(acfg, model, cuda_graphs=cuda_graphs)
    state = launch_train.fresh_state(trainer)
    losses, stamps = [], [time.perf_counter()]

    def on_metrics(t, m):
        losses.append(float(m["loss"]))        # synchronises
        stamps.append(time.perf_counter())
        on_step(t, trainer, state)
    if grid is None:
        reset_counts()
        launch_train.run(acfg, model, steps=steps, trainer=trainer,
                         state=state, log_every=0, on_metrics=on_metrics)
    else:
        tc = acfg.train
        pos = image_positions(tc.global_batch, tc.seq_len, grid,
                              device=model.device)
        batches = (dict(b, positions=pos) for b in synthetic_lm_batches(
            tc.seed, tc.global_batch, tc.seq_len, acfg.model.vocab_size,
            device=model.device, **stream_kwargs(acfg.model)))
        reset_counts()
        trainer.fit(batches, steps, state=state, log_every=0,
                    on_metrics=on_metrics)
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


def _lm_breakdown(prof, wall_s, steps, what="tinyllama-train",
                  label="eager record steps", families=None):
    """Device ms per step by kernel family (default LM_FAMILIES), the busy
    share over the traced wall, and the top kernels; returns the ms per
    step by family."""
    families = families or LM_FAMILIES
    fams, rows = {}, _device_rows(prof)
    for us, _, key in rows:
        name = key.lower()
        fam = next((f for f, keys in families
                    if any(k in name for k in keys)), "other")
        fams[fam] = fams.get(fam, 0.0) + us
    busy = sum(fams.values())
    if busy <= 0:
        print(f"{what} profile ({label}): no device time in the trace "
              "(busy share not measured)")
        return {}
    per_step = {f: us / steps / 1e3 for f, us in sorted(
        fams.items(), key=lambda kv: -kv[1])}
    print(f"{what} profile ({steps} {label}): wall {wall_s / steps * 1e3} ms/step, device "
          f"{busy / steps / 1e3} ms/step, busy share {busy / 1e6 / wall_s}; "
          f"device ms/step by family {per_step}; shares "
          f"{ {f: us / busy for f, us in fams.items()} }")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {us / steps / 1e3:10.3f} ms/step {count // steps:6d} a step "
              f"{us / busy:7.3f}  {key[:100]}")
    return per_step


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


# -- phase 16: the MoE family ------------------------------------------------
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402

MOE_ARCH = "qwen3-moe-30b-a3b"
PAIR_ARCH = "llama4-maverick-400b-a17b"
# the configs' widths as the reference sets them: layers, d, query / kv
# heads of head_dim, experts, top-k, expert d_ff, vocab, dtype
MOE_WIDTHS = (48, 2048, 32, 4, 128, 128, 8, 768, 151936, "bfloat16")
PAIR_WIDTHS = (2, 5120, 40, 8, 128, 128, 1, 8192, 202048, "bfloat16")
# Qwen3-30B-A3B's bf16 weights, reckoned from its config (PERF.md §4)
MOE_WEIGHT_BYTES = 2 * 30_532_110_336
# training: depth cut to 2 (3 layers' state exceeds 90% of the card), 48
# steps at 8 x 4096 (warm-up 12: jumps at 29 and 47), graphed; then eagerly
# through the first jump
MOE_LAYERS, MOE_STEPS = 2, 48
# one MoE layer at full width, card against CPU, on this many tokens
MOE_LAYER_TOKENS = 64
# a token whose sorted router probabilities (its first k + 1) have two
# within MOE_NEAR of each other is a near-tie: the card's and the CPU's
# fp32 router products may order it differently (their probabilities must
# agree to within MOE_NEAR / 4); an expert's row is a near-tie where its
# kept gates have such a pair or it routes a near-tie token
MOE_NEAR = 1e-6
# the layer's bf16 output, aux loss and gradients, card against CPU: within
# MOE_LAYER_TOL of the CPU tensor's largest magnitude (bf16 rounding of the
# expert products and of the combine's running sum, 2^-8 relative a step,
# in two summation orders)
MOE_LAYER_TOL = 3e-2
# the 4096-token attention of one Qwen3 microbatch: K7 at (1, 4096, 32, 4,
# 128), K7b at (2, 4096, 32, 4, 128), bf16 causal
MOE_K7 = (1, 4096, 4096, 32, 4, 128, True, 0)
MOE_K7B = (2, 4096, 4096, 32, 4, 128, True, 0)
# K1 on an LM's bf16 ring (phase 16's MoE ring, phase 17's SSM rings:
# 190k-608k blocks a system) against its float64 twin: at most
# K1_TWIN_FACTOR times the chunked fp32 twin's own distance from it, in the
# same run (check_ring_buckets). K1 sums each thread's products in three
# levels (csrc/arena.cu); the twin sums a block's 512 products and then
# the blocks of a chunk. One running sum a thread (27,648 products in a
# row on the MoE ring) read 14-46x the twin's there (PERF.md §6).
K1_TWIN_FACTOR = 2.0
# the rings held so (the LM runs' big bf16 rings); a smaller bucket (the
# fp32 params': norms, routers, the SSM's scalars) is held at RTOL, as the
# paper arena is: a few ulps either way would make a ratio of noise there
K1_RING_BLOCKS = 1 << 20


def _at_length(caches, n):
    """`caches` (KVCaches, nested for moe_pair) at host length n."""
    if isinstance(caches, dict):
        return {k: _at_length(v, n) for k, v in caches.items()}
    return KVCache(caches.k, caches.v, n)


def _padded_first_logits(model, params, prompt, s_max):
    """A request's first-token logits as the engine computes them, by hand:
    the prompt padded with zeros to its bucket through ``prefill``, then
    one ``decode_step`` of its last token at true_len - 1."""
    pb = next(b for b in launch_serve.PROMPT_BUCKETS if len(prompt) <= b)
    toks = torch.zeros((1, pb), dtype=torch.long, device=model.device)
    toks[0, :len(prompt)] = torch.tensor(prompt, device=model.device)
    last = torch.tensor([[prompt[-1]]], device=model.device)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks},
                                  model.init_cache(1, s_max))
        logits, _ = model.decode_step(params, {"tokens": last},
                                      _at_length(caches, len(prompt) - 1))
    return logits[0, -1].float().cpu().numpy()


def serve_moe(dev, what, arch, widths, n_layers=0):
    """Phase 16 (a) and (d): the launcher's model and engine at `arch`'s
    widths (`n_layers` > 0 cuts the depth), serving its stream with the
    launches counted; the time by step kind; every request's first-token
    logits against the same padded prompt run by hand; one 4096-token
    forward. Returns (model, params, launches)."""
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, params, engine = launch_serve.build(arch, device=dev,
                                               n_layers=n_layers)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, m = model.cfg, model.cfg.moe
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, m.n_experts, m.top_k, m.expert_d_ff, cfg.vocab_size,
           cfg.dtype)
    require(got == widths, f"{what}: config {got}, expected {widths}")
    leaves = leaves_with_paths(params)
    served = dict(leaves_with_paths(engine.params))
    require(all(served[p].data_ptr() == t.data_ptr() for p, t in leaves),
            f"{what}: the engine holds a copy of the weights")
    wbytes = sum(t.numel() * t.element_size() for _, t in leaves)
    print(f"{what}: {arch} at {cfg.n_layers} layers, "
          f"{model.param_count(params)} params, {wbytes} bytes of weights, "
          f"built (drawn on the card) in {build_s} s; allocated "
          f"{torch.cuda.memory_allocated(dev)} bytes, peak "
          f"{torch.cuda.max_memory_allocated(dev)} ({torch.cuda.max_memory_allocated(dev) / total} "
          "of the card); one copy: the engine serves the drawn tensors")
    prompts = launch_serve.request_stream(12, cfg.vocab_size)
    done, launches = _serve_counted(f"{what} path", engine, prompts)
    del engine
    dec_ms = serve_breakdown(what, model, params, prompts, dev)
    eng = launch_serve.make_engine(model, params, new_tokens=1)
    firsts = {r.uid: r.last_logits for r in
              launch_serve.serve(eng, prompts)[0]}
    del eng
    s_max = max(launch_serve.PROMPT_BUCKETS) + 1
    worst = 0.0
    for uid, got in sorted(firsts.items()):
        want = _padded_first_logits(model, params, prompts[uid], s_max)
        err = float(np.abs(got - want).max())
        scale = max(1.0, float(np.abs(want).max()))
        require(err <= SERVE_LOGIT_TOL * scale, f"{what} request {uid}: "
                f"first-token logits off the padded prompt by hand by {err}"
                f" (scale {scale})")
        worst = max(worst, err / scale)
    print(f"{what}: first-token logits vs the padded prompt by hand "
          f"(prefill at the bucket, one decode step at true_len - 1): worst "
          f"|diff| / max(1, max|logits|) {worst} (limit {SERVE_LOGIT_TOL}) "
          f"over {len(firsts)} requests; decode-only step median {dec_ms} ms")
    forward_4096(f"{what} forward 4096", model, params, dev)
    return model, params, launches


def _moe_layer(p, x, dout, cfg):
    """One MoE layer forward and backward: (out, aux, {name: gradient},
    probs, top_i, sel_idx)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    xr = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        out, aux = moe_mod.apply_moe(xr, leaves, cfg)
        ((out.float() * dout).sum() + aux).backward()
    with torch.no_grad():
        probs, top_i, _, routing = moe_mod.route(x, p, cfg)
    grads = {"x": xr.grad, **{k: v.grad for k, v in leaves.items()}}
    return out.detach(), aux.detach(), grads, probs, top_i, routing.sel_idx


def _near_ties(probs, top_i, k, cap):
    """Per token, per expert row: (near-tie tokens (B, S), near-tie expert
    rows (B, E)) of a run's routing (see MOE_NEAR)."""
    top = torch.sort(probs, dim=-1, descending=True)[0][..., :k + 1]
    tok = ((top[..., :-1] - top[..., 1:]) < MOE_NEAR).any(-1)
    gate = torch.zeros_like(probs).scatter(-1, top_i,
                                           probs.gather(-1, top_i))
    g = torch.sort(gate.transpose(1, 2), dim=-1, descending=True)[0]
    g = g[..., :cap + 1]
    close = ((g[..., :-1] - g[..., 1:]) < MOE_NEAR) & (g[..., 1:] > 0)
    routes = torch.zeros_like(probs, dtype=torch.bool).scatter(
        -1, top_i, True)
    row = close.any(-1) | (routes & tok[..., None]).any(1)
    return tok, row


def check_moe_layer(dev):
    """Phase 16 (b): one Qwen3-30B-A3B MoE layer at full width on
    MOE_LAYER_TOKENS tokens, forward and backward on the card twice (bit
    for bit the same) and on the CPU from the same params and inputs: the
    same token top-k and expert choice but at near-ties, and the output,
    aux and every gradient within MOE_LAYER_TOL."""
    cfg = get_config(MOE_ARCH).model
    g = torch.Generator(device=dev).manual_seed(16)
    p = moe_mod.moe_init(g, cfg, dev)
    x = torch.randn((1, MOE_LAYER_TOKENS, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    dout = torch.randn(x.shape, generator=g, device=dev)
    t0 = time.perf_counter()
    card = _moe_layer(p, x, dout, cfg)
    again = _moe_layer(p, x, dout, cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    for name, a, b in zip(("out", "aux", "probs", "top_i", "sel_idx"),
                          card[:2] + card[3:], again[:2] + again[3:]):
        require(torch.equal(a, b), f"moe layer: repeat runs differ in {name}")
    for name in card[2]:
        require(torch.equal(card[2][name], again[2][name]),
                f"moe layer: repeat runs differ in d{name}")
    del again
    host = lambda t: t.detach().to("cpu")  # noqa: E731
    t0 = time.perf_counter()
    cpu = _moe_layer({k: host(v) for k, v in p.items()}, host(x),
                     host(dout), cfg)
    cpu_s = time.perf_counter() - t0
    out, aux, grads, probs, top_i, sel_idx = (
        card[0].cpu(), card[1].cpu(), {k: host(v) for k, v in
                                       card[2].items()},
        card[3].cpu(), card[4].cpu(), card[5].cpu())
    c_out, c_aux, c_grads, c_probs, c_top, c_sel = cpu
    k, cap = cfg.moe.top_k, moe_mod.capacity(MOE_LAYER_TOKENS, cfg)
    p_err = float((probs - c_probs).abs().max())
    require(p_err <= MOE_NEAR / 4, f"moe layer: router probabilities off the"
            f" CPU's by {p_err} > {MOE_NEAR / 4}")
    tok, row = _near_ties(c_probs, c_top, k, cap)
    tok2, row2 = _near_ties(probs, top_i, k, cap)
    tok, row = tok | tok2, row | row2
    bad_tok = (top_i != c_top).any(-1) & ~tok
    bad_row = (sel_idx != c_sel).any(-1) & ~row
    require(not bool(bad_tok.any()), f"moe layer: top_i differs from the "
            f"CPU's at {int(bad_tok.sum())} tokens that are not near-ties")
    require(not bool(bad_row.any()), f"moe layer: sel_idx differs from the "
            f"CPU's in {int(bad_row.sum())} expert rows that are not "
            "near-ties")
    # tokens and experts a near-tie may route differently are left out of
    # the comparison; the router's gradient sums over every token, so it is
    # compared only without near-ties
    clean = not bool(tok.any() or row.any())
    keep_tok = ~tok[0]
    for e in torch.nonzero(row[0]).flatten().tolist():
        keep_tok &= ~(c_sel[0, e, :, None] ==
                      torch.arange(MOE_LAYER_TOKENS)).any(0)
        keep_tok &= ~(sel_idx[0, e, :, None] ==
                      torch.arange(MOE_LAYER_TOKENS)).any(0)
    keep_exp = ~row[0]
    pairs = [("out", out[0, keep_tok], c_out[0, keep_tok]),
             ("aux", aux, c_aux),
             ("dx", grads["x"][0, keep_tok], c_grads["x"][0, keep_tok])]
    for name in ("experts_in", "experts_gate", "experts_out"):
        pairs.append((f"d{name}", grads[name][keep_exp],
                      c_grads[name][keep_exp]))
    if clean:
        pairs.append(("drouter", grads["router"], c_grads["router"]))
    errs = {}
    for name, a, b in pairs:
        a, b = a.float(), b.float()
        require(bool(torch.isfinite(a).all()), f"moe layer: {name} not "
                "finite")
        scale = float(b.abs().max())
        errs[name] = float((a - b).abs().max()) / max(scale, 1e-30)
        require(errs[name] <= MOE_LAYER_TOL, f"moe layer: {name} off the "
                f"CPU's by {errs[name]} of its largest magnitude > "
                f"{MOE_LAYER_TOL}")
    print(f"moe layer: Qwen3-30B-A3B's MoE layer (E 128, top-8, d 2048, "
          f"expert d_ff 768, cap {cap}) on {MOE_LAYER_TOKENS} tokens, "
          f"forward and backward: card twice bit-identical (out, aux, every "
          f"gradient, top_i, sel_idx); against the CPU: router "
          f"probabilities within {p_err}, near-tie tokens "
          f"{int(tok.sum())}, near-tie expert rows {int(row.sum())} (both "
          f"left out), top_i and sel_idx equal elsewhere; error / largest "
          f"magnitude {errs} (limit {MOE_LAYER_TOL}); card {card_s} s for "
          f"two runs, CPU {cpu_s} s")


def _gram_row_twin(x, q, block_sys, n_sys, anchor, chunk=1 << 16):
    """K1's plain twin (``ka.gram_row_ref``) a block range at a time: its
    fp32 copy of a bf16 ring would not fit beside the training state."""
    return sum(ka.gram_row_ref(x[a:a + chunk], q[a:a + chunk],
                               block_sys[a:a + chunk], n_sys,
                               anchor_first=anchor)
               for a in range(0, x.shape[0], chunk))


def check_ring_buckets(dev, what, table, bufs, anchor, records, field,
                       chunk=1 << 16):
    """K1 and K2 on an LM run's own rings, every bucket: K1 against its
    float64 twin (within ``K1_TWIN_FACTOR`` of the chunked fp32 twin's
    distance from it), K2 against its fp32 twin block range by block range
    (rows of a block, RTOL), repeat launches bit-identical; timed eager in
    turns (K1 with its chunked twin, K2 with ``einsum`` on the
    block-gathered coefficients in the ring's dtype, held to the twin
    within its bf16 rounding) and replayed, beside the bound. Recorded as
    the `field` entries of K1's and K2's records."""
    for name in ("gram_row", "combine"):
        records[name][field] = []
    for key, b in table.items():
        x, seg = bufs[key], b.tables_on(dev)
        nb, m, bn = x.shape
        q = x[:, m - 1, :]
        bs = seg.block_sys
        xbytes = x.numel() * x.element_size()
        # K1
        kern = lambda: ka.gram_row(x, q, seg, anchor_first=anchor)  # noqa
        twin = lambda: _gram_row_twin(x, q, bs, seg.n_sys,  # noqa: E731
                                      anchor, chunk)
        exact = _gram_row_f64(x, q, bs, seg.n_sys, anchor)
        got = kern().double()
        err = max_err(got, exact)
        t_err = max_err(twin().double(), exact)
        if nb > K1_RING_BLOCKS:                 # the LM-sized ring
            require(err <= K1_TWIN_FACTOR * t_err, f"gram_row {what} bucket"
                    f" {key}: K1 off its float64 twin by {err}, more than "
                    f"{K1_TWIN_FACTOR} x the chunked fp32 twin's {t_err}")
        else:                                   # norms, routers, SSM scalars
            check_close(f"gram_row {what} bucket {key} (float64 twin)", got,
                        exact, seg.n_sys)
        require(torch.equal(kern(), kern()), f"gram_row {what} bucket {key}:"
                " repeat launches differ")
        k_ms, p_ms = in_turns(kern, twin, iters=5)
        r_ms = graph_ms(kern, iters=3)
        b_ms, b_by = bound_ms(xbytes + seg.n_sys * m * 4, 2.0 * x.numel())
        print(f"{what} bucket {key} {(nb, m, bn)} n_sys {seg.n_sys} "
              f"{x.dtype}: gram_row kernel_ms {k_ms} graph_ms {r_ms} ref_ms "
              f"{p_ms} library_ms None bound_ms {b_ms} ({b_by}), "
              f"{b_ms / r_ms} of the bound replayed, max_abs_err {err} from "
              f"the float64 twin (the chunked fp32 twin's {t_err}, "
              f"{err / max(t_err, 1e-300)}x; limit {K1_TWIN_FACTOR}x); row "
              f"scale {float(exact.abs().max())}")
        records["gram_row"][field].append(dict(
            bucket=key, shape=[nb, m, bn], n_sys=seg.n_sys, ms=k_ms,
            graph_ms=r_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
            max_abs_err=err, twin_err=t_err))
        del exact, got
        # K2
        c = torch.randn((seg.n_sys, m), generator=torch.Generator(
            device=dev).manual_seed(9), device=dev)
        cg = c[bs.to(dev, torch.long)]
        kern = lambda: ka.combine(x, c, seg)  # noqa: E731
        lib = lambda: torch.einsum("bmn,bm->bn", x,  # noqa: E731
                                   cg.to(x.dtype))
        got, again = kern(), kern()
        require(torch.equal(got, again), f"combine {what} bucket {key}: "
                "repeat launches differ")
        del again
        err = l_err = 0.0
        for a in range(0, nb, chunk):
            want = ka.combine_ref(x[a:a + chunk], c, bs[a:a + chunk])
            rows = want.numel() // bn
            err = max(err, check_close(f"combine {what} bucket {key}",
                                       got[a * bn:a * bn + want.numel()],
                                       want, rows))
            l_part = torch.einsum("bmn,bm->bn", x[a:a + chunk],
                                  cg[a:a + chunk].to(x.dtype)).float()
            # the library's bf16 rounding of c and of its output: 2^-9 of
            # sum_j |c_j x_j| each, which cancellation can leave far above
            # the output's own size
            l_bound = 2.0 ** -7 * torch.einsum(
                "bmn,bm->bn", x[a:a + chunk].abs().float(),
                cg[a:a + chunk].abs()).clamp_min(1.0).reshape(-1)
            l_dev = ((l_part.reshape(-1) - want).abs() / l_bound).max()
            require(float(l_dev) <= 1.0, f"einsum {what} bucket {key}: off "
                    f"the twin by {float(l_dev)} of its bf16 rounding bound")
            l_err = max(l_err, float((l_part.reshape(-1) - want).abs().max()))
        del got, want, l_part, l_bound
        k_ms, l_ms = in_turns(kern, lib, iters=5)
        p_ms = cuda_ms(lambda: [ka.combine_ref(x[a:a + chunk], c,
                                               bs[a:a + chunk])
                                for a in range(0, nb, chunk)],
                       iters=1, warmup=1)
        r_ms = graph_ms(kern, iters=3)
        b_ms, b_by = bound_ms(xbytes + nb * bn * 4 + c.numel() * 4,
                              2.0 * x.numel())
        print(f"{what} bucket {key} {(nb, m, bn)} n_sys {seg.n_sys} "
              f"{x.dtype}: combine kernel_ms {k_ms} graph_ms {r_ms} ref_ms {p_ms} "
              f"library_ms {l_ms} bound_ms {b_ms} ({b_by}), {b_ms / r_ms} "
              f"of the bound replayed, max_abs_err {err} (einsum in "
              f"{x.dtype}: {l_err})")
        records["combine"][field].append(dict(
            bucket=key, shape=[nb, m, bn], n_sys=seg.n_sys, ms=k_ms,
            graph_ms=r_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
            max_abs_err=err))
        del cg
        torch.cuda.empty_cache()
    _require_tickets(f"{what} bucket kernels", dev)


def _step_kinds(acc, steps):
    """What a graphed fit does at each step: a graph key's first step is
    its "warm-up" (eager), its second its "capture" (captured, then
    replayed), every later one a "replay"; then "plain" or "record", and
    " jump" where the step jumps (eagerly, after the train step)."""
    seen, kinds = {}, []
    for t in range(steps):
        key = train_loop.graph_key(acc.slots(t))
        n = seen[key] = seen.get(key, 0) + 1
        kinds.append(("warm-up", "capture", "replay")[min(n, 3) - 1] +
                     (" plain" if key == train_loop.PLAIN else " record") +
                     (" jump" if acc.apply_groups(t) else ""))
    return kinds


def _kind_ms(secs, kinds, jump):
    """Median ms per step of each kind, before and after the step `jump`
    (and how many steps), step 0 out."""
    by = {}
    for t in range(1, len(secs)):
        k = kinds[t] + ("" if t == jump else
                        " before" if t < jump else " after")
        by.setdefault(k, []).append(secs[t] * 1e3)
    return {k: (float(np.median(v)), len(v)) for k, v in sorted(by.items())}


def _tracer(steps, witness, name):
    """An on-step hook profiling the consecutive `steps`: started after the
    step before the first, stopped after the last; witness[name] gets
    (the profile, its wall seconds). Only the card's kernels are traced:
    the breakdown reads device time alone."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])

    def hook(t):
        if t == steps[0] - 1:
            torch.cuda.synchronize()
            prof.start()
            witness[name] = time.perf_counter()
        if t == steps[-1]:
            torch.cuda.synchronize()
            witness[name] = (prof, time.perf_counter() - witness[name])
            prof.stop()
    return hook


def train_moe(dev, records):
    """Phase 16 (c): Qwen3-30B-A3B trained at full width, cut to
    MOE_LAYERS layers, through the launcher's ``run``: graphed, then
    eagerly through the first jump. Returns the graphed run's launches."""
    what = "qwen3-moe-train"
    total = torch.cuda.get_device_properties(dev).total_memory
    reckon = {}
    for n in (0, MOE_LAYERS + 1, MOE_LAYERS):
        acfg = launch_train.configure(MOE_ARCH, steps=MOE_STEPS,
                                      global_batch=LM_BATCH, seq=LM_SEQ,
                                      n_layers=n)
        n_p = launch_train.param_count(launch_train.make_model(acfg,
                                                               device=dev))
        reckon[acfg.model.n_layers] = (n_p, sum(launch_train.state_bytes(
            acfg, n_p).values()))
    print(f"{what}: training state by depth (layers: params, bytes, share "
          f"of the card's {total}): "
          f"{ {n: (p, b, b / total) for n, (p, b) in reckon.items()} }")
    for n in (48, MOE_LAYERS + 1):
        require(reckon[n][1] > launch_train.CARD_FRACTION * total,
                f"{what}: {n} layers fit: the cut is not needed")
    mc, dmd, opt = acfg.model, acfg.dmd, acfg.optimizer
    require((dmd.m, dmd.s, dmd.snapshot_dtype, dmd.param_filter, dmd.arena,
             dmd.streaming_gram, dmd.mode, dmd.scope, dmd.warmup_steps,
             opt.name, opt.lr, opt.b2, opt.weight_decay, opt.grad_clip,
             opt.schedule, acfg.parallel.grad_accum, acfg.parallel.remat,
             mc.moe.n_experts, mc.moe.top_k) ==
            (8, 40, "bfloat16", "all", True, True, "matpow", "leaf",
             MOE_STEPS // 4, "adamw", 3e-4, 0.95, 0.1, 1.0, "cosine", 4,
             "block", 128, 8), f"{what}: config {acfg}")
    model = launch_train.make_model(acfg, device=dev)
    need = launch_train.check_fits(acfg, reckon[MOE_LAYERS][0], total)
    ga = acfg.parallel.grad_accum
    want = {"flash_attention": 2 * MOE_LAYERS * ga * MOE_STEPS,
            "flash_attention_bwd": MOE_LAYERS * ga * MOE_STEPS}
    acc = launch_train.make_trainer(acfg, model).acc
    jumps = [t for t in range(MOE_STEPS) if acc.apply_groups(t)]
    require(len(jumps) >= 2, f"{what}: {len(jumps)} jumps")
    witness = {}
    kinds = _step_kinds(acc, MOE_STEPS)
    # the eager run: through the first jump and the plain steps after it
    eager_steps = next(t for t in range(jumps[0] + 1, MOE_STEPS)
                       if kinds[t] != "replay plain")
    # the same plain steps, before and after the first jump, profiled
    # replayed and eager
    plain = {}
    for when, steps in (("before", range(jumps[0])),
                        ("after", range(jumps[0] + 1, eager_steps))):
        ts = [t for t in steps if kinds[t] == "replay plain"][-LM_PROFILED:]
        require(ts == list(range(ts[0], ts[0] + LM_PROFILED)),
                f"{what}: no {LM_PROFILED} consecutive replayed plain "
                f"steps {when} the first jump")
        plain[when] = ts
    def plain_traces(how):
        return [_tracer(ts, witness, f"{how} plain steps {when} the first "
                        "jump") for when, ts in plain.items()]
    replayed_traces = plain_traces("replayed")

    def at_step(t, trainer, state):
        for trace in replayed_traces:
            trace(t)
        if t == eager_steps - 1:
            witness["graphed"] = _flat_params(state)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before_fit = torch.cuda.memory_allocated(dev)
    trainer, state, losses, secs = _lm_fit(acfg, model, MOE_STEPS, at_step)
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    table = trainer.acc.arena_for(state.params)
    want["gram_row"] = sum(acc.slots(t)[b.group] >= 0
                           for t in range(MOE_STEPS) for b in table.values())
    want["combine"] = sum(b.group in acc.apply_groups(t)
                          for t in jumps for b in table.values())
    require_counts(f"{what} graphed", want)
    require_wgmma(f"{what} graphed")
    require_wgmma(f"{what} graphed", "flash_attention_bwd", "K7b")
    reset_counts()
    print(f"{what} graphed: launches {launches}; jumps at {jumps}; graphs "
          f"{trainer.graph_stats}; buckets "
          f"{[(k, b.n_blocks, b.m, b.block_n, b.n_sys) for k, b in table.items()]}")
    require(np.isfinite(losses).all(), f"{what}: non-finite loss")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    require(last < first, f"{what}: loss {first} -> {last}")
    tokens = LM_BATCH * LM_SEQ
    g_ms = float(np.mean(secs[1:])) * 1e3
    # a replayed plain step against an eager one: a median over the
    # steps after the first jump would mix 10 replays with 8 captures
    replays = [t for t in range(MOE_STEPS) if kinds[t] == "replay plain"]
    g_med = float(np.median(secs[replays])) * 1e3
    print(f"{what} losses {losses}")
    print(f"{what} graphed: ms a step {[float(x) for x in secs * 1e3]}")
    print(f"{what} graphed: median ms a step by kind, before and after the "
          f"first jump (steps): {_kind_ms(secs, kinds, jumps[0])}")
    print(f"{what} graphed: loss mean of the first 10 {first}, of the last "
          f"10 {last}; ms/step {g_ms} (steps 1-{MOE_STEPS - 1}, host clock, "
          f"synchronised per step; step 0 {secs[0] * 1e3}; median of the "
          f"{len(replays)} plain replays {g_med}), {tokens / g_ms * 1e3} "
          f"tokens/s; peak "
          f"allocated {peak} bytes ({peak / 2 ** 30} GiB, {peak / total} of "
          f"the card) beside the reckoned state {need} bytes")
    bufs = state.dmd_buffers["__arena__"]
    torch.cuda.empty_cache()
    check_ring_buckets(dev, "MoE", table, bufs, acfg.dmd.anchor == "first",
                       records, "moe_buckets")
    table_keys = sorted(table)
    records["flash_attention"]["moe_train_launches"] = \
        launches["flash_attention"]
    del trainer, state, table, bufs
    after_fit = torch.cuda.memory_allocated(dev)
    print(f"{what}: {before_fit} bytes allocated before the graphed run, "
          f"{after_fit} once its Trainer and state are dropped (no "
          "gc.collect)")
    require(after_fit - before_fit <= LM_LEFT_BYTES,
            f"{what}: {after_fit - before_fit} bytes outlive the graphed run "
            f"> {LM_LEFT_BYTES}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    traced = range(jumps[0] - LM_PROFILED, jumps[0])
    require(all(acc.slots(t)[0] >= 0 for t in traced) and
            not any(acc.apply_groups(t) for t in traced),
            f"{what}: traced steps {list(traced)} are not plain record steps")
    eager_traces = plain_traces("eager") + [
        _tracer(traced, witness, "eager record steps")]

    def at_step_eager(t, trainer, state):
        for trace in eager_traces:
            trace(t)
        if t == eager_steps - 1:
            witness["eager"] = _flat_params(state)
            witness["eager_peak"] = torch.cuda.max_memory_allocated(dev)
        if t == jumps[0]:
            tab = trainer.acc.arena_for(state.params)
            bufs = state.dmd_buffers["__arena__"]
            grams = state.dmd_gram["__arena__"]
            for key, b in tab.items():
                full_g = ka.gram(bufs[key], b.tables_on(dev),
                                 anchor_first=True)
                _require_gram(f"{what} step {t} {key} carried vs K3",
                              grams[key], full_g)
            witness["gram"] = sorted(tab)

    _, _, losses_e, secs_e = _lm_fit(acfg, model, eager_steps,
                                     at_step_eager, cuda_graphs=False)
    reset_counts()
    e_ms = float(np.mean(secs_e[1:jumps[0]])) * 1e3
    e_med = float(np.median(secs_e[[t for t in replays
                                    if t < eager_steps]])) * 1e3
    print(f"{what} eager: ms a step {[float(x) for x in secs_e * 1e3]}")
    print(f"{what} eager: median ms a step by kind, before and after the "
          f"first jump (steps): "
          f"{_kind_ms(secs_e, [k.split(' ', 1)[1] for k in kinds], jumps[0])}")
    fams = {}
    for label in [f"{how} plain steps {when} the first jump"
                  for how in ("replayed", "eager") for when in plain] + [
                      "eager record steps"]:
        prof, wall = witness.pop(label)
        fams[label] = _lm_breakdown(prof, wall, LM_PROFILED, what, label)
        del prof
    for when, ts in plain.items():
        a = fams[f"replayed plain steps {when} the first jump"]
        b = fams[f"eager plain steps {when} the first jump"]
        print(f"{what}: replayed minus eager device ms a step by family "
              f"over the same plain steps {ts}: "
              f"{ {f: a.get(f, 0.0) - b.get(f, 0.0) for f in sorted(set(a) | set(b))} }")
    require(witness.get("gram") == table_keys,
            f"{what}: the carried Grams were not checked")
    require(losses[:eager_steps] == losses_e,
            f"{what}: graphed losses differ from eager in the first "
            f"{eager_steps} steps")
    a, b = witness["graphed"], witness["eager"]
    require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
            f"{what}: params after {eager_steps} steps differ between the "
            "graphed and the eager run")
    print(f"{what}: graphed = eager bit for bit over the first "
          f"{eager_steps} steps (losses and every param); ms/step graphed "
          f"{g_ms}, eager {e_ms} ({tokens / e_ms * 1e3} tokens/s); plain "
          f"step median replayed {g_med}, eager {e_med} (the same steps); "
          f"eager peak allocated {witness['eager_peak']} bytes "
          f"({witness['eager_peak'] / total} of the card)")
    del witness
    torch.cuda.empty_cache()
    return launches


def run_moe(dev, records):
    """Phase 16. Returns the launches of its counted runs."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe: {torch.cuda.memory_allocated(dev)} bytes allocated before "
          "the phase")
    records["flash_attention"]["moe_d128"] = time_flash(MOE_K7, dev)
    records["flash_attention_bwd"]["moe_d128"] = time_flash_bwd(MOE_K7B, dev)
    torch.cuda.empty_cache()
    model, params, serve_l = serve_moe(dev, "qwen3-moe serve", MOE_ARCH,
                                       MOE_WIDTHS)
    print(f"qwen3-moe serve: weights {sum(t.numel() * t.element_size() for _, t in leaves_with_paths(params))} "
          f"bytes beside the reckoned {MOE_WEIGHT_BYTES}; the hot swap is "
          "not run at 48 layers: ParamStore.stage copies the weights, and "
          "two copies do not fit one card (phase 9 swaps TinyLlama)")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    check_moe_layer(dev)
    torch.cuda.empty_cache()
    train_l = train_moe(dev, records)
    gc.collect()
    torch.cuda.empty_cache()
    model, params, pair_l = serve_moe(dev, "llama4-pair serve", PAIR_ARCH,
                                      PAIR_WIDTHS, n_layers=2)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe: phase 16 wall {time.perf_counter() - t_phase} s")
    return {"serve": serve_l, "train": train_l, "pair": pair_l}


# -- phase 17: the SSM and hybrid families -----------------------------------
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import init_kv_cache  # noqa: E402

SSM_ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
# the reference's configs: layers, d, attention heads x head_dim (0: none),
# SSM heads x head_dim, state, chunk, vocab, dtype
SSM_WIDTHS = {
    "mamba2-2.7b": (64, 2560, 0, 0, 80, 64, 128, 256, 50280, "bfloat16"),
    "zamba2-2.7b": (54, 2560, 32, 80, 80, 64, 64, 256, 32000, "bfloat16")}
# the reference's abstract init's counts (tests/test_torch_ssm.py)
SSM_PARAMS = {"mamba2-2.7b": 2_702_255_616, "zamba2-2.7b": 2_340_466_848}
# generation at full depth: equal-length prompts of SSM_PROMPT tokens,
# greedy, SSM_NEW new tokens; mamba2 also at decode_32k's batch of 128
SSM_PROMPT, SSM_NEW = 64, 16
SSM_GEN_BATCHES = {"mamba2-2.7b": (8, 128), "zamba2-2.7b": (8,)}
# decode against forward: in bf16 the two paths round differently (a GEMM
# of one row against one of 79, the recurrence against the chunked sums),
# and a random-weight stack amplifies that with depth and decode step. On
# the same weights and tokens (the reference's init carried into the port;
# examples/torch_ssm_drift.py --ref --batch 8 --new 16, on the CPU) the
# reference's decode is off its forward by up to 0.016 / 0.086 / 0.70 of
# max(1, max|logits|) at 4 / 8 / 32 layers of mamba2 and 0.11 / 0.39 at 6 /
# 12 of zamba2, the port's by 0.020 / 0.067 / 0.64 and 0.088 / 0.19; at 64
# 0.85-0.87 on an H100. So the full depth's bf16 drift is printed; the decode
# path is held to SERVE_LOGIT_TOL in fp32 at full depth, and in bf16 at
# SSM_BF16_LAYERS where the reference itself stays within it: mamba2 at 4
# layers. Zamba2's least depth with the shared block, 6, is printed: the
# reference reads 0.11 there
SSM_BF16_LAYERS = {"mamba2-2.7b": 4, "zamba2-2.7b": 6}
SSM_BF16_HELD = ("mamba2-2.7b",)
# training at full width, depth cut: the deepest that fit the card are
# mamba2's 34 layers (peak 0.85 of the card graphed and eager; 36 ran out
# of memory in examples/torch_lm_depth.py) and zamba2's 29 (4 groups of 6
# and a 5-layer remainder; peak 0.78; 30, 33 and 36 ran out of memory;
# PERF.md §4), but their steps are host-bound (~40k launches a step at
# 34 layers, 2.0-3.4 s eager on an H100) and 15 of a graphed run's 19
# steps run eagerly (each record slot is its own graph): at those depths
# phase 17 took 213-307 s, and with phase 18 the script reached 1,120 s
# of its 1,200. So mamba2 trained at 16 layers and zamba2 at 14, and
# with phase 19 the script took 1,132 s on an H100 80GB HBM3 (700 W;
# phase 17 177 s, its two trains 65 and 67 s): mamba2 trains at 8
# layers, about half its time (8 identical mamba layers: no code path of
# the 16 is dropped); zamba2 stays at 14 (two groups of 6 and a 2-layer
# remainder: the shared block's gradient sums its two invocations);
# with phase 21 the script took 1,210.7 s on a slower host (mamba2-train
# 36.6 s of it): mamba2 trains at 4 layers; with phase 21(f) 1,042.9 s
# (mamba2-train 20.8 s, zamba2-train 57.8 s): mamba2 at 2, zamba2 at 12
# (its two groups: the shared block still sums two invocations; the
# remainder's mamba segment is mamba2-train's kind);
# the DMD warm-up cut to 0 and the cool-down from 10 to SSM_COOLDOWN (the
# least that leaves 3 replayed plain steps to profile; phase 17's time on
# a slow host), m 14: records at 5-18, the jump at 18
SSM_TRAIN_LAYERS = {"mamba2-2.7b": 2, "zamba2-2.7b": 12}
SSM_COOLDOWN = 5
# the step cut to SSM_ACCUM microbatches of 1 x 4096 tokens (the config's
# grad_accum is 8): the microbatch, and so the peak, is the config's, but
# a step at 8 takes 4x the time (5.2 s replayed, 8.8 s eager on an H100):
# the two families' graphed and eager 24-step runs would take ~880 s
# against ~220 s at 2, more than phases 15 and 16 take in all (PERF.md §4)
SSM_ACCUM = 2
# one Mamba block and one zamba super-block at full width in fp32, card
# against CPU, on SSM_BLOCK_TOKENS tokens (two SSD chunks; the prefill
# takes the first chunk, the decode step the token after it): outputs and
# gradients within SSM_BLOCK_TOL of the CPU tensor's largest magnitude
# (IEEE fp32 products summed in other orders; in bf16 the rounding swamps
# the fp32 scalars' gradients, sums over every token with cancellation)
SSM_BLOCK_TOKENS = 512
SSM_BLOCK_TOL = 1e-3
# zamba2's shared attention: 32 heads of 80 (MHA) at 4096 tokens, K7 and
# K7b on the sm_80-unit designs (80 is not a wgmma head size)
SSM_K7 = (1, 4096, 4096, 32, 32, 80, True, 0)
SSM_K7B = (1, 4096, 4096, 32, 32, 80, True, 0)
# profile families of an SSM training step: the SSD's fp32 products first
# (cuBLAS's fp32 kernels without TF32), then the rest as LM_FAMILIES
SSM_FAMILIES = (("SSD fp32 GEMM", ("sgemm", "f32f32", "gemm_f32", "simt")),
                ("K2", ("::combine<",))) + LM_FAMILIES


def _ssm_widths(cfg):
    s = cfg.ssm
    return (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
            ssm_mod.ssm_dims(cfg)[1], s.head_dim, s.state_dim, s.chunk,
            cfg.vocab_size, cfg.dtype)


def _generate(model, params, prompts, new, extra=None, step_extra=None):
    """Greedy generation: prefill, then new - 1 decode steps. `extra`'s
    entries join the prompt's batch (a VLM's positions, an enc-dec
    model's frames), ``step_extra(i)``'s decode step i's (a VLM's
    positions). Returns the tokens (B, new), the logits they were chosen
    from (B, new, V), the prefill ms and the decode steps' ms (host clock,
    synchronised)."""
    B, S = prompts.shape
    caches = model.init_cache(B, S + new)
    toks, outs, dec = [], [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(
            params, {"tokens": prompts, **(extra or {})}, caches)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        for i in range(new):
            outs.append(logits[:, -1])
            toks.append(logits[:, -1].argmax(-1))
            if i == new - 1:
                break
            t0 = time.perf_counter()
            logits, caches = model.decode_step(
                params, {"tokens": toks[-1][:, None],
                         **(step_extra(i) if step_extra else {})}, caches)
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3)
    return torch.stack(toks, 1), torch.stack(outs, 1), pre_ms, dec


def _decode_vs_forward(model, params, prompts, toks, logits, extra=None):
    """The generation's logits against ``forward``'s over the prompt and
    the first new - 1 tokens, at positions S - 1 ... S + new - 2: (worst
    |diff|, max(1, max |forward's logits|)), the padded vocab left out.
    `extra`'s entries join the forward's batch (the whole sequence's
    positions, the frames)."""
    V = model.cfg.vocab_size
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": torch.cat(
            [prompts, toks[:, :-1]], 1), **(extra or {})})
    want = full[:, prompts.shape[1] - 1:, :V]
    return (float((logits[..., :V] - want).abs().max()),
            max(1.0, float(want.abs().max())))


def _decode_drift(dev, cfg, B):
    """Greedy generation of B prompts on `cfg` (seeded random weights
    drawn on the card): the decode logits' worst distance from
    ``forward``'s over max(1, max |logits|)."""
    model = tfm.LanguageModel(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    prompts = torch.randint(1, cfg.vocab_size, (B, SSM_PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(
                                B), device=dev)
    toks, logits, _, _ = _generate(model, params, prompts, SSM_NEW)
    err, scale = _decode_vs_forward(model, params, prompts, toks, logits)
    reset_counts()
    del model, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return err / scale


def generate_ssm(dev, arch, records):
    """Phase 17 (a) and (b): `arch` at full width and depth, seeded random
    weights drawn on the card; greedy generation of equal-length prompts
    at each batch, twice (bit-identical, finite); one 4096-token forward.
    The decode logits are held to ``forward``'s at the same positions in
    fp32 at full depth and in bf16 at SSM_BF16_LAYERS where SSM_BF16_HELD
    says; the bf16 distances are printed. K7
    launches: one per shared-block invocation a prefill or forward (none
    for mamba2)."""
    what = f"{arch.split('-')[0]}-generate"
    cfg = get_config(arch).model
    require(_ssm_widths(cfg) == SSM_WIDTHS[arch], f"{what}: config "
            f"{_ssm_widths(cfg)}, expected {SSM_WIDTHS[arch]}")
    total = torch.cuda.get_device_properties(dev).total_memory
    n_attn = cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every \
        else 0
    model = tfm.LanguageModel(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    torch.cuda.synchronize()
    n_p = model.param_count(params)
    require(n_p == SSM_PARAMS[arch], f"{what}: {n_p} params")
    wbytes = sum(t.numel() * t.element_size()
                 for _, t in leaves_with_paths(params))
    print(f"{what}: {arch} at {cfg.n_layers} layers, {n_p} params, {wbytes} "
          f"bytes of weights drawn on the card in "
          f"{time.perf_counter() - t0} s")
    V = cfg.vocab_size
    out = {}
    for B in SSM_GEN_BATCHES[arch]:
        g = torch.Generator(device=dev).manual_seed(B)
        prompts = torch.randint(1, V, (B, SSM_PROMPT), generator=g,
                                device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        toks, logits, pre_ms, dec = _generate(model, params, prompts,
                                              SSM_NEW)
        require_counts(f"{what} batch {B}", {"flash_attention": n_attn})
        peak = torch.cuda.max_memory_allocated(dev)
        toks2, logits2, _, dec2 = _generate(model, params, prompts, SSM_NEW)
        reset_counts()
        require(torch.equal(toks, toks2) and torch.equal(logits, logits2),
                f"{what} batch {B}: repeat generations differ")
        require(bool(torch.isfinite(logits[..., :V]).all()),
                f"{what} batch {B}: non-finite logits")
        del toks2, logits2
        err, scale = _decode_vs_forward(model, params, prompts, toks, logits)
        d_ms = float(np.median(dec + dec2))
        tok_s = B * SSM_NEW / ((pre_ms + sum(dec)) / 1e3)
        print(f"{what} batch {B} x {SSM_PROMPT} tokens, {SSM_NEW} new: "
              f"prefill {pre_ms} ms, decode step median {d_ms} ms (steps "
              f"{dec}), {tok_s} tokens/s; peak allocated {peak} bytes "
              f"({peak / total} of the card); repeat bit-identical; bf16 "
              f"decode vs forward |diff| / max(1, max|logits|) "
              f"{err / scale} (not held: see SSM_BF16_HELD); K7 launches a "
              f"generation {n_attn}")
        out[B] = dict(prefill_ms=pre_ms, decode_ms=d_ms, tokens_per_s=tok_s,
                      peak=peak, bf16_drift=err / scale)
        del logits
        torch.cuda.empty_cache()
    toks = torch.randint(1, V, (1, 4096), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    for rep in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, _ = model.loss(params, {"tokens": toks})
        torch.cuda.synchronize()
        f_ms = (time.perf_counter() - t0) * 1e3
        require_counts(f"{what} forward 4096", {"flash_attention": n_attn})
        require(bool(torch.isfinite(loss)), f"{what} forward 4096: {loss}")
    reset_counts()
    print(f"{what} forward 4096: loss {float(loss)} in {f_ms} ms (second "
          f"run; {16 * cfg.n_layers} SSD chunks, {n_attn} K7 launches)")
    out["forward_4096_ms"] = f_ms
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # the decode path against forward's: in fp32 at full depth (the
    # recurrence against the chunked SSD without bf16 rounding), held; in
    # bf16 cut to SSM_BF16_LAYERS, held where SSM_BF16_HELD says
    B = SSM_GEN_BATCHES[arch][0]
    for dtype, n in (("float32", cfg.n_layers),
                     ("bfloat16", SSM_BF16_LAYERS[arch])):
        d = _decode_drift(dev, dataclasses.replace(cfg, dtype=dtype,
                                                   n_layers=n), B)
        held = dtype == "float32" or arch in SSM_BF16_HELD
        limit = f"limit {SERVE_LOGIT_TOL}" if held else \
            "not held: see SSM_BF16_HELD"
        print(f"{what} {dtype} at {n} layers batch {B}: decode vs forward "
              f"worst |diff| / max(1, max|logits|) {d} over {SSM_NEW} "
              f"positions ({limit})")
        require(not held or d <= SERVE_LOGIT_TOL, f"{what} {dtype} at {n} "
                f"layers: decode logits off forward's by {d}")
        out[f"{dtype}_{n}_drift"] = d
    records.setdefault("ssm", {})[what] = out
    return n_attn


def _ssm_block_params(cfg, kind, dev):
    """One super-block's params (a zamba block: its 6 Mamba layers as a
    list, and the shared block), drawn on `dev`; A_log, dt_bias, skip_d
    and norm_scale drawn too (their init is zeros)."""
    g = torch.Generator(device=dev).manual_seed(18)

    def mamba():
        p = {"ln": {"scale": 0.1 * torch.randn(
                (cfg.d_model,), generator=g, device=dev)},
             "ssm": ssm_mod.ssm_init(g, cfg, dev)}
        for k in ("A_log", "dt_bias", "skip_d", "norm_scale"):
            p["ssm"][k] = 0.5 * torch.randn(p["ssm"][k].shape, generator=g,
                                            device=dev)
        return p
    if kind == "mamba":
        return mamba(), None
    return ({"mamba": [mamba() for _ in range(cfg.shared_attn_every)]},
            tfm._block_init(g, cfg, "dense", (), dev))


def _ssm_block_run(kind, p, shared, x, dout, cfg, n_pre):
    """One super-block forward and backward, then prefill of the first
    `n_pre` tokens into a fresh state and the next token's O(1) decode
    step: (out, {name: gradient}, prefill out, decode out)."""
    dev = x.device
    tree = {"p": p, "shared": shared}
    req = {path: t.detach().clone().requires_grad_(True)
           for path, t in leaves_with_paths(tree)}
    live = map_with_paths(lambda path, _: req[path], tree)
    xr = x.detach().clone().requires_grad_(True)
    B, S, _ = x.shape
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    with torch.enable_grad():
        out, _, _ = tfm._apply_block(kind, xr, live["p"], cfg, positions=pos,
                                     cache=None, chunk_k=1024,
                                     shared=live["shared"])
        (out.float() * dout).sum().backward()
    grads = {"x": xr.grad, **{path: t.grad for path, t in req.items()}}
    state = ssm_mod.init_ssm_state(B, cfg, x.dtype, dev,
                                   () if kind == "mamba"
                                   else (cfg.shared_attn_every,))
    cache = state if kind == "mamba" else {
        "mamba": state, "shared": init_kv_cache(
            B, S, cfg.n_kv_heads, cfg.head_dim, x.dtype, dev)}
    with torch.no_grad():
        pre, cache, _ = tfm._apply_block(kind, x[:, :n_pre], p, cfg,
                                         positions=pos[:, :n_pre],
                                         cache=cache, chunk_k=1024,
                                         shared=shared)
        dec, _, _ = tfm._apply_block(kind, x[:, n_pre:n_pre + 1], p, cfg,
                                     positions=pos[:, n_pre:n_pre + 1],
                                     cache=cache, chunk_k=1024,
                                     shared=shared)
    return out.detach(), grads, pre, dec


def _held_card_vs_cpu(what, card, again, cpu, n_pre):
    """A block's (out, gradients, prefill, decode) on the card twice, bit
    for bit, and against the CPU within SSM_BLOCK_TOL of the CPU tensor's
    largest magnitude (and the decode step against the forward's row).
    Returns {name: distance}."""
    for i, name in ((0, "out"), (2, "prefill"), (3, "decode")):
        require(torch.equal(card[i], again[i]), f"{what}: repeat runs "
                f"differ in {name}")
    for name in card[1]:
        require(torch.equal(card[1][name], again[1][name]),
                f"{what}: repeat runs differ in d{name}")
    pairs = [("out", card[0], cpu[0]), ("prefill", card[2], cpu[2]),
             ("decode", card[3], cpu[3]),
             ("decode vs forward", card[3], card[0][:, n_pre:n_pre + 1])]
    pairs += [(f"d{n}", card[1][n], cpu[1][n]) for n in cpu[1]]
    errs = {}
    for name, a, b in pairs:
        a, b = a.detach().cpu().float(), b.detach().cpu().float()
        require(bool(torch.isfinite(a).all()), f"{what}: {name} not finite")
        errs[name] = float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
        require(errs[name] <= SSM_BLOCK_TOL, f"{what}: {name} off by "
                f"{errs[name]} of its largest magnitude > {SSM_BLOCK_TOL}")
    return errs


def check_ssm_blocks(dev):
    """Phase 17 (c): one Mamba-2 block (mamba2's widths) and one zamba
    super-block (6 Mamba-2 blocks and the shared attention + MLP, zamba2's
    widths) in fp32 on SSM_BLOCK_TOKENS tokens: forward and backward,
    prefill and the S=1 decode, on the card twice (bit for bit the same)
    and on the CPU from the same params and inputs, within
    SSM_BLOCK_TOL."""
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_config(arch).model, dtype="float32")
        kind = "mamba" if cfg.family == "ssm" else "zamba"
        S, n_pre = SSM_BLOCK_TOKENS, cfg.ssm.chunk
        p, shared = _ssm_block_params(cfg, kind, dev)
        g = torch.Generator(device=dev).manual_seed(19)
        x = torch.randn((1, S, cfg.d_model), generator=g, device=dev)
        dout = torch.randn(x.shape, generator=g, device=dev)
        t0 = time.perf_counter()
        card = _ssm_block_run(kind, p, shared, x, dout, cfg, n_pre)
        again = _ssm_block_run(kind, p, shared, x, dout, cfg, n_pre)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        host = lambda t: None if t is None else t.detach().to("cpu")  # noqa
        t0 = time.perf_counter()
        cpu = _ssm_block_run(
            kind, tree_map(host, p), None if shared is None else
            tree_map(host, shared), host(x), host(dout), cfg, n_pre)
        cpu_s = time.perf_counter() - t0
        errs = _held_card_vs_cpu(f"{arch} block", card, again, cpu, n_pre)
        del again
        worst = max(errs.items(), key=lambda kv: kv[1])
        print(f"{arch} block ({kind}, {S} tokens, fp32): forward, backward, "
              f"prefill of {n_pre} and one decode step; card twice "
              f"bit-identical; against the CPU worst {worst[0]} "
              f"{worst[1]} of the largest magnitude (limit {SSM_BLOCK_TOL}; "
              f"out {errs['out']}, prefill {errs['prefill']}, decode "
              f"{errs['decode']}, decode vs forward "
              f"{errs['decode vs forward']}, dx {errs['dx']}); card "
              f"{card_s} s for two runs, CPU {cpu_s} s")
        del card, cpu
        torch.cuda.empty_cache()


def train_ssm(dev, arch, records):
    """Phase 17 (d) and (e): `arch` at full width, cut to
    SSM_TRAIN_LAYERS, through ``train_cell``. Returns the graphed run's
    launches."""
    n_layers = SSM_TRAIN_LAYERS[arch]
    mc = get_config(arch).model
    n_attn = n_layers // mc.shared_attn_every if mc.shared_attn_every else 0
    return train_cell(
        dev, arch, n_layers, SSM_COOLDOWN, SSM_ACCUM,
        (14, 55, "bfloat16", "all", True, True, "matpow", "leaf", 10,
         "adamw", 3e-4, 0.95, 0.1, 1.0, "cosine", 8, "block", 2560,
         n_layers), n_attn, SSM_FAMILIES, records, "ssm")


def train_cell(dev, arch, n_layers, cooldown, accum, expect, n_attn,
               families, records, group, wgmma=False, rows=1, grid=None):
    """`arch` at full width, cut to `n_layers`, through the launcher's
    ``run`` graphed and then eagerly, bit for bit the same: the config
    (DMD, optimizer, grad_accum, remat, d_model, depth) held to `expect`,
    then the DMD warm-up cut to 0, the cool-down to `cooldown` (one
    window of records, the jump at its last step) and the step to
    `accum` microbatches of `rows` x LM_SEQ tokens (with the stream's
    frames, and its M-RoPE positions or, with `grid`, those of an image
    block of grid patches: ``_lm_fit``); K7 twice (once without remat) and K7b
    once per attention (`n_attn`) and microbatch, all through their
    Hopper designs where `wgmma`; K1 and K2 on the run's own rings
    (check_ring_buckets); the time by step kind; a profile of 3 eager
    plain steps by `families`. Recorded under records[`group`]. Returns
    the graphed run's launches."""
    what = f"{arch.rsplit('-', 1)[0]}-train"
    total = torch.cuda.get_device_properties(dev).total_memory
    m = get_config(arch).dmd.m
    steps = cooldown + m
    reckon = {}
    for n in (0, n_layers):
        acfg = launch_train.configure(arch, steps=steps,
                                      global_batch=LM_BATCH, seq=LM_SEQ,
                                      n_layers=n)
        n_p = launch_train.param_count(launch_train.make_model(acfg,
                                                               device=dev))
        reckon[acfg.model.n_layers] = (n_p, sum(launch_train.state_bytes(
            acfg, n_p).values()))
    full = get_config(arch).model.n_layers
    print(f"{what}: training state by depth (layers: params, bytes, share "
          f"of the card's {total}): "
          f"{ {n: (p, b, b / total) for n, (p, b) in reckon.items()} }")
    require(n_layers == full or
            reckon[full][1] > launch_train.CARD_FRACTION * total,
            f"{what}: {full} layers fit: the cut is not needed")
    mc, dmd, opt = acfg.model, acfg.dmd, acfg.optimizer
    require((dmd.m, dmd.s, dmd.snapshot_dtype, dmd.param_filter, dmd.arena,
             dmd.streaming_gram, dmd.mode, dmd.scope, dmd.cooldown_steps,
             opt.name, opt.lr, opt.b2, opt.weight_decay, opt.grad_clip,
             opt.schedule, acfg.parallel.grad_accum, acfg.parallel.remat,
             mc.d_model, mc.n_layers) == expect, f"{what}: config {acfg}")
    acfg = dataclasses.replace(
        acfg, dmd=dataclasses.replace(dmd, warmup_steps=0,
                                      cooldown_steps=cooldown),
        parallel=dataclasses.replace(acfg.parallel, grad_accum=accum),
        train=dataclasses.replace(acfg.train, global_batch=accum * rows))
    model = launch_train.make_model(acfg, device=dev)
    need = launch_train.check_fits(acfg, reckon[n_layers][0], total)
    ga = acfg.parallel.grad_accum
    fwd = 1 if acfg.parallel.remat == "none" else 2
    want = {"flash_attention": fwd * n_attn * ga * steps,
            "flash_attention_bwd": n_attn * ga * steps}
    acc = launch_train.make_trainer(acfg, model).acc
    jumps = [t for t in range(steps) if acc.apply_groups(t)]
    require(jumps == [steps - 1], f"{what}: jumps at {jumps}")
    kinds = _step_kinds(acc, steps)
    traced = [t for t in range(steps) if kinds[t] == "replay plain"][
        -LM_PROFILED:]
    witness = {}

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before_fit = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    trainer, state, losses, secs = _lm_fit(
        acfg, model, steps, lambda t, tr, st: None, grid=grid)
    g_wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    table = trainer.acc.arena_for(state.params)
    want["gram_row"] = sum(acc.slots(t)[b.group] >= 0
                           for t in range(steps) for b in table.values())
    want["combine"] = sum(b.group in acc.apply_groups(t)
                          for t in jumps for b in table.values())
    require_counts(f"{what} graphed", want)
    if wgmma:
        require_wgmma(f"{what} graphed")
        require_wgmma(f"{what} graphed", "flash_attention_bwd", "K7b")
    reset_counts()
    require(np.isfinite(losses).all(), f"{what}: non-finite loss")
    graphed = _flat_params(state)
    tokens = accum * rows * LM_SEQ
    print(f"{what} graphed: launches {launches}; jumps at {jumps}; graphs "
          f"{trainer.graph_stats}; buckets "
          f"{[(k, b.n_blocks, b.m, b.block_n, b.n_sys) for k, b in table.items()]}")
    print(f"{what} losses {losses}")
    print(f"{what} graphed: ms a step {[float(x) for x in secs * 1e3]}; "
          f"median by kind (steps): {_kind_ms(secs, kinds, jumps[0])}; "
          f"{tokens / float(np.median(secs[traced])) * 1e-3} k tokens/s on "
          f"a replayed plain step; peak allocated {peak} bytes "
          f"({peak / total} of the card) beside the reckoned state {need} "
          f"bytes ({need / total})")
    bufs = state.dmd_buffers["__arena__"]
    torch.cuda.empty_cache()
    check_ring_buckets(dev, what, table, bufs, acfg.dmd.anchor == "first",
                       records, f"{what.split('-')[0]}_buckets")
    del trainer, state, table, bufs
    after_fit = torch.cuda.memory_allocated(dev)
    require(after_fit - before_fit <= LM_LEFT_BYTES,
            f"{what}: {after_fit - before_fit} bytes outlive the graphed run "
            f"> {LM_LEFT_BYTES}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    trace_e = _tracer(traced, witness, "eager plain steps")
    t0 = time.perf_counter()
    _, state_e, losses_e, secs_e = _lm_fit(
        acfg, model, steps, lambda t, tr, st: trace_e(t),
        cuda_graphs=False, grid=grid)
    e_wall = time.perf_counter() - t0
    reset_counts()
    e_peak = torch.cuda.max_memory_allocated(dev)
    eager = _flat_params(state_e)
    del state_e
    t0 = time.perf_counter()
    prof, wall = witness.pop("eager plain steps")
    fams = _lm_breakdown(prof, wall, LM_PROFILED, what, "eager plain steps",
                         families)
    del prof
    print(f"{what}: walls: graphed run {g_wall} s, eager run {e_wall} s, "
          f"reading the profile {time.perf_counter() - t0} s")
    require(losses == losses_e, f"{what}: graphed losses differ from eager")
    require(graphed.keys() == eager.keys() and
            all(torch.equal(graphed[k], eager[k]) for k in graphed),
            f"{what}: params after {steps} steps differ between the "
            "graphed and the eager run")
    print(f"{what} eager: ms a step {[float(x) for x in secs_e * 1e3]}; "
          f"median by kind (steps): "
          f"{_kind_ms(secs_e, [k.split(' ', 1)[1] for k in kinds], jumps[0])}")
    print(f"{what}: graphed = eager bit for bit over {steps} steps "
          f"(losses and every param, through the jump at {jumps[0]}); plain "
          f"step median replayed {float(np.median(secs[traced])) * 1e3} ms, "
          f"eager {float(np.median(secs_e[traced])) * 1e3} ms; eager peak "
          f"{e_peak} bytes ({e_peak / total} of the card)")
    records.setdefault(group, {})[what] = dict(
        layers=n_layers, rows=rows, grid=grid, params=reckon[n_layers][0],
        state_bytes=need,
        peak=peak, eager_peak=e_peak,
        replay_plain_ms=float(np.median(secs[traced])) * 1e3,
        eager_plain_ms=float(np.median(secs_e[traced])) * 1e3,
        jump_ms=float(secs_e[jumps[0]]) * 1e3, families=fams)
    del graphed, eager, witness
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_ssm(dev, records):
    """Phase 17. Returns the launches of its counted runs."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    records["flash_attention"]["ssm_d80"] = time_flash(SSM_K7, dev)
    records["flash_attention_bwd"]["ssm_d80"] = time_flash_bwd(SSM_K7B, dev)
    torch.cuda.empty_cache()
    walls = {"K7/K7b d 80": time.perf_counter() - t_phase}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out
    gen = {arch: timed(f"{arch} generate", generate_ssm, dev, arch, records)
           for arch in SSM_ARCHS}
    timed("blocks", check_ssm_blocks, dev)
    train = {arch: timed(f"{arch} train", train_ssm, dev, arch, records)
             for arch in SSM_ARCHS}
    # (f) K1 on the LM rings: the repaired order of sums (csrc/arena.cu)
    for field in ("moe_buckets", "mamba2_buckets", "zamba2_buckets"):
        for r in records["gram_row"].get(field, ()):
            if r["shape"][0] > K1_RING_BLOCKS:
                print(f"K1 repair (f) {field} {r['bucket']} {r['shape']}: "
                      f"max_abs_err {r['max_abs_err']} from the float64 "
                      f"twin, the chunked fp32 twin's {r['twin_err']} "
                      f"({r['max_abs_err'] / max(r['twin_err'], 1e-300)}x, "
                      f"limit {K1_TWIN_FACTOR}x); {r['ms']} ms eager, "
                      f"{r['graph_ms']} replayed, bound {r['bound_ms']}")
    print(f"ssm: phase 17 wall {time.perf_counter() - t_phase} s; by part "
          f"{walls}")
    return {"generate": gen, "train": train}


# -- phase 18: the remaining dense decoders ----------------------------------

DENSE_ARCHS = ("minicpm-2b", "granite-20b", "gemma3-27b")
# the reference's configs: layers, d, heads, kv heads, head_dim, d_ff,
# vocab, MLP activation, window, global_every, dtype
DENSE_WIDTHS = {
    "minicpm-2b": (40, 2304, 36, 36, 64, 5760, 122753, "silu", 0, 0,
                   "bfloat16"),
    "granite-20b": (52, 6144, 48, 1, 128, 24576, 49152, "gelu_mlp", 0, 0,
                    "bfloat16"),
    "gemma3-27b": (62, 5376, 32, 16, 128, 21504, 262144, "gelu", 1024, 6,
                   "bfloat16")}
# the reference's abstract init's counts (tests/test_torch_dense_archs.py)
DENSE_PARAMS = {"minicpm-2b": 2_724_915_456, "granite-20b": 20_315_756_544,
                "gemma3-27b": 27_008_319_744}
# K7 and K7b on the two attention shapes no earlier phase meets: granite's
# MQA (48 query heads on one KV head) and gemma's local layer (window
# 1024, rep 2), one 4096-token microbatch each, bf16 causal
GRANITE_K7 = (1, 4096, 4096, 48, 1, 128, True, 0)
GEMMA_K7 = (1, 4096, 4096, 32, 16, 128, True, 1024)
GRANITE_K7B = (1, 4096, 4096, 48, 1, 128, True, 0)
GEMMA_K7B = (1, 4096, 4096, 32, 16, 128, True, 1024)
# gemma's generation: the long prompt's tokens (past the window: every
# ring wraps, and wraps again while decoding); fp32 decode against forward
# at two super-blocks and the 2-layer local tail (7.2B params, 29 GB)
GEMMA_LONG = 1100
GEMMA_FP32_LAYERS = 14
# one gemma super-block at full width in fp32, card against CPU: the
# window cut to GEMMA_BLOCK_WINDOW so that GEMMA_BLOCK_TOKENS tokens wrap
# the rings (the CPU's fp32 products at full width take ~10 s a pass);
# prefill of GEMMA_BLOCK_PRE tokens, then one decode step
GEMMA_BLOCK_WINDOW = 128
GEMMA_BLOCK_TOKENS = 256
GEMMA_BLOCK_PRE = 192
# training at full width, depth cut to fit the card (check_fits admits 23,
# 4 and 2 layers of an H100's 80 GB: 44 B a param for minicpm's bf16 ring
# of 14, 32 B for the others' rings of 8; gemma's tied 262144 x 5376
# embedding alone is 45 GB of state). In examples/torch_lm_depth.py on an
# H100 80GB HBM3 (700 W) minicpm ran at 21 layers (peak 0.888 of the card,
# 0.989 of it reserved) and 20 (0.854), 22 and 23 ran out of memory;
# granite ran at 3 (0.742), 4 ran out of memory in this phase's jump;
# gemma ran at 1 (0.777), 2 ran out of memory. minicpm trained at 20, one
# layer under the deepest, until phase 19 brought the script to 1,132 s
# (minicpm-train 41 s of it); it trains at 10, about half the time, and
# at 4 since phase 21 brought the script to 1,210.7 s on a slower host;
# minicpm and granite at 2 since phase 21(f) brought it to 1,042.9 s
# (minicpm-train 12.7 s, granite-train 22.8 s of it; one kind of layer);
# gemma's one layer is a window layer: gemma3-train trains no
# global layer (tests/test_torch_dense_archs.py trains one on the CPU
# against the reference); warm-up
# 0, the cool-down from 10 to DENSE_COOLDOWN (the least that leaves 3
# replayed plain steps to profile; then one window of records, the jump
# at its last step); DENSE_ACCUM microbatches of 1 x 4096 a step
# (the configs' grad_accum is 8 and 16: phase 17's cut, for the script's
# time)
DENSE_TRAIN_LAYERS = {"minicpm-2b": 2, "granite-20b": 2, "gemma3-27b": 1}
DENSE_COOLDOWN = 5
DENSE_ACCUM = 2


def _dense_widths(cfg):
    return (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.act,
            cfg.sliding_window, cfg.global_every, cfg.dtype)


def serve_dense(dev, arch, records, swap):
    """Phase 18 (a) and (b): `arch` at full width and depth through the
    launcher's ``build`` (the engine serves the drawn tensors: one copy),
    the launcher's stream counted (K7 once per layer per prefill dispatch,
    all through the wgmma design), the time by step kind, every request's
    first-token logits and first token against the exact-length loop, a hot
    swap every 8 steps where `swap`, a 4096-token forward."""
    what = f"{arch.split('-')[0]}-serve"
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, params, engine = launch_serve.build(arch, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.cfg
    require(_dense_widths(cfg) == DENSE_WIDTHS[arch], f"{what}: config "
            f"{_dense_widths(cfg)}, expected {DENSE_WIDTHS[arch]}")
    n_p = model.param_count(params)
    require(n_p == DENSE_PARAMS[arch], f"{what}: {n_p} params")
    leaves = leaves_with_paths(params)
    served = dict(leaves_with_paths(engine.params))
    require(all(served[p].data_ptr() == t.data_ptr() for p, t in leaves),
            f"{what}: the engine holds a copy of the weights")
    wbytes = sum(t.numel() * t.element_size() for _, t in leaves)
    print(f"{what}: {arch} at {cfg.n_layers} layers, {n_p} params, {wbytes} "
          f"bytes of weights drawn on the card in {build_s} s (one copy: the "
          f"engine serves the drawn tensors); peak "
          f"{torch.cuda.max_memory_allocated(dev) / total} of the card")
    prompts = launch_serve.request_stream(12, cfg.vocab_size)
    done, launches = _serve_counted(f"{what} path", engine, prompts)
    del engine
    dec_ms = serve_breakdown(what, model, params, prompts, dev)
    eng = launch_serve.make_engine(model, params, new_tokens=1)
    firsts = {r.uid: r.last_logits for r in
              launch_serve.serve(eng, prompts)[0]}
    del eng
    equal, worst = 0, 0.0
    for r in done:
        # the exact-length loop's prefill and first token (its 16 tokens
        # a request would add ~25 s of host-bound decode steps a cell)
        toks, first = launch_serve.exact_greedy(model, params,
                                                prompts[r.uid], 1)
        first = first.cpu().numpy()
        err = float(np.abs(firsts[r.uid] - first).max())
        scale = max(1.0, float(np.abs(first).max()))
        require(err <= SERVE_LOGIT_TOL * scale, f"{what} request {r.uid}: "
                f"first-token logits off by {err} (scale {scale})")
        worst = max(worst, err / scale)
        equal += r.tokens[0] == toks[0]
    print(f"{what}: first-token logits vs the exact-length loop: worst "
          f"|diff| / max(1, max|logits|) {worst} (limit {SERVE_LOGIT_TOL}); "
          f"equal first tokens {equal} of {len(done)}; decode-only step "
          f"median {dec_ms} ms")
    if swap:
        eng = launch_serve.make_engine(model, params)
        bumped = tree_map(lambda t: t * 1.001, params)
        done2, _ = _serve_counted(f"{what} path, swap every 8", eng,
                                  prompts, 8, bumped)
        require(eng.stats["swaps"] >= 1 and any(
            r.version_end > r.version_start for r in done2),
            f"{what}: no swap adopted")
        del bumped, eng
    forward_4096(f"{what} forward 4096", model, params, dev)
    records.setdefault("dense", {})[what] = dict(
        params=n_p, weight_bytes=wbytes, decode_ms=dec_ms,
        first_token_worst=worst, equal_tokens=equal)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _ring_positions_ok(caches, length, window):
    """Every ring of `caches` (the gemma segments' local stacks and the
    dense_local tail) holds the last `window` positions before `length`,
    each at its slot position % window."""
    rings = []
    for c in caches.values():
        rings.append(c["local"] if isinstance(c, dict) else c)
    want = torch.arange(length - window, length, device=rings[0].pos.device)
    for ring in rings:
        pos = ring.pos.reshape(-1, window).long()
        if ring.length != length or not bool(
                (pos.sort(dim=1).values == want).all()) or not bool(
                (pos % window == torch.arange(window, device=pos.device)).all()):
            return False
    return True


def generate_gemma(dev, records):
    """Phase 18 (c): Gemma3-27B at full width and depth (seeded random
    weights drawn on the card) generating through ``prefill`` /
    ``decode_step``: 8 prompts of 64 tokens and one of GEMMA_LONG, 16 new
    each, twice bit for bit; the rings' slots after the long one; a
    4096-token forward; then fp32 decode against forward at
    GEMMA_FP32_LAYERS layers, held; then one super-block card against
    CPU. K7: 62 launches a prefill and a forward, all through the wgmma
    design."""
    what = "gemma3-generate"
    arch = "gemma3-27b"
    cfg = get_config(arch).model
    require(_dense_widths(cfg) == DENSE_WIDTHS[arch], f"{what}: config "
            f"{_dense_widths(cfg)}, expected {DENSE_WIDTHS[arch]}")
    total = torch.cuda.get_device_properties(dev).total_memory
    model = tfm.LanguageModel(cfg, device=dev)
    require([tuple(sg) for sg in model.plan] ==
            [("gemma", 10), ("dense_local", 2)], f"{what}: {model.plan}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    torch.cuda.synchronize()
    n_p = model.param_count(params)
    require(n_p == DENSE_PARAMS[arch], f"{what}: {n_p} params")
    wbytes = sum(t.numel() * t.element_size()
                 for _, t in leaves_with_paths(params))
    print(f"{what}: {arch} at {cfg.n_layers} layers, {n_p} params, {wbytes} "
          f"bytes of weights drawn on the card in "
          f"{time.perf_counter() - t0} s")
    V, W = cfg.vocab_size, cfg.sliding_window
    out = {}
    for B, S in ((8, SSM_PROMPT), (1, GEMMA_LONG)):
        prompts = torch.randint(1, V, (B, S), generator=torch.Generator(
            device=dev).manual_seed(B), device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        toks, logits, pre_ms, dec = _generate(model, params, prompts,
                                              SSM_NEW)
        require_counts(f"{what} {B} x {S}", {"flash_attention": cfg.n_layers})
        require_wgmma(f"{what} {B} x {S}")
        peak = torch.cuda.max_memory_allocated(dev)
        toks2, logits2, _, dec2 = _generate(model, params, prompts, SSM_NEW)
        reset_counts()
        require(torch.equal(toks, toks2) and torch.equal(logits, logits2),
                f"{what} {B} x {S}: repeat generations differ")
        require(bool(torch.isfinite(logits[..., :V]).all()),
                f"{what} {B} x {S}: non-finite logits")
        del toks2, logits2
        err, scale = _decode_vs_forward(model, params, prompts, toks, logits)
        d_ms = float(np.median(dec + dec2))
        tok_s = B * SSM_NEW / ((pre_ms + sum(dec)) / 1e3)
        print(f"{what} batch {B} x {S} tokens, {SSM_NEW} new: prefill "
              f"{pre_ms} ms, decode step median {d_ms} ms (steps {dec}), "
              f"{tok_s} tokens/s; peak allocated {peak} bytes ({peak / total}"
              f" of the card); repeat bit-identical; bf16 decode vs forward "
              f"|diff| / max(1, max|logits|) {err / scale} (printed; held in "
              f"fp32 below)")
        out[f"{B}x{S}"] = dict(prefill_ms=pre_ms, decode_ms=d_ms,
                               tokens_per_s=tok_s, peak=peak,
                               bf16_drift=err / scale)
        del logits
    # the rings after a prompt past the window and 15 decode steps
    caches = model.init_cache(1, GEMMA_LONG + SSM_NEW)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": prompts}, caches)
        require(_ring_positions_ok(caches, GEMMA_LONG, W), f"{what}: the "
                f"rings after a {GEMMA_LONG}-token prefill")
        for t in range(3):
            _, caches = model.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                          caches)
    require(_ring_positions_ok(caches, GEMMA_LONG + 3, W), f"{what}: the "
            "rings after decoding")
    reset_counts()
    del caches
    print(f"{what}: every ring holds the last {W} positions at slot = "
          f"position % {W}, after the {GEMMA_LONG}-token prefill and after 3 "
          "decode steps")
    forward_4096(f"{what} forward 4096", model, params, dev)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # fp32 decode against forward through wrapped rings, held
    fcfg = dataclasses.replace(cfg, dtype="float32",
                               n_layers=GEMMA_FP32_LAYERS)
    model = tfm.LanguageModel(fcfg, device=dev)
    require([tuple(sg) for sg in model.plan] ==
            [("gemma", 2), ("dense_local", 2)], f"{what} fp32: {model.plan}")
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    for B, S in ((8, SSM_PROMPT), (1, GEMMA_LONG)):
        prompts = torch.randint(1, V, (B, S), generator=torch.Generator(
            device=dev).manual_seed(B), device=dev)
        toks, logits, _, _ = _generate(model, params, prompts, SSM_NEW)
        err, scale = _decode_vs_forward(model, params, prompts, toks, logits)
        reset_counts()
        print(f"{what} float32 at {GEMMA_FP32_LAYERS} layers batch {B} x {S}:"
              f" decode vs forward worst |diff| / max(1, max|logits|) "
              f"{err / scale} over {SSM_NEW} positions (limit "
              f"{SERVE_LOGIT_TOL})")
        require(err / scale <= SERVE_LOGIT_TOL, f"{what} float32 {B} x {S}: "
                f"decode logits off forward's by {err / scale}")
        out[f"float32_{B}x{S}_drift"] = err / scale
        del logits
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    out["block"] = check_gemma_block(dev, cfg)
    records.setdefault("dense", {})[what] = out


def _gemma_block_run(p, x, dout, cfg, n_pre):
    """One gemma super-block forward and backward, then a prefill of the
    first `n_pre` tokens into fresh caches (rings of the window, a full
    cache for the global layer) and the next token's decode step: (out,
    {name: gradient}, prefill out, decode out)."""
    dev = x.device
    req = {path: t.detach().clone().requires_grad_(True)
           for path, t in leaves_with_paths(p)}
    live = map_with_paths(lambda path, _: req[path], p)
    xr = x.detach().clone().requires_grad_(True)
    B, S, _ = x.shape
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    with torch.enable_grad():
        out, _, _ = tfm._apply_block("gemma", xr, live, cfg, positions=pos,
                                     cache=None, chunk_k=1024)
        (out.float() * dout).sum().backward()
    grads = {"x": xr.grad, **{path: t.grad for path, t in req.items()}}
    lm = tfm.LanguageModel(dataclasses.replace(cfg, n_layers=6), device=dev)
    fresh = {k: tfm._layer_cache(v, 0)
             for k, v in lm.init_cache(B, S)["seg0"].items()}
    with torch.no_grad():
        pre, _, _ = tfm._apply_block("gemma", x[:, :n_pre], p, cfg,
                                     positions=pos[:, :n_pre], cache=fresh,
                                     chunk_k=1024)
        # the caches were written in place; their lengths move on as
        # LanguageModel._layers moves them
        cache = tfm._advance(fresh, n_pre)
        dec, _, _ = tfm._apply_block("gemma", x[:, n_pre:n_pre + 1], p, cfg,
                                     positions=pos[:, n_pre:n_pre + 1],
                                     cache=cache, chunk_k=1024)
    return out.detach(), grads, pre, dec


def check_gemma_block(dev, cfg):
    """Phase 18 (c), last: one gemma super-block (5 window layers and the
    global one) at full width in fp32, the window cut to
    GEMMA_BLOCK_WINDOW, on GEMMA_BLOCK_TOKENS tokens: forward, backward,
    prefill and one decode step, on the card twice (bit for bit) and on
    the CPU from the same params and inputs, within SSM_BLOCK_TOL of the
    CPU tensor's largest magnitude. Returns the worst distance."""
    cfg = dataclasses.replace(cfg, dtype="float32",
                              sliding_window=GEMMA_BLOCK_WINDOW)
    g = torch.Generator(device=dev).manual_seed(18)
    blk = tfm._block_init(g, cfg, "gemma", (), dev)
    p = {"local": tfm._unbind(blk["local"], cfg.global_every - 1),
         "global": blk["global"]}
    for lp in p["local"] + [p["global"]]:
        for k in ("ln1", "ln2"):
            lp[k]["scale"] = 0.1 * torch.randn(lp[k]["scale"].shape,
                                               generator=g, device=dev)
    x = torch.randn((1, GEMMA_BLOCK_TOKENS, cfg.d_model), generator=g,
                    device=dev)
    dout = torch.randn(x.shape, generator=g, device=dev)
    n_pre = GEMMA_BLOCK_PRE
    t0 = time.perf_counter()
    card = _gemma_block_run(p, x, dout, cfg, n_pre)
    again = _gemma_block_run(p, x, dout, cfg, n_pre)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host = lambda t: t.detach().to("cpu")  # noqa: E731
    t0 = time.perf_counter()
    cpu = _gemma_block_run(tree_map(host, p), host(x), host(dout), cfg,
                           n_pre)
    cpu_s = time.perf_counter() - t0
    errs = _held_card_vs_cpu("gemma block", card, again, cpu, n_pre)
    del again
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"gemma3 block (5 window layers + 1 global, window "
          f"{GEMMA_BLOCK_WINDOW}, {GEMMA_BLOCK_TOKENS} tokens, fp32): "
          f"forward, backward, prefill of {n_pre} (the rings wrap) and one "
          f"decode step; card twice bit-identical; against the CPU worst "
          f"{worst[0]} {worst[1]} of the largest magnitude (limit "
          f"{SSM_BLOCK_TOL}; out {errs['out']}, prefill {errs['prefill']}, "
          f"decode {errs['decode']}, decode vs forward "
          f"{errs['decode vs forward']}, dx {errs['dx']}); card {card_s} s "
          f"for two runs, CPU {cpu_s} s")
    del card, cpu
    torch.cuda.empty_cache()
    return worst[1]


def train_dense(dev, arch, records):
    """Phase 18 (d): `arch` at full width cut to DENSE_TRAIN_LAYERS
    through ``train_cell``, K7 and K7b through their Hopper designs.
    Returns the graphed run's launches."""
    n_layers = DENSE_TRAIN_LAYERS[arch]
    acfg = get_config(arch)
    dmd, opt = acfg.dmd, acfg.optimizer
    expect = (dmd.m, 55 if dmd.m == 14 else 40, "bfloat16", "all", True,
              True, "matpow", "leaf", 10, "adamw", opt.lr, 0.95, 0.1, 1.0,
              "wsd" if arch.startswith("minicpm") else "cosine",
              8 if arch.startswith("minicpm") else 16, "block",
              acfg.model.d_model, n_layers)
    return train_cell(dev, arch, n_layers, DENSE_COOLDOWN, DENSE_ACCUM,
                      expect, n_layers, LM_FAMILIES, records, "dense",
                      wgmma=True)


def run_dense(dev, records):
    """Phase 18. Returns the launches of its counted runs."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    for tag, k7, k7b in (("granite_mqa", GRANITE_K7, GRANITE_K7B),
                         ("gemma_window", GEMMA_K7, GEMMA_K7B)):
        records["flash_attention"][tag] = time_flash(k7, dev)
        w0 = kf.LAUNCHES["flash_attention_bwd_wgmma"]
        records["flash_attention_bwd"][tag] = time_flash_bwd(k7b, dev)
        require(kf.LAUNCHES["flash_attention_bwd_wgmma"] > w0,
                f"K7b {k7b}: not through the Hopper design")
        torch.cuda.empty_cache()
    reset_counts()
    walls = {"K7/K7b": time.perf_counter() - t_phase}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out
    serve = {arch: timed(f"{arch} serve", serve_dense, dev, arch, records,
                         arch.startswith("minicpm"))
             for arch in DENSE_ARCHS[:2]}
    timed("gemma3 generate", generate_gemma, dev, records)
    train = {arch: timed(f"{arch} train", train_dense, dev, arch, records)
             for arch in DENSE_ARCHS}
    print(f"dense: phase 18 wall {time.perf_counter() - t_phase} s; by part "
          f"{walls}")
    return {"serve": serve, "train": train}


# -- phase 19: Qwen2-VL-7B (M-RoPE) and Whisper-base (enc-dec) ---------------
VLM_ARCH, ENCDEC_ARCH = "qwen2-vl-7b", "whisper-base"
# the reference's configs: layers, d, heads, kv heads, head_dim, d_ff,
# vocab, M-RoPE sections, dtype
VLM_WIDTHS = (28, 3584, 28, 4, 128, 18944, 152064, (16, 24, 24),
              "bfloat16")
# decoder layers, encoder layers, d, heads, kv heads, head_dim, d_ff,
# vocab, frames, norm, MLP, dtype
WHISPER_WIDTHS = (6, 6, 512, 8, 8, 64, 2048, 51865, 1500, "ln", "gelu_mlp",
                  "bfloat16")
# the reference's abstract init's counts (tests/test_torch_vlm_encdec.py)
VLM_PARAMS, WHISPER_PARAMS = 7_615_487_488, 88_175_616
# Qwen2-VL's prompts open with a stub image block of VLM_GRID patch tokens
# (t fixed, h and w the grid), then text whose positions continue from the
# grid's maximum + 1 (``data/tokens.py::image_positions``); decode
# positions continue from the prompt's last
VLM_GRID = (4, 4)
# Whisper generates for 8 stub frame sequences (B, 1500, 512) fp32
WHISPER_GEN_BATCH = 8
# one Qwen2-VL block at full width in fp32, card against CPU, under an
# image block of VLM_BLOCK_GRID patches (the three streams differ on its
# 96 tokens); prefill of VLM_BLOCK_PRE tokens, then one decode step
VLM_BLOCK_TOKENS, VLM_BLOCK_PRE, VLM_BLOCK_GRID = 256, 192, (8, 12)
# training at full width: qwen2-vl's depth cut to VLM_TRAIN_LAYERS (36 B a
# param: 28 layers' state is 274 GB; PERF.md §4), whisper at full depth
# (6.35 GB of state) with WHISPER_TRAIN_ROWS sequences of 4096 tokens and
# 1500 frames a microbatch (PERF.md §4: the config's 256 in one
# microbatch cannot fit without remat); both DENSE_ACCUM microbatches a
# step, warm-up 0, cool-down DENSE_COOLDOWN; qwen2-vl at 1 since phase
# 21(f) brought the script to 1,042.9 s (qwen2-vl-train 20.3 s of it; one
# kind of layer)
VLM_TRAIN_LAYERS = 1
WHISPER_TRAIN_ROWS = 16
# qwen2-vl-train's sequences open with a stub image block of 32 x 32
# patches (a 896 x 896 image at 28 pixels a merged patch): the (t, h, w)
# streams differ on its 1024 tokens, so the cell trains M-RoPE, not RoPE
VLM_TRAIN_GRID = (32, 32)
# K7 and K7b at the shapes no earlier phase meets, bf16: Qwen2-VL's GQA at
# rep 7 (28 / 4 heads of 128) on a 4096-token microbatch (K7b at two);
# Whisper's encoder (1500 x 1500, non-causal), its cross-attention (4096
# queries over 1500 keys, non-causal) and its prefill's (64 over 1500), at
# the generation batch
VLM_K7 = (1, 4096, 4096, 28, 4, 128, True, 0)
VLM_K7B = (2, 4096, 4096, 28, 4, 128, True, 0)
WHISPER_ENC = (8, 1500, 1500, 8, 8, 64, False, 0)
WHISPER_CROSS = (8, 4096, 1500, 8, 8, 64, False, 0)
WHISPER_PREFILL = (8, 64, 1500, 8, 8, 64, False, 0)


def _vlm_widths(cfg):
    return (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            tuple(cfg.mrope_sections), cfg.dtype)


def _whisper_widths(cfg):
    return (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.encoder_seq_len, cfg.norm, cfg.act, cfg.dtype)


def _drawn(what, arch, dev, widths, want_widths, want_params):
    """The serve launcher's model and seeded random params (the engine
    refuses both families: they generate through ``prefill`` /
    ``decode_step``), widths and count held."""
    t0 = time.perf_counter()
    model, params = launch_serve.model_and_params(arch, device=dev)
    torch.cuda.synchronize()
    cfg = model.cfg
    require(widths(cfg) == want_widths, f"{what}: config {widths(cfg)}, "
            f"expected {want_widths}")
    n_p = model.param_count(params)
    require(n_p == want_params, f"{what}: {n_p} params")
    wbytes = sum(t.numel() * t.element_size()
                 for _, t in leaves_with_paths(params))
    print(f"{what}: {arch} at {cfg.n_layers} layers, {n_p} params, {wbytes} "
          f"bytes of weights drawn on the card in "
          f"{time.perf_counter() - t0} s")
    return model, params, wbytes


def _generated(what, model, params, prompts, extra, step_extra, n_k7,
               out):
    """Phase 19's generation checks: two greedy generations bit for bit,
    K7 `n_k7` times a prefill (all through its Hopper design) and never in
    a decode step, finite logits; prints and records (into `out`) prefill
    ms, decode ms, tokens/s and the peak. Returns (tokens, logits)."""
    dev = prompts.device
    total = torch.cuda.get_device_properties(dev).total_memory
    B = prompts.shape[0]
    V = model.cfg.vocab_size
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    toks, logits, pre_ms, dec = _generate(model, params, prompts, SSM_NEW,
                                          extra, step_extra)
    require_counts(f"{what} batch {B}", {"flash_attention": n_k7})
    require_wgmma(f"{what} batch {B}")
    peak = torch.cuda.max_memory_allocated(dev)
    toks2, logits2, _, dec2 = _generate(model, params, prompts, SSM_NEW,
                                        extra, step_extra)
    reset_counts()
    require(torch.equal(toks, toks2) and torch.equal(logits, logits2),
            f"{what}: repeat generations differ")
    require(bool(torch.isfinite(logits[..., :V]).all()),
            f"{what}: non-finite logits")
    d_ms = float(np.median(dec + dec2))
    tok_s = B * SSM_NEW / ((pre_ms + sum(dec)) / 1e3)
    print(f"{what} batch {B} x {prompts.shape[1]} tokens, {SSM_NEW} new: "
          f"prefill {pre_ms} ms, decode step median {d_ms} ms (steps {dec}),"
          f" {tok_s} tokens/s; peak allocated {peak} bytes ({peak / total} "
          f"of the card); repeat bit-identical; K7 {n_k7} a prefill, 0 in "
          "decode")
    out.update(prefill_ms=pre_ms, decode_ms=d_ms, tokens_per_s=tok_s,
               peak=peak)
    return toks, logits


def _fp32_drift(what, cfg, dev, prompts, extra, step_extra, full_extra):
    """The decode path against ``forward``'s in fp32 at `cfg`'s depth
    (seeded random weights drawn on the card), held to SERVE_LOGIT_TOL."""
    model = tfm.LanguageModel(dataclasses.replace(cfg, dtype="float32"),
                              device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    toks, logits, _, _ = _generate(model, params, prompts, SSM_NEW, extra,
                                   step_extra)
    err, scale = _decode_vs_forward(model, params, prompts, toks, logits,
                                    full_extra)
    reset_counts()
    print(f"{what} float32 at {cfg.n_layers} layers batch "
          f"{prompts.shape[0]}: decode vs forward worst |diff| / max(1, "
          f"max|logits|) {err / scale} over {SSM_NEW} positions (limit "
          f"{SERVE_LOGIT_TOL})")
    require(err / scale <= SERVE_LOGIT_TOL, f"{what} float32: decode "
            f"logits off forward's by {err / scale}")
    del model, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return err / scale


def generate_vlm(dev, records):
    """Phase 19 (a): Qwen2-VL-7B at full width and depth generating
    through ``prefill`` / ``decode_step`` under M-RoPE: 8 prompts of an
    image block and text, 16 new tokens, twice bit for bit (K7 28 a
    prefill, none in decode); the bf16 decode logits against
    ``forward``'s at the same streams printed; a 4096-token forward; the
    fp32 decode path held to ``forward``'s at full depth; one block card
    against CPU."""
    what = "qwen2-vl-generate"
    model, params, wbytes = _drawn(what, VLM_ARCH, dev, _vlm_widths,
                                   VLM_WIDTHS, VLM_PARAMS)
    cfg = model.cfg
    B, S = 8, SSM_PROMPT
    g = torch.Generator(device=dev).manual_seed(B)
    prompts = torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                            device=dev)
    pos = image_positions(B, S, VLM_GRID, device=dev)
    nxt = int(pos.max()) + 1

    def step(i):
        return {"positions": torch.full((B, 3, 1), nxt + i,
                                        dtype=torch.int32, device=dev)}
    extra = {"positions": pos}
    full_extra = {"positions": torch.cat(
        [pos, (nxt + torch.arange(SSM_NEW - 1, dtype=torch.int32,
                                  device=dev)).expand(B, 3, SSM_NEW - 1)],
        2)}
    out = dict(weight_bytes=wbytes)
    toks, logits = _generated(what, model, params, prompts, extra, step,
                              cfg.n_layers, out)
    err, scale = _decode_vs_forward(model, params, prompts, toks, logits,
                                    full_extra)
    out["bf16_drift"] = err / scale
    n_img = VLM_GRID[0] * VLM_GRID[1]
    print(f"{what}: image block {VLM_GRID}, text positions "
          f"{int(pos[0, 0, n_img])} ... {nxt - 1}, decode from {nxt}; bf16 "
          f"decode vs forward |diff| / max(1, max|logits|) {err / scale} "
          "(printed; held in fp32 below)")
    del logits
    out["forward_4096_ms"] = forward_4096(f"{what} forward 4096", model,
                                          params, dev)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    out["float32_drift"] = _fp32_drift(what, cfg, dev, prompts, extra, step,
                                       full_extra)
    out["block"] = check_vlm_block(dev, cfg)
    records.setdefault("vlm_encdec", {})[what] = out


def _vlm_block_run(p, x, dout, cfg, pos, n_pre):
    """One Qwen2-VL block forward and backward under the streams `pos`,
    then a prefill of the first `n_pre` tokens into a fresh cache and the
    next token's decode step: (out, {name: gradient}, prefill out, decode
    out)."""
    req = {path: t.detach().clone().requires_grad_(True)
           for path, t in leaves_with_paths(p)}
    live = map_with_paths(lambda path, _: req[path], p)
    xr = x.detach().clone().requires_grad_(True)
    B, S, _ = x.shape
    with torch.enable_grad():
        out, _, _ = tfm._apply_block("dense", xr, live, cfg, positions=pos,
                                     cache=None, chunk_k=1024)
        (out.float() * dout).sum().backward()
    grads = {"x": xr.grad, **{path: t.grad for path, t in req.items()}}
    cache = init_kv_cache(B, S, cfg.n_kv_heads, cfg.head_dim, x.dtype,
                          x.device)
    with torch.no_grad():
        pre, _, _ = tfm._apply_block("dense", x[:, :n_pre], p, cfg,
                                     positions=pos[..., :n_pre], cache=cache,
                                     chunk_k=1024)
        dec, _, _ = tfm._apply_block(
            "dense", x[:, n_pre:n_pre + 1], p, cfg,
            positions=pos[..., n_pre:n_pre + 1],
            cache=KVCache(cache.k, cache.v, n_pre), chunk_k=1024)
    return out.detach(), grads, pre, dec


def check_vlm_block(dev, cfg):
    """Phase 19 (a), last: one Qwen2-VL dense block at full width in fp32
    (28 / 4 heads of 128, M-RoPE) on VLM_BLOCK_TOKENS tokens under an image
    block's streams, which differ: forward, backward, prefill and one
    decode step, on the card twice (bit for bit) and on the CPU from the
    same params and inputs, within SSM_BLOCK_TOL. Returns the worst
    distance."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(18)
    p = tfm._block_init(g, cfg, "dense", (), dev)
    for k in ("ln1", "ln2"):
        p[k]["scale"] = 0.1 * torch.randn(p[k]["scale"].shape, generator=g,
                                          device=dev)
    x = torch.randn((1, VLM_BLOCK_TOKENS, cfg.d_model), generator=g,
                    device=dev)
    dout = torch.randn(x.shape, generator=g, device=dev)
    pos = image_positions(1, VLM_BLOCK_TOKENS, VLM_BLOCK_GRID, start=2,
                          device=dev)
    n_pre = VLM_BLOCK_PRE
    t0 = time.perf_counter()
    card = _vlm_block_run(p, x, dout, cfg, pos, n_pre)
    again = _vlm_block_run(p, x, dout, cfg, pos, n_pre)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host = lambda t: t.detach().to("cpu")  # noqa: E731
    t0 = time.perf_counter()
    cpu = _vlm_block_run(tree_map(host, p), host(x), host(dout), cfg,
                         host(pos), n_pre)
    cpu_s = time.perf_counter() - t0
    errs = _held_card_vs_cpu("qwen2-vl block", card, again, cpu, n_pre)
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"qwen2-vl block (28 / 4 heads of 128, M-RoPE {cfg.mrope_sections}"
          f", image block {VLM_BLOCK_GRID}, {VLM_BLOCK_TOKENS} tokens, fp32):"
          f" forward, backward, prefill of {n_pre} and one decode step; card "
          f"twice bit-identical; against the CPU worst {worst[0]} {worst[1]}"
          f" of the largest magnitude (limit {SSM_BLOCK_TOL}; out "
          f"{errs['out']}, prefill {errs['prefill']}, decode "
          f"{errs['decode']}, decode vs forward {errs['decode vs forward']}"
          f", dx {errs['dx']}); card {card_s} s for two runs, CPU {cpu_s} s")
    del card, again, cpu
    torch.cuda.empty_cache()
    return worst[1]


def generate_whisper(dev, records):
    """Phase 19 (b): Whisper-base at full width and depth (6 + 6 layers)
    generating through ``prefill`` / ``decode_step`` for WHISPER_GEN_BATCH
    stub frame sequences: 64-token prompts, 16 new tokens, twice bit for
    bit (K7 18 a prefill: 6 encoder, 6 causal self, 6 cross of 64 queries
    over 1500 keys; none in decode); the cross caches' two tensors; a
    4096-token forward; the fp32 decode path held to ``forward``'s."""
    what = "whisper-generate"
    model, params, wbytes = _drawn(what, ENCDEC_ARCH, dev, _whisper_widths,
                                   WHISPER_WIDTHS, WHISPER_PARAMS)
    cfg = model.cfg
    n_k7 = cfg.n_encoder_layers + 2 * cfg.n_layers
    B, S = WHISPER_GEN_BATCH, SSM_PROMPT
    g = torch.Generator(device=dev).manual_seed(B)
    frames = torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=g,
                         device=dev)
    prompts = torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                            device=dev)
    extra = {"frames": frames}
    out = dict(weight_bytes=wbytes)
    toks, logits = _generated(what, model, params, prompts, extra, None,
                              n_k7, out)
    err, scale = _decode_vs_forward(model, params, prompts, toks, logits,
                                    extra)
    out["bf16_drift"] = err / scale
    print(f"{what}: bf16 decode vs forward |diff| / max(1, max|logits|) "
          f"{err / scale} (printed; held in fp32 below)")
    del logits
    caches = model.init_cache(B, S)
    with torch.no_grad():
        model.prefill(params, {"tokens": prompts, **extra}, caches)
    ck, cv = caches["seg1"]["cross_k"], caches["seg1"]["cross_v"]
    require(ck.untyped_storage().data_ptr() != cv.untyped_storage()
            .data_ptr() and not torch.equal(ck, cv) and
            bool(ck.abs().amax() > 0), f"{what}: the cross caches share "
            "storage or were not written")
    print(f"{what}: cross_k and cross_v {tuple(ck.shape)} keep their own "
          "storage, each written by the prefill")
    del caches, ck, cv
    reset_counts()
    out["forward_4096_ms"] = forward_4096(
        f"{what} forward 4096", model, params, dev,
        extra={"frames": frames[:1]}, n_k7=n_k7)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    out["float32_drift"] = _fp32_drift(what, cfg, dev, prompts, extra, None,
                                       extra)
    records.setdefault("vlm_encdec", {})[what] = out


def train_vlm_encdec(dev, arch, records):
    """Phase 19 (c) and (d) through ``train_cell``: Qwen2-VL at full width
    cut to VLM_TRAIN_LAYERS, under a VLM_TRAIN_GRID image block's M-RoPE
    streams (K7 twice
    under remat, K7b once per layer and microbatch); Whisper at full
    width and depth on the stream's frames, WHISPER_TRAIN_ROWS sequences a
    microbatch (no remat: K7 and K7b once per attention, 18). Returns the
    graphed run's launches."""
    mc = get_config(arch).model
    grid = None
    if arch == VLM_ARCH:
        n_layers, rows, n_attn = VLM_TRAIN_LAYERS, 1, VLM_TRAIN_LAYERS
        grid = VLM_TRAIN_GRID
        expect = (10, 40, "bfloat16", "all", True, True, "matpow", "leaf",
                  10, "adamw", 2e-4, 0.95, 0.1, 1.0, "cosine", 8, "block",
                  mc.d_model, n_layers)
    else:
        n_layers, rows = mc.n_layers, WHISPER_TRAIN_ROWS
        n_attn = mc.n_encoder_layers + 2 * mc.n_layers
        expect = (14, 55, "float32", "all", True, True, "matpow", "leaf",
                  10, "adamw", 1e-3, 0.999, 0.0, 1.0, "cosine", 1, "none",
                  mc.d_model, n_layers)
    return train_cell(dev, arch, n_layers, DENSE_COOLDOWN, DENSE_ACCUM,
                      expect, n_attn, LM_FAMILIES, records, "vlm_encdec",
                      wgmma=True, rows=rows, grid=grid)


def run_vlm_encdec(dev, records):
    """Phase 19. Returns the launches of its counted runs."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    for tag, k7 in (("qwen2_vl_rep7", VLM_K7), ("whisper_enc", WHISPER_ENC),
                    ("whisper_cross", WHISPER_CROSS),
                    ("whisper_prefill", WHISPER_PREFILL)):
        records["flash_attention"][tag] = time_flash(k7, dev)
    for tag, k7b in (("qwen2_vl_rep7", VLM_K7B),
                     ("whisper_enc", WHISPER_ENC),
                     ("whisper_cross", WHISPER_CROSS)):
        w0 = kf.LAUNCHES["flash_attention_bwd_wgmma"]
        records["flash_attention_bwd"][tag] = time_flash_bwd(k7b, dev)
        require(kf.LAUNCHES["flash_attention_bwd_wgmma"] > w0,
                f"K7b {k7b}: not through the Hopper design")
        torch.cuda.empty_cache()
    reset_counts()
    walls = {"K7/K7b": time.perf_counter() - t_phase}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out
    timed("qwen2-vl generate", generate_vlm, dev, records)
    timed("whisper generate", generate_whisper, dev, records)
    train = {arch: timed(f"{arch} train", train_vlm_encdec, dev, arch,
                         records)
             for arch in (VLM_ARCH, ENCDEC_ARCH)}
    print(f"vlm-encdec: phase 19 wall {time.perf_counter() - t_phase} s; by "
          f"part {walls}")
    return {"train": train}


# phase 20: the audit layer (repro_torch.audit) on the card
AUDIT_TARGETS = ("train_step", "dmd_step", "dmd_step_gated", "record_update")
# each audited step's kernel calls, launched on the card as counted by the
# wrappers (the paper MLP: one arena bucket)
AUDIT_LAUNCHES = {"train_step": {"gram_row": 1}, "dmd_step": {"combine": 1},
                  "dmd_step_gated": {"combine": 1},
                  "record_update": {"gram_row": 1}}


def _audit_full_width(dev):
    """Phase 20(a): ``build_context("pollutant-mlp")`` at the paper MLP's
    full width on the card: every pass green, each target's op count equal
    to the same build's on the CPU, its K1 / K2 launches as counted."""
    from repro_torch.audit.registry import run_passes
    from repro_torch.audit.targets import build_context

    ctx = build_context("pollutant-mlp", device=dev)
    n_params = sum(p.numel() for _, p in leaves_with_paths(
        ctx.acc.params_leafwise(ctx.state.params)))
    require(n_params == 2_882_150, f"audit (a): {n_params} params")
    report = run_passes(ctx)
    print(report.render())
    require(report.ok and len(report.results) == 10,
            "audit (a): the paper MLP's audit is not clean over ten passes")
    cpu = build_context("pollutant-mlp", device="cpu")
    for name in AUDIT_TARGETS:
        card, host = ctx.targets[name].recording, cpu.targets[name].recording
        require(card.count == host.count, f"audit (a) {name}: {card.count} "
                f"ops on the card, {host.count} on the CPU")
        require([o.name for o in card.kernel_calls]
                == [o.name for o in host.kernel_calls],
                f"audit (a) {name}: kernel calls differ from the CPU's")
        launches = {k: v for k, v in card.launches.items()
                    if k not in DESIGNS}
        require(launches == AUDIT_LAUNCHES[name], f"audit (a) {name}: "
                f"launches {launches}, expected {AUDIT_LAUNCHES[name]}")
        print(f"audit (a) {name}: {card.count} ops on the card = "
              f"{host.count} on the CPU; kernel calls "
              f"{[o.name for o in card.kernel_calls]}; launches {launches}; "
              f"host syncs {len(card.syncs)}")


def _audit_sync_free(dev):
    """Phase 20(b): the plain train step, a record step and record_update
    at full width under ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.audit import targets as audit_targets
    from repro_torch.train.step import audit_step_fns

    model, acfg, batch = audit_targets._build_model_and_config(
        "pollutant-mlp", False, dev)
    acc, fns = audit_step_fns(model, acfg, device=dev)
    state = audit_targets._init_state(model, acfg, acc, dev)
    plain = np.full((acc.n_groups,), -1, np.int64)
    slots = audit_targets.audit_slots(acc)
    calls = (("plain train step", lambda: fns["train_step"](state, batch,
                                                           plain)),
             ("record train step", lambda: fns["train_step"](state, batch,
                                                            slots)),
             ("record_update", lambda: fns["record_update"](
                 state.dmd_buffers, state.dmd_gram, state.params, slots)))
    for _, call in calls:                     # warm-up: caches, tickets
        call()
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _, call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    require_counts("audit (b)", {"gram_row": 2})
    print(f"audit (b): {', '.join(n for n, _ in calls)} ran under "
          "set_sync_debug_mode('error') without a host sync (K1 2)")


def _audit_mutations(dev):
    """Phase 20(c): each mutation fails exactly its pass on the card, at
    pollutant-mlp --reduced (its clean build green)."""
    from repro_torch.audit import run_audit
    from repro_torch.audit.mutations import get, list_mutations

    for name in (None,) + tuple(n for n in list_mutations()
                                if not get(n).needs_mesh):
        report = run_audit("pollutant-mlp", reduced=True, mutate=name,
                           device=dev)
        failed = sorted(r.name for r in report.results if not r.ok)
        want = [] if name is None else [get(name).expect_fail]
        require(failed == want, f"audit (c) {name}: failed {failed}, "
                f"expected {want}\n{report.render()}")
        print(f"audit (c) {name or 'clean'}: failed {failed}")


def _audit_serve(dev):
    """Phase 20(d): the serve audit at TinyLlama-1.1B's full width and
    depth (phase 9's seeded weights), through attach_serve's config and
    waves; then force-recompile must bite."""
    from repro_torch.audit.mutations import get
    from repro_torch.audit.passes import serve_compile
    from repro_torch.audit.targets import adhoc_context
    from repro_torch.configs import get_config
    from repro_torch.serve.audit import serve_audit

    model, params = launch_serve.model_and_params("tinyllama-1.1b",
                                                  device=dev)
    require(model.cfg.n_layers == 22 and model.cfg.d_model == 2048,
            f"audit (d): config {model.cfg}")
    acfg = get_config("tinyllama-1.1b")
    for mode in (None, "force-recompile"):
        what = f"audit (d) {mode or 'clean'}"
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        info, targets, engine = serve_audit(
            model, params, mutate=get(mode).serve_cfg if mode else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = require_counts(what, {
            "flash_attention": model.cfg.n_layers
            * engine.stats["prefill_dispatches"]})
        require_wgmma(what)
        ctx = adhoc_context("tinyllama-1.1b", acfg, targets, device="cuda")
        ctx.serve = info
        vs, sinfo = serve_compile(ctx)
        st = engine.stats
        print(f"{what}: {json.dumps(sinfo)}; {st['prefill_dispatches']} "
              f"prefills, {st['decode_dispatches']} decodes in {wall} s; "
              f"launches {launches}")
        if mode is None:
            require(not vs, f"{what}: {[v.detail for v in vs]}")
            require(sinfo["steady_compiles"] == 0 and sinfo["dropped"] == 0
                    and sinfo["n_programs"] <= sinfo["max_programs"]
                    and sinfo["decode_cache_copies"] == 0
                    and sinfo["table_kept"] == sinfo["table_leaves"]
                    and sinfo["decode_alias_count"]
                    == targets["serve_decode"].n_dmd_leaves,
                    f"{what}: {sinfo}")
        else:
            require(vs and sinfo["steady_compiles"] > 0, f"{what}: the "
                    f"mutation did not bite: {sinfo}")
        del engine, targets
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def run_audit_phase(dev):
    """Phase 20: the audit layer on the card."""
    t_phase = time.perf_counter()
    walls = {}
    for part, fn in (("(a)", _audit_full_width), ("(b)", _audit_sync_free),
                     ("(c)", _audit_mutations), ("(d)", _audit_serve)):
        t0 = time.perf_counter()
        fn(dev)
        walls[part] = time.perf_counter() - t0
    print(f"audit: phase 20 wall {time.perf_counter() - t_phase} s; by part "
          f"{walls}")


# ---------------------------------------------------------------------------
# phase 21: the mesh, four ranks on the one card (gloo on CUDA tensors)
# TinyLlama-1.1B at its full width, its 22 layers cut to MESH_LAYERS (all of
# one kind, so the cut drops no code path), on a (2, 2) mesh
MESH_LAYERS = 2
MESH_B, MESH_S = 8, 1024          # the global batch: 4 sequences a data rank
# gloo moves ~0.5-0.7 GB/s between ranks on one host
# (examples/torch_mesh_probe.py on the H100 host), and a step all-gathers
# the params and all-reduces the gradient: seconds a step at this width,
# so the run is short
MESH_STEPS = 6                    # one jump, at step 4 (m 4, cool-down 1)
MESH_SAVE = 4                     # (c)'s checkpoint: mid-window (slots
                                  # 0-2 written; the jump step 4 to run)
MESH_DMD = dict(m=4, s=10, warmup_steps=0, cooldown_steps=1,
                param_filter="all", snapshot_dtype="bfloat16")
# the (2, 2) run against one rank, relative: only the order of the
# gradient's fp32 sums differs (two half-batch gradients summed against one
# full-batch gradient); on the H100 the losses differed by at most 4.8e-6
# before the jump and 2.0e-6 after it
MESH_LOSS_TOL = (1e-5, 1e-4)      # up to the first jump, after it
# the final params against one rank's: each leaf's L2 distance over the L2
# distance the leaf moved from its init (a run that never updated its
# params scores 1). bf16 gradients summed in another order flip the sign
# of Adam's early updates wherever a gradient is near zero: on the H100
# the (2, 2) run ended 9.8% of a leaf's move away from one rank at the
# most, against 93% for one rank trained on half of every batch
MESH_PARAM_TOL = 0.2
MESH_GRAM_TOL = 1e-4              # a carried Gram against K3's recompute
MESH_RANKS = 4
# (b) is tensor-parallel over "model": each rank's K7 / K7b run on its
# heads, (q heads, kv heads, head size): TinyLlama's 32 / 4 heads of 64
# over a "model" axis of 2
MESH_HEADS = (16, 2, 64)
# (f): four families at full width, each cut to one layer of one kind, on
# the (2, 2) mesh against one rank on the same params and batch (one
# microbatch of TP_B x TP_S tokens, the configs' remat)
TP_FAMILIES = ("minicpm-2b", "granite-20b", "qwen3-moe-30b-a3b",
               "mamba2-2.7b")
TP_ATTENTION = ("minicpm-2b", "granite-20b", "qwen3-moe-30b-a3b")
TP_B, TP_S = 2, 1024
# the planted faults of distributed/checks.py and the family each runs on
TP_FAULTS = {"drop-row-sum": "minicpm-2b",
             "drop-replicated-sum": "mamba2-2.7b"}
# the (2, 2) mesh against one rank, bf16: the loss relative, and each
# param block's gradient as ||mesh - one rank|| over the block / the
# leaf's ||one rank||. On the H100 the four families read at most 1.3e-6
# and 0.045 (Qwen3's ln2 scale: a sum over every token of bf16 partial
# products), the dropped row-parallel all-reduce 1.8e-4 and 0.74, the
# dropped norm_scale sum 0 and 0.69
TP_LOSS_TOL = 1e-5
TP_GRAD_TOL = 0.1
# K7 / K7b timed at a rank's shapes (B, Sq, Sk, H, K, d, causal, window):
# (b)'s TinyLlama rank, then (f)'s MiniCPM (moved, padded MHA), Granite
# (one kv head) and Qwen3 ranks
# (g) kv-SP at full width on the (2, 2) mesh against one rank, one
# microbatch of TP_B x TP_S tokens: TinyLlama-1.1B at KV_SP_LAYERS layers
# in the reference's --reduced layout (head_tp False: 32 / 4 heads of 64
# on every rank, rank 1's keys at offset 512), and Whisper-base at its
# full depth as its config lays it out (head_tp None: kv-SP in all 18
# attention calls, the encoder's and the cross-attention's over 1500
# frames, 750 a rank); held to TP_LOSS_TOL and TP_GRAD_TOL
KV_SP_CELLS = ("tinyllama-1.1b", "whisper-base")
KV_SP_LAYERS = 1
WHISPER_PARAMS = 88_175_616
# the planted faults of kv-SP (distributed/checks.py) and the cell each
# runs on: the merge without its weights, dq without its sum over "model"
KV_SP_FAULTS = {"kv-sp-unweighted-merge": "tinyllama-1.1b",
                "kv-sp-drop-dq-sum": "tinyllama-1.1b"}
TP_K7_CASES = {"tinyllama rank": (4, 1024, 1024, 16, 2, 64, True, 0),
               "minicpm rank": (1, 1024, 1024, 24, 24, 64, True, 0),
               "granite rank": (1, 1024, 1024, 24, 1, 128, True, 0),
               "qwen3 rank": (1, 1024, 1024, 16, 2, 128, True, 0)}


def _mesh_acfg():
    acfg = launch_train.configure("tinyllama-1.1b", steps=MESH_STEPS,
                                  global_batch=MESH_B, seq=MESH_S,
                                  n_layers=MESH_LAYERS)
    return dataclasses.replace(
        acfg, dmd=dataclasses.replace(acfg.dmd, **MESH_DMD),
        optimizer=dataclasses.replace(acfg.optimizer, schedule="constant"),
        parallel=dataclasses.replace(acfg.parallel, grad_accum=1,
                                     remat="none"))


def _mesh_trainer(acfg, dev, mesh, ckpt=None):
    model = launch_train.make_model(acfg, device=dev, mesh=mesh)
    return Trainer(model, acfg, device=dev, cuda_graphs=False, mesh=mesh,
                   checkpoint_dir=ckpt)


def _mesh_init(tr, dev):
    gen = torch.Generator(device=dev).manual_seed(tr.acfg.train.seed)
    return tr.init_state(key=gen)


def _mesh_fit(tr, dev, state, rows=None):
    """Fit from `state` to MESH_STEPS on the token stream (each batch cut to
    its first `rows` sequences, where given): (state, losses, jump steps,
    host ms of each step)."""
    tc = tr.acfg.train
    batches = synthetic_lm_batches(tc.seed, tc.global_batch, tc.seq_len,
                                   tr.acfg.model.vocab_size,
                                   start_step=int(state.step), device=dev)
    if rows is not None:
        batches = ({k: v[:rows] for k, v in b.items()} for b in batches)
    ms, t = [], [time.perf_counter()]

    def on_m(step, m):
        now = time.perf_counter()
        ms.append((now - t[0]) * 1e3)
        t[0] = now
    state, losses, jumps, _ = mesh_checks.fit(tr, batches, MESH_STEPS, state,
                                              on_metrics=on_m)
    return state, losses, jumps, ms


def _mesh_eval(tr, state, dev) -> float:
    """The loss of the full params on a batch no step trained on (every
    rank takes part in the gathers)."""
    params = mesh_checks.full_params(tr, state)
    batch = synthetic_lm_batches(tr.acfg.train.seed + 1, 2, MESH_S,
                                 tr.acfg.model.vocab_size, device=dev)
    with torch.no_grad():
        out = float(tr.model.loss(mesh_checks.nest(params), next(batch))[0])
    del params
    return out


def _host_params(tr, state) -> dict:
    """{path: full param} on the host (every rank gathers)."""
    return {p: x.detach().cpu()
            for p, x in mesh_checks.full_params(tr, state).items()}


def _loss_errs(got, want, jumps) -> tuple:
    """Relative loss differences: the largest up to the first jump's step
    (its loss included) and after it."""
    errs = np.abs(np.asarray(got) - np.asarray(want)) / np.abs(want)
    k = jumps[0] + 1 if jumps else len(errs)
    return (float(errs[:k].max(initial=0.0)),
            float(errs[k:].max(initial=0.0)))


def _param_errs(got, want, init, dev) -> dict:
    """Per leaf: ||got - want|| / ||want - init|| (fp32 L2 norms) and
    max |got - want| / max |want|."""
    out = {}
    for p, w in want.items():
        w = w.to(dev).float()
        g, i = got[p].to(dev).float(), init[p].to(dev).float()
        out[p] = (float((g - w).norm() / (w - i).norm().clamp_min(1e-30)),
                  rel_err(g, w))
    return out


def _mesh_one_rank(acfg, dev, rows=None):
    """(b)'s run on one rank without a mesh, eager (each batch cut to
    `rows` sequences, where given): losses, jumps, step ms, launches, the
    held-out loss and the full init and final params on the host."""
    tr = _mesh_trainer(acfg, dev, None)
    state = _mesh_init(tr, dev)
    init = _host_params(tr, state)
    reset_counts()
    state, losses, jumps, ms = _mesh_fit(tr, dev, state, rows=rows)
    torch.cuda.synchronize()
    out = {"losses": losses, "jumps": jumps, "ms": ms,
           "launches": dict(counts()), "init": init,
           "final": _host_params(tr, state),
           "eval": _mesh_eval(tr, state, dev)}
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _flash_heads(out):
    """(q heads, kv heads, head size) of every K7 call the models make
    (``kernels.ops.flash_attention``) inside the block, into `out`."""
    from repro_torch.kernels import ops as kops

    real = kops.flash_attention

    def logged(q, k, v, **kw):
        out.append((q.shape[2], k.shape[2], q.shape[3]))
        return real(q, k, v, **kw)
    kops.flash_attention = logged
    try:
        yield out
    finally:
        kops.flash_attention = real


def _tp_activation_bytes(cfg, rows, seq) -> int:
    """The activation all-reduces over "model" of one training step of a
    dense model without remat on a rank's `rows` x `seq` tokens: the
    embedding's rows; per layer attention's and the MLP's partial outputs
    forward and their inputs' gradients backward; the head's input
    gradient and, per token, its max, sum of exponentials and label logit
    in fp32, in the forward and again in the checkpointed passes'
    recomputation."""
    t = rows * seq
    p = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return t * cfg.d_model * p * (2 + 4 * cfg.n_layers) + 6 * 4 * t


def _tp_records(rec) -> dict:
    """The tensor-parallel collectives among `rec` (over "model", named by
    a site): all-reduce bytes, the other kinds, and the param blocks
    all-gathered over "model"."""
    tp = [c for c in rec if c["axes"] == ("model",) and c["what"]
          and not str(c["what"]).startswith("param:")]
    return {"bytes": sum(c["bytes"] for c in tp if c["kind"] == "all_reduce"),
            "other": sorted({(c["kind"], c["what"]) for c in tp
                             if c["kind"] != "all_reduce"}),
            "model_gathers": len(mesh_checks.model_param_gathers(rec))}


def _mesh_probe(mesh, dev):
    """gloo's collectives on CUDA tensors: all_reduce, broadcast and the
    list form of all_gather, each checked."""
    r = mesh.rank
    t = torch.full((64,), float(r), device=dev)
    mesh.all_reduce(t, mesh.axis_names)
    b = torch.full((64,), float(r + 1), device=dev)
    mesh.broadcast(b)
    parts = mesh.all_gather(torch.full((8,), float(r), device=dev),
                            mesh.axis_names)
    ok = (bool((t == 6.0).all()) and bool((b == 1.0).all())
          and [float(p[0]) for p in parts] == [0.0, 1.0, 2.0, 3.0])
    require(ok, f"mesh: gloo collectives on CUDA tensors wrong on rank {r}")
    return ok


def _mesh_kernel_case(mesh, dev, shapes, stack_dims, arena, dyadic):
    """One data-pass case on the mesh (``distributed/checks.py``'s
    ``data_passes``) over a trajectory drawn on the card, reduced to its
    largest errors and its verdicts; rank 0 also times each pass on its
    blocks (the other ranks wait at the barrier)."""
    gen = torch.Generator(device=dev).manual_seed(5 + int(dyadic))

    def draw(s):
        if not dyadic:
            return torch.randn(s, generator=gen, device=dev)
        # -1, 0, 1 on one lane in 64: every partial sum of a Gram entry
        # stays below 2^24 (65.5M lanes x 2/64 x 4 = 8.2M), so fp32 sums
        # are exact in any order
        x = torch.randint(-1, 2, s, generator=gen, device=dev).float()
        keep = torch.rand(s, generator=gen, device=dev) < 1.0 / 64
        return x * keep

    gen_c = torch.Generator(device=dev).manual_seed(9)
    coeffs = {p: torch.randint(-2, 3, tuple(s[:stack_dims[p]])
                               + (mesh_checks.M,), generator=gen_c,
                               device=dev).float()
              for p, s in sorted(shapes.items())}

    def probe(acc, params, bufs, leaf):
        if arena:
            return _mesh_bucket_times(acc, params, bufs)
        return _mesh_leaf_times(by_path(acc.plans_for(params)), leaf)
    res = mesh_checks.data_passes(
        mesh, shapes, stack_dims, arena=arena, device=dev, keep_full=False,
        snapshot=lambda j: {p: draw(s) for p, s in shapes.items()},
        coefficients=coeffs, probe=probe if mesh.rank == 0 else None)
    mesh.barrier()
    one = res["one"]
    k3 = list(res["recomputed"].items()) + list(res.get("k3", {}).items())
    out = {"gram_err": max(rel_err(g, one[p])
                           for p, g in res["streamed"].items()),
           "k3_err": max(rel_err(g, one[p]) for p, g in k3),
           "exact": all(res["streamed_equal_one"].values()),
           "k2_equal": all(res["k2_slice_equal"].values()) and all(
               res.get("k2_bucket_equal", {0: True}).values()),
           "allreduce_only": all(kind == "all_reduce" for rec in
                                 res["record_collectives"] for kind, _ in rec),
           "record_bytes": sum(n for _, n in res["record_collectives"][-1])}
    out.update(res.get("probe", {}))
    return out


def _mesh_bucket_times(acc, params, bufs):
    """Rank 0's per-block times of K1, K3 and K2 on each bucket (the other
    ranks wait at a barrier, so the card is this rank's) and their twins'
    errors on the same block."""
    table = acc.arena_for(params)
    arenas = arena_mod.split_state(bufs)[0]
    times, twin = {}, 0.0
    for key, b in table.items():
        buf = arenas[key]
        seg = b.tables_on(buf.device)
        q = buf[:, 1, :]
        row = ka._gram_row(buf, q, seg, anchor_first=True)
        gram = ka._gram(buf, seg, anchor_first=True)
        c = torch.ones((b.n_sys, b.m), device=buf.device) / b.m
        twin = max(twin, rel_err(row, ka.gram_row_ref(
            buf, q, seg.block_sys, seg.n_sys, anchor_first=True)),
            rel_err(gram, ka.gram_ref(buf, seg.block_sys, seg.n_sys,
                                      anchor_first=True)),
            rel_err(ka._combine(buf, c, seg),
                    ka.combine_ref(buf, c, seg.block_sys)))
        times[key] = {
            "shape": list(buf.shape), "lane_axes": list(b.lane_axes),
            "bound_ms": bound_ms(buf.numel() * buf.element_size(),
                                 2 * buf.numel())[0],
            "K1_ms": cuda_ms(lambda: ka._gram_row(buf, q, seg,
                                                  anchor_first=True)),
            "K3_ms": cuda_ms(lambda: ka._gram(buf, seg, anchor_first=True),
                             iters=5),
            "K2_ms": cuda_ms(lambda: ka._combine(buf, c, seg))}
    return {"times": times, "bucket_twin_err": twin}


def _mesh_leaf_times(plans, leaf):
    """Rank 0's per-block times of K4, K6 and K5 on the per-leaf route's
    largest block (the other ranks wait at a barrier), beside the least
    time the card could take."""
    from repro_torch.kernels import ops

    bufs = by_path(leaf.dmd_buffers)
    path = max(bufs, key=lambda p: bufs[p].numel())
    buf, plan = bufs[path].contiguous(), plans[path]
    m = buf.shape[0]
    q = buf[1]
    c = torch.ones(tuple(buf.shape[1:1 + plan.stack_dims]) + (m,),
                   device=buf.device) / m
    nbytes = buf.numel() * buf.element_size()
    times = {"shape": list(buf.shape), "leaf": path,
             "K4_ms": cuda_ms(lambda: ops.gram_row(
                 buf, q, anchor_first=True, stack_dims=plan.stack_dims)),
             "K6_ms": cuda_ms(lambda: ops.gram(
                 buf, anchor_first=True, stack_dims=plan.stack_dims),
                 iters=5),
             "K5_ms": cuda_ms(lambda: ops.combine(
                 buf, c, stack_dims=plan.stack_dims)),
             "bound_ms": bound_ms(nbytes, 2 * buf.numel())[0]}
    return {"times": {path: times}}


def _mesh_allreduce_ms(mesh, dev, table) -> dict:
    """Host ms of one all-reduce of each lane-sharded bucket's K1 row and
    K3 Grams over its lane axes (every rank calls; rank 0's clock)."""
    out = {}
    for key, b in sorted(table.items()):
        if not b.lane_axes:
            continue
        for name, shape in (("row", (b.n_sys, b.m)),
                            ("gram", (b.n_sys, b.m, b.m))):
            t = torch.ones(shape, device=dev)
            mesh.all_reduce(t, b.lane_axes)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                mesh.all_reduce(t, b.lane_axes)
            torch.cuda.synchronize()
            out[f"{key} {name} {list(shape)}"] = (
                (time.perf_counter() - t0) / 5 * 1e3)
    return out


def _mesh_kernels(mesh, dev):
    """Phase 21(a): the lane-sharded arena at TinyLlama's full-width shard
    shapes (2 layers) and the reference test's system-sharded bucket
    (override ("stacked", ("fsdp", None, "tp"))), arena and per-leaf
    routes, random and integer-valued trajectories."""
    from repro_torch.distributed import sharding
    from repro_torch.models.transformer import init_params

    lm = {p: tuple(x.shape) for p, x in leaves_with_paths(
        init_params(_mesh_acfg().model, device="meta"))}
    lm_sd = {p: (1 if p.startswith("/seg") else 0) for p in lm}
    cases = {"lane": (lm, lm_sd, None),
             "sys": ({"/stacked": (4, 2048, 5632), "/w": (2048, 5632)},
                     {"/stacked": 1, "/w": 0},
                     [(r"stacked", ("fsdp", None, "tp"))])}
    out = {}
    for name, (shapes, sd, override) in cases.items():
        sharding.set_rule_overrides(override)
        try:
            for arena in (True, False):
                for dyadic in (False, True):
                    out[f"{name} {'arena' if arena else 'per-leaf'} "
                        f"{'integer' if dyadic else 'random'}"] = \
                        _mesh_kernel_case(mesh, dev, shapes, sd, arena,
                                          dyadic)
                    torch.cuda.empty_cache()
        finally:
            sharding.set_rule_overrides(None)
    return out


def _mesh_train(mesh, dev, ckpt):
    """Phase 21(b): TinyLlama at full width on the (2, 2) mesh, eager,
    checkpointed at MESH_SAVE for (c); rank 0 brings back the full final
    params."""
    from repro_torch.launch.mesh import record_collectives

    acfg = _mesh_acfg()
    acfg = dataclasses.replace(acfg, train=dataclasses.replace(
        acfg.train, checkpoint_every=MESH_SAVE))
    tr = _mesh_trainer(acfg, dev, mesh, ckpt)
    coeffs = mesh_checks.CoefficientLog(mesh)
    save_s = []
    inner_save = tr.save

    def timed_save(state, step):
        t0 = time.perf_counter()
        inner_save(state, step)
        save_s.append(time.perf_counter() - t0)
    tr.save = timed_save
    state = _mesh_init(tr, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    heads = []
    t_fit = time.perf_counter()
    with _flash_heads(heads), record_collectives() as fit_rec:
        state, losses, jumps, ms = _mesh_fit(tr, dev, state)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t_fit
    tp = _tp_records(fit_rec)
    del fit_rec
    launches = dict(counts())
    wgmma = {k: kf.LAUNCHES[k] for k in ("flash_attention_wgmma",
                                         "flash_attention_bwd_wgmma")}
    coeffs.close()
    peak = torch.cuda.max_memory_allocated(dev)
    table = tr.acc.arena_for(state.params)
    slots = tr.acc.slots(6)
    with record_collectives() as rec:
        tr.acc.record(state.dmd_buffers, state.params, slots, state.dmd_gram)
    analytic = sum(b.n_sys * b.m * 4 for b in table.values() if b.lane_axes)
    ar_ms = _mesh_allreduce_ms(mesh, dev, table)
    evl = _mesh_eval(tr, state, dev)
    final = _host_params(tr, state)
    out = {"losses": losses, "jumps": jumps, "ms": ms, "launches": launches,
           "wgmma": wgmma, "peak": peak, "eval": evl, "fit_s": t_fit,
           "save_s": save_s,
           "final": final if mesh.rank == 0 else None,
           "c_before": coeffs.before, "c_after": coeffs.after,
           "record": [(c["kind"], c["bytes"]) for c in rec],
           "analytic": analytic, "allreduce_ms": ar_ms,
           "buckets": {k: [b.n_sys, b.n_sys_global, b.n_lanes_local,
                           list(b.lane_axes), list(b.sys_axes)]
                       for k, b in table.items()},
           "heads": sorted(set(heads)), "tp": tp,
           "tp_analytic": MESH_STEPS * _tp_activation_bytes(
               acfg.model, MESH_B // mesh.axis_size("data"), MESH_S)}
    del state, tr, final
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_restore(mesh, dev, ckpt):
    """Phase 21(c) on a mesh (or one rank without one): (b)'s checkpoint
    restored and run to MESH_STEPS."""
    tr = _mesh_trainer(_mesh_acfg(), dev, mesh, ckpt)
    t0 = time.perf_counter()
    restored = tr.restore()           # its template: init_state's draw
    restore_s = time.perf_counter() - t0
    errs = mesh_checks.gram_errors(tr, restored)
    start = int(restored.step)
    state, losses, jumps, _ = _mesh_fit(tr, dev, restored)
    evl = _mesh_eval(tr, state, dev)
    out = {"start": start, "losses": losses, "jumps": jumps,
           "gram_err": errs, "eval": evl, "restore_s": restore_s}
    del state, restored, tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_family(mesh, dev, arch):
    """Phase 21(f), one family: one layer at full width on the (2, 2)
    mesh against one rank on the same params and batch (each rank runs
    the one-rank reference itself), and the family's planted faults."""
    from repro_torch.core.paths import leaves_with_paths

    t0 = time.perf_counter()
    acfg = launch_train.configure(arch, steps=1, global_batch=TP_B,
                                  seq=TP_S, n_layers=1)
    model = launch_train.make_model(acfg, device=dev, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(acfg.train.seed)
    params = dict(leaves_with_paths(model.init(gen)))
    batch = next(synthetic_lm_batches(acfg.train.seed, TP_B, TP_S,
                                      acfg.model.vocab_size, device=dev))
    one = mesh_checks.one_rank(model, params, batch)
    reset_counts()
    heads = []
    with _flash_heads(heads):
        res = mesh_checks.tp_gradients(model, params, batch, mesh, one=one)
    torch.cuda.synchronize()
    lc = all_counts()
    l2 = res["grad_err_l2"]
    out = {"pad": model.pad_heads_to, "heads": sorted(set(heads)),
           "loss": res["loss"], "loss_one": one[0],
           "loss_err": abs(res["loss"] - one[0]) / abs(one[0]),
           "grad_l2": max(l2.values()), "worst": max(l2, key=l2.get),
           "grad_max": max(res["grad_err"].values()),
           "k7": lc["flash_attention"], "k7b": lc["flash_attention_bwd"],
           "wgmma": (lc["flash_attention_wgmma"],
                     lc["flash_attention_bwd_wgmma"]),
           "tp": _tp_records(res["collectives"]),
           "sites": sorted({str(c["what"]) for c in res["collectives"]
                            if c["what"] and not str(c["what"])
                            .startswith("param:")}), "faults": {}}
    del res
    for fault, fam in TP_FAULTS.items():
        if fam == arch:
            f = mesh_checks.tp_gradients(model, params, batch, mesh,
                                         fault=fault, one=one)
            out["faults"][fault] = {
                "loss_err": abs(f["loss"] - one[0]) / abs(one[0]),
                "grad_l2": max(f["grad_err_l2"].values())}
            del f
    del params, one, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def _mesh_tp_families(mesh, dev):
    return {arch: _tp_family(mesh, dev, arch) for arch in TP_FAMILIES}


def _site_bytes(rec) -> dict:
    """The activation collectives over "model" among `rec` by (kind,
    site): their bytes."""
    out: dict = {}
    for c in rec:
        if c["axes"] == ("model",) and c["what"] and not str(
                c["what"]).startswith("param:"):
            key = (c["kind"], str(c["what"]))
            out[key] = out.get(key, 0) + c["bytes"]
    return out


def _kv_sp_sites(cfg, calls, tp=2) -> dict:
    """The analytic bytes by (kind, site) of kv-SP attention calls over a
    "model" axis of `tp`, one forward and backward without remat; `calls`
    lists (query tokens, key tokens, cross) a rank computes: the input's
    gradient all-reduced ("attn"), q's column blocks all-gathered and its
    gradient all-reduced whole ("attn.q"), k's and v's likewise
    ("attn.k", "attn.v"; over the key tokens), the merge's max and its
    weighted fp32 outputs with their weights ("attn.merge.max", ".sum"),
    dO summed ("attn.merge.dout"), the output projection's partial sums
    ("attn.wo"), and cross-attention's encoder output's gradient
    ("cross.kv")."""
    p = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    H, K, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    out: dict = {}

    def add(kind, site, n):
        out[(kind, site)] = out.get((kind, site), 0) + n
    for tq, tk, cross in calls:
        add("all_reduce", "attn", tq * d * p)
        add("all_reduce", "attn.wo", tq * d * p)
        add("all_gather", "attn.q", tq * H * hd // tp * p)
        add("all_reduce", "attn.q", tq * H * hd * p)
        for site in ("attn.k", "attn.v"):
            add("all_gather", site, tk * K * hd // tp * p)
            add("all_reduce", site, tk * K * hd * p)
        add("all_reduce", "attn.merge.max", tq * H * 4)
        add("all_reduce", "attn.merge.sum", tq * H * (hd + 1) * 4)
        add("all_reduce", "attn.merge.dout", tq * H * hd * p)
        if cross:
            add("all_reduce", "cross.kv", tk * d * p)
    return out


def _kv_sp_model(arch, dev, mesh):
    """Phase 21(g)'s model of `arch` (KV_SP_CELLS) and its ArchConfig."""
    if arch == "tinyllama-1.1b":
        # the reference's --reduced launch layout at full width: head_tp
        # False, no remat
        acfg = launch_train.configure(arch, steps=1, global_batch=TP_B,
                                      seq=TP_S, n_layers=KV_SP_LAYERS)
        return launch_train.make_model(acfg, reduced=True, device=dev,
                                       mesh=mesh), acfg
    # Whisper at full depth as its config lays it out: head_tp None (8
    # heads are no multiple of 16: kv-SP), its pad_attn_heads_to 16
    acfg = launch_train.configure(arch, steps=1, global_batch=TP_B,
                                  seq=TP_S)
    return tfm.LanguageModel(
        acfg.model, head_tp=None, chunk_k=min(TP_S, 1024),
        remat=acfg.parallel.remat, device=dev,
        pad_heads_to=acfg.parallel.pad_attn_heads_to), acfg


def _kv_sp_cell(mesh, dev, arch):
    """Phase 21(g), one cell: the model in kv-SP at full width on the (2, 2)
    mesh against one rank on the same params and batch (each rank runs
    the one-rank reference itself), the collectives over "model" by site
    against ``_kv_sp_sites``, the offset launches, and on TinyLlama
    KV_SP_FAULTS."""
    t0 = time.perf_counter()
    model, acfg = _kv_sp_model(arch, dev, mesh)
    mc = acfg.model
    gen = torch.Generator(device=dev).manual_seed(acfg.train.seed)
    params = dict(leaves_with_paths(model.init(gen)))
    n_params = sum(x.numel() for x in params.values())
    batch = next(synthetic_lm_batches(acfg.train.seed, TP_B, TP_S,
                                      mc.vocab_size, device=dev,
                                      **stream_kwargs(mc)))
    one = mesh_checks.one_rank(model, params, batch)
    reset_counts()
    res = mesh_checks.tp_gradients(model, params, batch, mesh, one=one)
    torch.cuda.synchronize()
    lc = all_counts()
    rows = TP_B // mesh.axis_size("data")
    tq = rows * TP_S
    if mc.family == "encdec":
        te = rows * mc.encoder_seq_len
        calls = ([(te, te, False)] * mc.n_encoder_layers
                 + [(tq, tq, False), (tq, te, True)] * mc.n_layers)
        n_attn = mc.n_encoder_layers + 2 * mc.n_layers
    else:
        calls, n_attn = [(tq, tq, False)] * mc.n_layers, mc.n_layers
    sites = _site_bytes(res["collectives"])
    want = _kv_sp_sites(mc, calls)
    # a rank past the first holds keys at an offset in every self-attention
    # (cross-attention's blocks go in at offset 0: no position enters a
    # non-causal mask)
    n_offset = (0 if mesh.axis_index("model") == 0
                else sum(not cross for _, _, cross in calls))
    l2 = res["grad_err_l2"]
    out = {"model_index": mesh.axis_index("model"), "n_offset": n_offset,
           "head_tp": model.head_tp, "params": n_params, "n_attn": n_attn,
           "loss": res["loss"], "loss_one": one[0],
           "loss_err": abs(res["loss"] - one[0]) / abs(one[0]),
           "grad_l2": max(l2.values()), "worst": max(l2, key=l2.get),
           "grad_max": max(res["grad_err"].values()),
           "launches": {k: lc[k] for k in kf.LAUNCHES},
           "model_gathers": len(mesh_checks.model_param_gathers(
               res["collectives"])),
           "sites": {f"{k} {w}": n for (k, w), n in sorted(sites.items())},
           "sites_off": {f"{k} {w}": (sites.get((k, w)), n)
                         for (k, w), n in want.items()
                         if sites.get((k, w)) != n},
           "faults": {}}
    out["allreduce"] = sum(n for (k, _), n in sites.items()
                           if k == "all_reduce")
    del res
    for fault, cell in KV_SP_FAULTS.items():
        if cell == arch:
            f = mesh_checks.tp_gradients(model, params, batch, mesh,
                                         fault=fault, one=one)
            out["faults"][fault] = {
                "loss_err": abs(f["loss"] - one[0]) / abs(one[0]),
                "grad_l2": max(f["grad_err_l2"].values())}
            del f
    del params, one, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def _mesh_kv_sp(mesh, dev):
    return {arch: _kv_sp_cell(mesh, dev, arch) for arch in KV_SP_CELLS}


def _check_kv_sp_cells(kvs, records):
    """Phase 21(g)'s cells as every rank returned them (``_kv_sp_cell``):
    printed, then held to one rank, their analytic collectives by site,
    the offset launches through the Hopper design, and the planted
    faults; their launches into `records`."""
    for arch in KV_SP_CELLS:
        c0 = kvs[0][arch]
        print(f"mesh (g) {arch}: {c0['params']} params, head_tp "
              f"{c0['head_tp']}; loss (2, 2) {c0['loss']} one rank "
              f"{c0['loss_one']}, relative "
              f"{max(c[arch]['loss_err'] for c in kvs)}; gradient blocks "
              f"L2 {max(c[arch]['grad_l2'] for c in kvs)} (worst "
              f"{c0['worst']} on rank 0), max-abs "
              f"{max(c[arch]['grad_max'] for c in kvs)}; launches per rank "
              f"{[c[arch]['launches'] for c in kvs]}; 'model' collectives "
              f"by site on rank 0 {c0['sites']}, off the analytic "
              f"{[c[arch]['sites_off'] for c in kvs]}; all-reduce bytes "
              f"{[c[arch]['allreduce'] for c in kvs]}; "
              f"param gathers over 'model' "
              f"{[c[arch]['model_gathers'] for c in kvs]}; faults "
              f"{[c[arch]['faults'] for c in kvs]}; {c0['s']} s")
    for arch in KV_SP_CELLS:
        for c in (c_[arch] for c_ in kvs):
            lc, n = c["launches"], c["n_attn"]
            require(c["head_tp"] is False and c["model_gathers"] == 0
                    and not c["sites_off"],
                    f"mesh (g) {arch}: layout or collectives {c}")
            require(c["loss_err"] <= TP_LOSS_TOL
                    and c["grad_l2"] <= TP_GRAD_TOL,
                    f"mesh (g) {arch}: off one rank ({c})")
            require(lc["flash_attention"] == n == lc["flash_attention_bwd"]
                    and lc["flash_attention_wgmma"] == n
                    and lc["flash_attention_bwd_wgmma"] == n
                    and lc["flash_attention_offset"] == c["n_offset"]
                    == lc["flash_attention_bwd_offset"],
                    f"mesh (g) {arch}: launches {lc}, want {n} through "
                    f"wgmma, {c['n_offset']} at an offset")
            for fault, fr in c["faults"].items():
                require(fr["loss_err"] > TP_LOSS_TOL
                        or fr["grad_l2"] > TP_GRAD_TOL,
                        f"mesh (g) {arch}: {fault} within the limits")
    require(kvs[0]["whisper-base"]["params"] == WHISPER_PARAMS
            and sum(c["tinyllama-1.1b"]["launches"]["flash_attention_offset"]
                    for c in kvs) > 0
            and sorted(f for c in kvs[0].values() for f in c["faults"])
            == sorted(KV_SP_FAULTS), "mesh (g): params, offsets or faults")
    for name in ("flash_attention", "flash_attention_bwd"):
        records[name]["mesh_kv_sp_launches"] = {
            arch: [c[arch]["launches"][name] for c in kvs]
            for arch in KV_SP_CELLS}


def _mesh_gradsync(dev):
    """Phase 21(d): int8_psum_grads on a (2, 1, 2) pod mesh, the
    reference's replicated case: the largest error and the scale."""
    from repro_torch.launch.mesh import AXES, Mesh

    res = mesh_checks.int8_sync(Mesh((2, 1, 2), AXES, device=dev),
                                (2048, 256), dev)
    return {"err": float((res["same"] - res["input"]).abs().max()),
            "scale": float(res["input"].abs().max()) / 127.0,
            "wire": res["wire"]}


def mesh_rank(rank, ckpt):
    """One of phase 21's four ranks (all on the one card)."""
    from repro_torch.launch.mesh import Mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    walls, out = {}, {"rank": rank}
    mesh = Mesh((2, 2), device=dev)
    for part, fn in (("probe", lambda: _mesh_probe(mesh, dev)),
                     ("kernels", lambda: _mesh_kernels(mesh, dev)),
                     ("train", lambda: _mesh_train(mesh, dev, ckpt)),
                     ("tp families", lambda: _mesh_tp_families(mesh, dev)),
                     ("kv-sp", lambda: _mesh_kv_sp(mesh, dev)),
                     ("restore 4x1", lambda: _mesh_restore(
                         Mesh((4, 1), device=dev), dev, ckpt)),
                     ("gradsync", lambda: _mesh_gradsync(dev)),
                     ("audit", lambda: mesh_checks.mesh_audit((2, 2), dev))):
        t0 = time.perf_counter()
        out[part] = fn()
        walls[part] = time.perf_counter() - t0
    out["walls"] = walls
    return out


def run_mesh_phase(dev, records):
    """Phase 21: the mesh. The kernels are built (phase 2) before the four
    ranks start, so that they do not race on its build directory; a rank
    that fails fails the phase."""
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    acfg = _mesh_acfg()
    # the one-rank run the mesh is held to, on the card, eager; and the
    # planted fault the comparison must catch: the same run on the first
    # half of every batch (what a data rank would train on if the batch
    # axes' gradient sum were lost)
    base = _mesh_one_rank(acfg, dev)
    half = _mesh_one_rank(acfg, dev, rows=MESH_B // 2)
    # a control: one rank summing two half-batch gradients (two
    # microbatches), another order of the same sums
    accum = _mesh_one_rank(dataclasses.replace(
        acfg, parallel=dataclasses.replace(acfg.parallel, grad_accum=2)),
        dev)
    t_one = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as d:
        ckpt = os.path.join(d, "ckpt")
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_rank, MESH_RANKS, ckpt, backend="gloo",
                          join_timeout=900, threads=2, tmp_dir=d)
        t_ranks = time.perf_counter() - t0
        one = _mesh_restore(None, dev, ckpt)
    r0 = ranks[0]
    tr_ = [r["train"] for r in ranks]
    b = tr_[0]
    init = base.pop("init")
    p_errs = _param_errs(b.pop("final"), base["final"], init, dev)
    fault = {"half batch": _param_errs(half["final"], base["final"], init,
                                       dev),
             "no update": _param_errs(init, base["final"], init, dev)}
    control = _param_errs(accum["final"], base["final"], init, dev)
    del init, half, base["final"], accum["final"]
    # every number first, then the checks
    print(f"mesh: ranks' walls by part {[r['walls'] for r in ranks]}; "
          f"one-rank runs {t_one} s, ranks {t_ranks} s")
    for case, res in r0["kernels"].items():
        print(f"mesh (a) {case}: Grams vs one rank {res['gram_err']}, K3/K6 "
              f"vs one rank {res['k3_err']}, K2/K5 per block equal "
              f"{res['k2_equal']}, integer exact {res['exact']}, record "
              f"all-reduces only {res['allreduce_only']} "
              f"({res['record_bytes']} B), twins "
              f"{res.get('bucket_twin_err')}")
        for key, t in res.get("times", {}).items():
            print(f"mesh (a) {case} bucket {key} {t}")
    errs = _loss_errs(b["losses"], base["losses"], base["jumps"])
    p_max = max(e for e, _ in p_errs.values())
    f_max = {k: max(e for e, _ in v.values()) for k, v in fault.items()}
    print(f"mesh (b) losses (2, 2) {b['losses']}\nmesh (b) losses one rank "
          f"{base['losses']}\nmesh (b) relative: up to the jump {errs[0]}, "
          f"after it {errs[1]}; jumps {b['jumps']} vs {base['jumps']}; "
          f"held-out loss {b['eval']} vs {base['eval']}")
    print(f"mesh (b) final params vs one rank, by leaf (L2 over the leaf's "
          f"L2 move, max-abs relative): {p_errs}; largest {p_max} "
          f"(limit {MESH_PARAM_TOL}); the planted faults score {f_max}; "
          f"one rank with two microbatches (a control, not held) scores "
          f"{max(e for e, _ in control.values())}, its losses "
          f"{_loss_errs(accum['losses'], base['losses'], base['jumps'])}")
    print(f"mesh (b) c: {len(b['c_after'])} broadcasts, the same bits on "
          f"all ranks {all(r['c_after'] == b['c_after'] for r in tr_)}; "
          f"before the broadcast equal "
          f"{all(r['c_before'] == b['c_before'] for r in tr_)}")
    print(f"mesh (b) launches per rank {[r['launches'] for r in tr_]} "
          f"(one rank: {base['launches']})")
    print(f"mesh (b) record_update collectives {b['record']}, analytic "
          f"{b['analytic']} B; buckets {b['buckets']}")
    print(f"mesh (b) ms a step (2, 2) rank 0 {b['ms']} (fit {b['fit_s']} s, "
          f"save {b['save_s']} s; before tensor-parallel compute, on an "
          f"H100 80GB HBM3 at 700 W: 1,431-3,398 ms)\nmesh (b) ms a step one rank "
          f"{base['ms']}\nmesh (b) peak bytes per rank "
          f"{[r['peak'] for r in tr_]} (before tensor-parallel compute: "
          f"3,898,582,016 B); all-reduce "
          f"ms {b['allreduce_ms']}")
    print(f"mesh (b) tensor-parallel: K7 heads per rank "
          f"{[r['heads'] for r in tr_]} (want {MESH_HEADS}); K7 / K7b "
          f"launches {[(r['launches']['flash_attention'], r['launches']['flash_attention_bwd']) for r in tr_]}, "
          f"wgmma {[tuple(r['wgmma'].values()) for r in tr_]}; activation "
          f"all-reduces over 'model' {[r['tp']['bytes'] for r in tr_]} B "
          f"against {b['tp_analytic']} B analytic, other "
          f"{b['tp']['other']}; param blocks all-gathered over 'model' "
          f"{[r['tp']['model_gathers'] for r in tr_]}")
    fams = [r["tp families"] for r in ranks]
    for arch in TP_FAMILIES:
        f0 = fams[0][arch]
        print(f"mesh (f) {arch}: heads padded to {f0['pad']}, K7 heads "
              f"{f0['heads']}; loss (2, 2) {f0['loss']} one rank "
              f"{f0['loss_one']}, relative "
              f"{max(f[arch]['loss_err'] for f in fams)}; gradient blocks "
              f"L2 {max(f[arch]['grad_l2'] for f in fams)} (worst "
              f"{f0['worst']} on rank 0), max-abs "
              f"{max(f[arch]['grad_max'] for f in fams)}; K7 / K7b per rank "
              f"{[(f[arch]['k7'], f[arch]['k7b'], f[arch]['wgmma']) for f in fams]}; "
              f"'model' all-reduce bytes {[f[arch]['tp']['bytes'] for f in fams]}, "
              f"moves {f0['tp']['other']}, param gathers over 'model' "
              f"{[f[arch]['tp']['model_gathers'] for f in fams]}; faults "
              f"{[f[arch]['faults'] for f in fams]}; {f0['s']} s")
    print(f"mesh (f) limits: loss {TP_LOSS_TOL}, gradient blocks "
          f"{TP_GRAD_TOL}")
    restores = (("(4, 1)", r0["restore 4x1"]), ("one rank", one))
    for name, res in restores:
        res["err"] = _loss_errs(res["losses"], b["losses"][res["start"]:],
                                [j - res["start"] for j in res["jumps"]])
        print(f"mesh (c) {name}: restored at {res['start']} in "
              f"{res['restore_s']} s, losses {res['losses']}, relative to "
              f"(b) {res['err']}, jumps {res['jumps']}, Grams vs K3 "
              f"{res['gram_err']}, held-out {res['eval']}")
    print(f"mesh (d) int8 pod sync: error {r0['gradsync']['err']}, scale "
          f"{r0['gradsync']['scale']}, wire {r0['gradsync']['wire']}")
    print(f"mesh (e) audit --mesh 2x2: {[r['audit'] for r in ranks]}")
    # (a)
    for case, res in r0["kernels"].items():
        require(res["gram_err"] <= RTOL and res["k3_err"] <= RTOL,
                f"mesh (a) {case}: Grams off ({res})")
        require(res["k2_equal"] and res["allreduce_only"],
                f"mesh (a) {case}: {res}")
        require(res.get("bucket_twin_err", 0.0) <= RTOL,
                f"mesh (a) {case}: twin off ({res})")
        if case.endswith("integer"):
            require(res["exact"], f"mesh (a) {case}: not bit-exact")
    # (b)
    require(b["jumps"] == base["jumps"] and b["jumps"],
            f"mesh (b): jumps {b['jumps']} vs {base['jumps']}")
    require(errs[0] <= MESH_LOSS_TOL[0] and errs[1] <= MESH_LOSS_TOL[1],
            f"mesh (b): losses off the one-rank run by {errs}")
    require(abs(b["eval"] - base["eval"])
            <= MESH_LOSS_TOL[1] * abs(base["eval"]),
            f"mesh (b): held-out loss {b['eval']} vs {base['eval']}")
    require(p_max <= MESH_PARAM_TOL,
            f"mesh (b): final params off the one-rank run by {p_errs}")
    require(min(f_max.values()) > MESH_PARAM_TOL,
            f"mesh (b): the params check misses a planted fault ({f_max})")
    require(all(r["c_after"] == b["c_after"] for r in tr_)
            and all(r["c_before"] == b["c_before"] for r in tr_)
            and len(b["c_after"]) == len(b["jumps"]),
            "mesh (b): the coefficients differ between ranks")
    for r in tr_:
        require(r["losses"] == b["losses"], "mesh (b): ranks' losses differ")
        lc = r["launches"]
        n = MESH_LAYERS * MESH_STEPS
        require(lc["gram_row"] > 0 and lc["combine"] > 0
                and lc["flash_attention"] == n
                and lc["flash_attention_bwd"] == n
                and r["wgmma"]["flash_attention_wgmma"] == n
                and r["wgmma"]["flash_attention_bwd_wgmma"] == n,
                f"mesh (b) launches {lc}, wgmma {r['wgmma']}")
        require(r["heads"] == [MESH_HEADS], f"mesh (b) K7 heads "
                f"{r['heads']}, want {MESH_HEADS}")
        require(r["tp"]["model_gathers"] == 0 and not r["tp"]["other"]
                and r["tp"]["bytes"] == r["tp_analytic"],
                f"mesh (b) tensor-parallel collectives {r['tp']}, "
                f"analytic {r['tp_analytic']} B")
    require(all(kind == "all_reduce" for kind, _ in b["record"])
            and sum(n for _, n in b["record"]) == b["analytic"],
            f"mesh (b) record_update collectives {b['record']}, analytic "
            f"{b['analytic']} B")
    # (c)
    for name, res in restores:
        require(res["start"] == MESH_SAVE and res["jumps"] == [
            j for j in b["jumps"] if j >= MESH_SAVE], f"mesh (c) {name}")
        require(res["err"][0] <= MESH_LOSS_TOL[0]
                and res["err"][1] <= MESH_LOSS_TOL[1],
                f"mesh (c) {name}: losses off (b) by {res['err']}")
        require(res["gram_err"] and max(res["gram_err"].values())
                <= MESH_GRAM_TOL, f"mesh (c) {name}: {res['gram_err']}")
    # (d), (e)
    for r in ranks:
        gs, a = r["gradsync"], r["audit"]
        require(gs["err"] <= gs["scale"] * 1.01
                and gs["wire"] == [("all_reduce", "int32", ("pod",))],
                f"mesh (d): {gs}")
        require(a["clean"]["failed"] == []
                and a["clean"]["record"] == {
                    "all_reduce": [1, a["clean"]["analytic"]]}
                and a["clean"]["model_gathers"] == 0
                and a["force-allgather"]["failed"] == ["collective-budget"]
                and a["force-gather-model"]["failed"]
                == ["collective-budget"]
                and a["force-gather-model"]["model_gathers"] > 0
                and a["clean"]["merges"] > 0,
                f"mesh (e) rank {r['rank']}: {a}")
    # (f)
    for arch in TP_FAMILIES:
        for f in fams:
            res = f[arch]
            require(res["tp"]["model_gathers"] == 0,
                    f"mesh (f) {arch}: param blocks gathered over 'model'")
            if arch in TP_ATTENTION:
                require(res["k7"] > 0 and res["k7b"] > 0
                        and res["wgmma"] == (res["k7"], res["k7b"]),
                        f"mesh (f) {arch}: K7 / K7b {res}")
            require(res["loss_err"] <= TP_LOSS_TOL
                    and res["grad_l2"] <= TP_GRAD_TOL,
                    f"mesh (f) {arch}: off one rank ({res})")
            for fault, fr in res["faults"].items():
                require(fr["loss_err"] > TP_LOSS_TOL
                        or fr["grad_l2"] > TP_GRAD_TOL,
                        f"mesh (f) {arch}: {fault} within the limits")
    require(sorted(f for r in fams[0].values() for f in r["faults"])
            == sorted(TP_FAULTS), "mesh (f): a planted fault did not run")
    # (g)
    _check_kv_sp_cells([r["kv-sp"] for r in ranks], records)
    for name in ("gram_row", "combine", "flash_attention",
                 "flash_attention_bwd"):
        records[name]["mesh_launches"] = [r["launches"][name] for r in tr_]
    for case, res in r0["kernels"].items():
        for key, t in res.get("times", {}).items():
            for name, col in (("gram_row", "K1_ms"), ("gram", "K3_ms"),
                              ("combine", "K2_ms"),
                              ("flat_gram_row", "K4_ms"),
                              ("flat_gram", "K6_ms"),
                              ("flat_combine", "K5_ms")):
                if col in t:
                    records[name].setdefault("mesh_shard_ms", {})[
                        f"{case} {key}"] = t[col]
    records["gram_row"]["mesh_allreduce_ms"] = b["allreduce_ms"]
    # K7 and K7b at the ranks' shapes, the card to themselves
    for tag, case in TP_K7_CASES.items():
        records["flash_attention"][tag] = time_flash(case, dev)
        records["flash_attention_bwd"][tag] = time_flash_bwd(case, dev)
        require(records["flash_attention_bwd"][tag]["row_err"]
                <= BWD_ROW_TOL[torch.bfloat16], f"mesh K7b {tag}: "
                f"{records['flash_attention_bwd'][tag]}")
    check_kv_sp_kernels(dev, records)
    print(f"mesh: phase 21 wall {time.perf_counter() - t_phase} s")


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
    moe_launches = run_moe(dev, records)
    records["flash_attention"]["moe_launches"] = {
        k: v["flash_attention"] for k, v in moe_launches.items()}
    records["flash_attention_bwd"]["moe_launches"] = \
        moe_launches["train"]["flash_attention_bwd"]
    records["gram_row"]["moe_launches"] = moe_launches["train"]["gram_row"]
    records["combine"]["moe_launches"] = moe_launches["train"]["combine"]
    ssm_launches = run_ssm(dev, records)
    for name in ("flash_attention", "flash_attention_bwd", "gram_row",
                 "combine"):
        records[name]["ssm_launches"] = {
            arch: run[name] for arch, run in ssm_launches["train"].items()}
    records["flash_attention"]["ssm_generate_launches"] = \
        ssm_launches["generate"]
    print(f"ssm summary {json.dumps(records.pop('ssm'))}")
    dense_launches = run_dense(dev, records)
    for name in ("flash_attention", "flash_attention_bwd", "gram_row",
                 "combine"):
        records[name]["dense_launches"] = {
            arch: run[name] for arch, run in dense_launches["train"].items()}
    records["flash_attention"]["dense_serve_launches"] = {
        arch: run["flash_attention"]
        for arch, run in dense_launches["serve"].items()}
    print(f"dense summary {json.dumps(records.pop('dense'))}")
    vlm_launches = run_vlm_encdec(dev, records)
    for name in ("flash_attention", "flash_attention_bwd", "gram_row",
                 "combine"):
        records[name]["vlm_encdec_launches"] = {
            arch: run[name] for arch, run in vlm_launches["train"].items()}
    print(f"vlm-encdec summary {json.dumps(records.pop('vlm_encdec'))}")
    gc.collect()
    torch.cuda.empty_cache()
    run_audit_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    run_mesh_phase(dev, records)

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
