"""How deep an LM trains on one card: the launcher's ``run`` at the
config's full widths (bf16, the config's DMD and optimizer, grad_accum,
remat, CUDA graphs, 8 x 4096 tokens a step) for the steps that reach the
first DMD jump, at each depth given; prints the peak allocated and
reserved bytes, or the out-of-memory error.

    PYTHONPATH=src python examples/torch_lm_depth.py 16 15 14 [--steps 49]
        [--arch tinyllama-1.1b] [--warmup N] [--global-batch 8] [--accum N]

``--warmup N`` sets the DMD warm-up (default: the launcher's, a quarter of
96 steps), so that a shorter run reaches the first jump. ``--arch`` takes
every config the launcher trains: ``tinyllama-1.1b``, ``qwen3-moe-30b-a3b``,
``mamba2-2.7b``, ``zamba2-2.7b``, ``minicpm-2b``, ``granite-20b``,
``gemma3-27b``, ``qwen2-vl-7b`` and ``whisper-base`` (the steps through
the first jump follow the config's m: 14, 10 for qwen2-vl, or 8 for
qwen3, granite and gemma). ``--global-batch`` (sequences a step) and
``--accum`` (microbatches a step; default the config's grad_accum) size
the microbatch: ``--arch whisper-base --accum 2 --global-batch 64 6``
trains its 6 layers on 32 sequences (and their frames) a microbatch.

Needs a CUDA card. `chip_smoke.py` phase 15 trains at the deepest of
these that stays under ~90% of the card (PERF.md §4).
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.launch import train as launch_train


def probe(arch: str, n_layers: int, steps: int, warmup, dev,
          global_batch: int = 8, accum: int = 0) -> dict:
    """One run at `n_layers`: its peak bytes and seconds, or the OOM."""
    acfg = launch_train.configure(arch, steps=96, global_batch=global_batch,
                                  seq=4096, n_layers=n_layers)
    if warmup is not None:
        acfg = dataclasses.replace(acfg, dmd=dataclasses.replace(
            acfg.dmd, warmup_steps=warmup))
    if accum:
        acfg = dataclasses.replace(acfg, parallel=dataclasses.replace(
            acfg.parallel, grad_accum=accum))
    model = launch_train.make_model(acfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        trainer, state = launch_train.run(acfg, model, steps=steps,
                                          log_every=0)
        torch.cuda.synchronize()
        out = dict(peak=torch.cuda.max_memory_allocated(dev),
                   reserved=torch.cuda.max_memory_reserved(dev),
                   seconds=time.perf_counter() - t0)
        del trainer, state
    except torch.cuda.OutOfMemoryError as err:   # the answer, not a fault
        out = dict(oom=str(err).splitlines()[0])
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("layers", type=int, nargs="+")
    ap.add_argument("--steps", type=int, default=49,
                    help="steps to run (49: through the first jump at 47)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=0,
                    help="microbatches a step (0: the config's grad_accum)")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    total = torch.cuda.get_device_properties(dev).total_memory
    for n in args.layers:
        res = probe(args.arch, n, args.steps, args.warmup, dev,
                    args.global_batch, args.accum)
        share = res["peak"] / total if "peak" in res else None
        print(f"depth {n}: {res}, card {total} bytes, peak share {share}",
              flush=True)


if __name__ == "__main__":
    main()
