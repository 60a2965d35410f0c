"""How deep TinyLlama-1.1B trains on one card: the launcher's ``run`` at
the config's full widths (bf16, the config's DMD and optimizer,
grad_accum 4, remat, CUDA graphs, 8 x 4096 tokens a step) for the steps
that reach the first DMD jump, at each depth given; prints the peak
allocated and reserved bytes, or the out-of-memory error.

    PYTHONPATH=src python examples/torch_lm_depth.py 16 15 14 [--steps 49]

Needs a CUDA card. `chip_smoke.py` phase 15 trains at the deepest of
these that stays under ~90% of the card (PERF.md §4).
"""
import argparse
import time

import torch

from repro_torch.launch import train as launch_train


def probe(n_layers: int, steps: int, dev) -> dict:
    """One run at `n_layers`: its peak bytes and seconds, or the OOM."""
    acfg = launch_train.configure("tinyllama-1.1b", steps=96, global_batch=8,
                                  seq=4096, n_layers=n_layers)
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
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    total = torch.cuda.get_device_properties(dev).total_memory
    for n in args.layers:
        res = probe(n, args.steps, dev)
        share = res["peak"] / total if "peak" in res else None
        print(f"depth {n}: {res}, card {total} bytes, peak share {share}",
              flush=True)


if __name__ == "__main__":
    main()
