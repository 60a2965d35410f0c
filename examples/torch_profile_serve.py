"""Where the port's TinyLlama server spends its time, on a CUDA card.

    PYTHONPATH=src python examples/torch_profile_serve.py [--requests 12]
        [--new-tokens 16] [--top 15]

Serves the launcher's request stream (``repro_torch.launch.serve``) at
TinyLlama-1.1B's full width three times, each on a fresh engine: a warm-up
(kernel build, cuBLAS start-up), one timed run (host clock, synchronised)
and one under ``torch.profiler``. Prints tokens/s, the device's busy share
of the profiled wall (summed kernel time over wall: one stream, so kernels
do not overlap), the flash-attention kernel's share of device time, and
the kernels that take the most device time.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.launch import serve as launch_serve  # noqa: E402

sys.path.insert(0, "examples")
from torch_profile_step import device_us  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    model, params, _ = launch_serve.build("tinyllama-1.1b",
                                          new_tokens=args.new_tokens)
    prompts = launch_serve.request_stream(args.requests,
                                          model.cfg.vocab_size)

    def run():
        # a fresh engine each time, on the same weights
        engine = launch_serve.make_engine(model, params,
                                          new_tokens=args.new_tokens)
        _, steps, wall = launch_serve.serve(engine, prompts)
        return engine.stats["tokens_emitted"], steps, wall

    run()                                           # warm-up
    tokens, steps, wall = run()
    print(f"{torch.cuda.get_device_name(0)}: {tokens} tokens, {steps} steps "
          f"in {wall} s: tokens/s {tokens / wall}, ms/step "
          f"{wall / steps * 1e3}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, pwall = run()
    rows = [(device_us(e), e.count, e.key) for e in prof.key_averages()]
    rows = [r for r in rows if r[0] > 0]
    if not rows:
        print("no device time in the trace")
        return
    busy_us = sum(r[0] for r in rows)
    flash = sum(r[0] for r in rows if "flash_bf16" in r[2])
    print(f"profiled: wall {pwall} s, device kernel time {busy_us / 1e6} s, "
          f"busy share {busy_us / 1e6 / pwall}, idle share "
          f"{1 - busy_us / 1e6 / pwall}; K7 {flash / 1e6} s "
          f"({flash / busy_us} of kernel time); kernel launches "
          f"{sum(r[1] for r in rows)} ({sum(r[1] for r in rows) / steps} "
          f"per step)")
    print("top kernels by device time (us total, launches, share, name):")
    for us, count, key in sorted(rows, reverse=True)[:args.top]:
        print(f"  {us:12.1f} {count:6d} {us / busy_us:7.3f}  {key[:90]}")


if __name__ == "__main__":
    main()
