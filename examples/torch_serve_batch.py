"""Continuous-batching serving demo on the PyTorch port: a mixed-length
request stream with a live weight hot-swap mid-flight.

    PYTHONPATH=src python examples/torch_serve_batch.py [--requests 10]
        [--new-tokens 8] [--swap] [--device cuda]

Drives ``repro_torch.serve.ServeEngine`` on a reduced TinyLlama (2 layers,
d 64, vocab 256, random weights from a seeded generator): prompts are
packed into padded prompt/batch buckets, decode runs over slot-stacked KV
caches. ``--swap`` publishes the weights scaled by 1.001 through a
``WeightsChannel`` (the checkpoint files the trainer's publish hook
writes) once two requests have completed, and the engine polls it: the
report shows which weight version each request started and finished on.
Runs on the card unless ``--device cpu`` (and raises without one).
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.paths import tree_map
from repro_torch.models.transformer import LanguageModel
from repro_torch.serve import ServeConfig, ServeEngine, WeightsChannel


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--swap", action="store_true",
                    help="hot-swap perturbed weights mid-stream via a "
                         "WeightsChannel publish")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mc = reduced(get_config("tinyllama-1.1b").model, n_layers=2, d_model=64,
                 d_ff=128, vocab_size=256, n_heads=2, n_kv_heads=2,
                 head_dim=32)
    model = LanguageModel(mc, chunk_k=16, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = model.init(gen)
    cfg = ServeConfig(n_slots=4, prompt_buckets=(8, 16), batch_buckets=(1, 2),
                      max_new_tokens=args.new_tokens)
    engine = ServeEngine(model, params, cfg)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        n = int(rng.integers(2, cfg.prompt_buckets[-1] + 1))
        engine.submit(rng.integers(1, mc.vocab_size, size=(n,)).tolist())

    done = []
    t0 = time.perf_counter()
    if args.swap:
        with tempfile.TemporaryDirectory() as root:
            channel = WeightsChannel(root)
            bumped = tree_map(lambda t: t * 1.001, params)
            swapped = False
            while engine.queue_len or engine.active_slots:
                done.extend(engine.step())
                if not swapped and engine.stats["completed"] >= 2:
                    # trainer side: publish; server side: poll + swap
                    channel.publish(bumped, version=100)
                    channel.poll(engine, params)
                    swapped = True
    else:
        done = engine.run_until_drained()
    engine.sync()
    wall = time.perf_counter() - t0

    s = engine.stats
    print(f"arch=tinyllama-1.1b (reduced) slots={cfg.n_slots} on "
          f"{engine.device}")
    print(f"{len(done)} requests, {s['tokens_emitted']} tokens in "
          f"{wall * 1e3:.0f} ms -> "
          f"{s['tokens_emitted'] / max(wall, 1e-9):.0f} tok/s")
    print(f"prefills={s['prefill_dispatches']} "
          f"decodes={s['decode_dispatches']} swaps={s['swaps']} "
          f"dropped={s['dropped']}")
    for r in sorted(done, key=lambda r: r.uid)[:4]:
        print(f"  req{r.uid} prompt={r.prompt_len} "
              f"v{r.version_start}->v{r.version_end}: {r.tokens}")
    return done


if __name__ == "__main__":
    main()
