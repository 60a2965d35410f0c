"""Serving launcher: a thin CLI over the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        [--reduced] [--requests 12] [--new-tokens 16] [--slots 8] \\
        [--sampling greedy|topk] [--swap-every N] [--layers N] \\
        [--device cuda]

Serves the dense family (``tinyllama-1.1b``, ``minicpm-2b``,
``granite-20b`` at its full 52 layers, 20.3B params, 40.6 GB in bf16)
and the MoE family (``qwen3-moe-30b-a3b`` at its full 48 layers, 30.5B
params; ``llama4-maverick-400b-a17b``, whose 400B params need
``--layers``). ``gemma3-27b``'s ring caches are refused by the engine, as
the reference's refuses them: it generates through
``LanguageModel.prefill`` / ``decode_step``.
Serves randomly initialised weights at the architecture's widths (drawn
on the device from a generator seeded with 0) to the reference launcher's
request stream: numpy ``default_rng(0)``, prompt lengths 4 to 64, prompt
buckets (16, 64), batch buckets (1, 4). ``--swap-every N`` hot-swaps
weights scaled by 1.001 every N engine steps (a swap stages a second
copy of the weights). The engine serves the drawn tensors themselves
(one copy on the card). ``--layers N`` cuts the depth. Runs on
the card unless ``--device cpu`` (and raises without one).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core.paths import tree_map
from repro_torch.kernels.device import resolve_device
from repro_torch.models.transformer import LanguageModel
from repro_torch.serve import Result, ServeConfig, ServeEngine

PROMPT_BUCKETS = (16, 64)
BATCH_BUCKETS = (1, 4)


def request_stream(n_requests: int, vocab_size: int) -> List[List[int]]:
    """The reference launcher's prompts: numpy default_rng(0), lengths
    4 to max(PROMPT_BUCKETS), tokens 1 to vocab_size - 1."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_requests):
        n = int(rng.integers(4, PROMPT_BUCKETS[-1] + 1))
        out.append(rng.integers(1, vocab_size, size=(n,)).tolist())
    return out


def build(arch: str, *, use_reduced: bool = False, slots: int = 8,
          new_tokens: int = 16, sampling: str = "greedy", device="cuda",
          n_layers: int = 0) -> Tuple[LanguageModel, dict, ServeEngine]:
    """The model, its seeded random params and an engine serving those
    very tensors (the weights exist once on the device).
    `n_layers` > 0 cuts the depth."""
    model, params = model_and_params(arch, use_reduced=use_reduced,
                                     device=device, n_layers=n_layers)
    return model, params, make_engine(model, params, slots=slots,
                                      new_tokens=new_tokens,
                                      sampling=sampling)


def model_and_params(arch: str, *, use_reduced: bool = False, device="cuda",
                     n_layers: int = 0) -> Tuple[LanguageModel, dict]:
    """``build``'s model and seeded random params, without the engine: how
    the models the engine refuses (ring caches, SSM states, M-RoPE
    streams, the enc-dec family) generate through ``prefill`` /
    ``decode_step``."""
    device = resolve_device(device)
    acfg = get_config(arch)
    mc = reduce_cfg(acfg.model) if use_reduced else acfg.model
    if n_layers:
        mc = dataclasses.replace(mc, n_layers=n_layers)
    model = LanguageModel(mc, head_tp=not use_reduced, chunk_k=64,
                          device=device)
    return model, model.init(torch.Generator(device=device).manual_seed(0))


def make_engine(model: LanguageModel, params: dict, *, slots: int = 8,
                new_tokens: int = 16, sampling: str = "greedy"
                ) -> ServeEngine:
    """An engine with the launcher's buckets serving `params` themselves
    (the caller must not change them)."""
    cfg = ServeConfig(n_slots=slots, prompt_buckets=PROMPT_BUCKETS,
                      batch_buckets=BATCH_BUCKETS, sampling=sampling,
                      max_new_tokens=new_tokens, adopt="step")
    return ServeEngine(model, params, cfg)


def serve(engine: ServeEngine, prompts: List[List[int]],
          swap_every: int = 0, swap_params: Optional[dict] = None
          ) -> Tuple[List[Result], int, float]:
    """Submit every prompt, step until drained (swapping in `swap_params`
    every `swap_every` steps), wait for the device. Returns the results,
    the engine steps and the wall seconds."""
    for p in prompts:
        engine.submit(p)
    done: List[Result] = []
    steps = 0
    t0 = time.perf_counter()
    while engine.queue_len or engine.active_slots:
        done.extend(engine.step())
        steps += 1
        if swap_every and steps % swap_every == 0:
            engine.swap_weights(swap_params)
    engine.sync()
    return done, steps, time.perf_counter() - t0


def exact_greedy(model: LanguageModel, params: dict, prompt: List[int],
                 n_new: int) -> Tuple[List[int], torch.Tensor]:
    """The pre-engine serving loop: exact-length prefill into a cache of
    len(prompt) + n_new, then greedy decode one token at a time. Returns
    the tokens and the logits the first one was drawn from."""
    caches = model.init_cache(1, len(prompt) + n_new)
    toks = torch.tensor([prompt], dtype=torch.long, device=model.device)
    logits, caches = model.prefill(params, {"tokens": toks}, caches)
    first = logits[0, -1]
    out = []
    for _ in range(n_new):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(int(tok[0, 0]))
        logits, caches = model.decode_step(params, {"tokens": tok}, caches)
    return out, first


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--sampling", choices=("greedy", "topk"),
                    default="greedy")
    ap.add_argument("--swap-every", type=int, default=0,
                    help="hot-swap perturbed weights every N engine steps "
                         "(0 = frozen server)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model, params, engine = build(
        args.arch, use_reduced=args.reduced, slots=args.slots,
        new_tokens=args.new_tokens, sampling=args.sampling,
        device=args.device, n_layers=args.layers)
    prompts = request_stream(args.requests, model.cfg.vocab_size)
    swap = tree_map(lambda t: t * 1.001, params) if args.swap_every else None
    done, steps, wall = serve(engine, prompts, args.swap_every, swap)
    s = engine.stats
    print(f"{len(done)} requests, {s['tokens_emitted']} tokens in "
          f"{wall * 1e3:.0f}ms -> {s['tokens_emitted'] / max(wall, 1e-9):.0f}"
          f" tok/s | steps={steps} prefills={s['prefill_dispatches']} "
          f"swaps={s['swaps']} dropped={s['dropped']} on {engine.device}")
    first = min(done, key=lambda r: r.uid)
    print(f"ids[{first.uid}] v{first.version_start}->{first.version_end}: "
          f"{first.tokens}")
    return done


if __name__ == "__main__":
    main()
