"""Quickstart on the PyTorch port: DMD-accelerated training of a tiny LM
on synthetic tokens.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps N]
        [--device cuda]

The reference's ``examples/quickstart.py`` on the port's Trainer and token
stream: the same reduced TinyLlama (4 layers, d 128, 4 heads of 32, 2 kv
heads, vocab 512), trained twice at equal optimizer-step budget, plain
Adam against Adam + DMD extrapolation (m 8, s 24, warm-up 40, cool-down
6), and both loss curves printed. `--steps` shrinks the run. Runs on the
card unless ``--device cpu`` (and raises without one).
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import DMDConfig, OptimizerConfig, TrainConfig
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.models.transformer import LanguageModel
from repro_torch.train import Trainer


def build(dmd_enabled: bool, device):
    acfg = get_config("tinyllama-1.1b")
    mc = reduced(acfg.model, n_layers=4, d_model=128, d_ff=256,
                 vocab_size=512, n_heads=4, n_kv_heads=2, head_dim=32)
    acfg = dataclasses.replace(
        acfg, model=mc,
        dmd=DMDConfig(enabled=dmd_enabled, m=8, s=24, tol=1e-4,
                      warmup_steps=40, cooldown_steps=6),
        optimizer=OptimizerConfig(name="adam", lr=1e-3, schedule="constant"),
        parallel=dataclasses.replace(acfg.parallel, grad_accum=1,
                                     remat="none"),
        train=TrainConfig(global_batch=8, seq_len=64))
    model = LanguageModel(mc, chunk_k=64, device=device)
    return Trainer(model, acfg, device=device), mc


def run(dmd_enabled: bool, steps: int = 200, device="cuda"):
    trainer, mc = build(dmd_enabled, device)
    batches = synthetic_lm_batches(0, 8, 64, mc.vocab_size,
                                   device=trainer.device)
    losses = []
    t0 = time.time()
    trainer.fit(batches, steps=steps,
                state=trainer.init_state(key=torch.Generator(
                    device=trainer.device).manual_seed(0)),
                on_metrics=lambda s, m: losses.append(float(m["loss"])))
    return losses, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    base, t_base = run(False, steps=args.steps, device=args.device)
    dmd, t_dmd = run(True, steps=args.steps, device=args.device)
    print(f"\n{'step':>6} {'baseline':>10} {'dmd':>10}")
    for s in range(0, len(base), 25):
        print(f"{s:>6} {base[s]:>10.4f} {dmd[s]:>10.4f}")
    print(f"final  {base[-1]:>10.4f} {dmd[-1]:>10.4f}")
    print(f"\nwall on {args.device}: baseline {t_base:.1f}s, dmd "
          f"{t_dmd:.1f}s (overhead {t_dmd / t_base:.2f}x)")
    return base, dmd


if __name__ == "__main__":
    main()
