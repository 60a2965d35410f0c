"""End-to-end LM training on the PyTorch port: Trainer loop + DMD
acceleration + checkpoint/resume + deterministic data.

    PYTHONPATH=src python examples/torch_lm_train.py [--steps 150] [--dmd]
        [--ckpt /tmp/lm_ckpt] [--arch tinyllama-1.1b] [--width 256]
        [--layers 6] [--batch 8] [--seq 128] [--device cuda]

The reference's ``examples/lm_train.py`` on the port's Trainer and token
stream, with its sizes and flags: a depth/width-reduced variant of the
arch (same family; d --width, d_ff 4x, heads of 64, vocab 2048), adamw
6e-4 with clip 1.0 and the cosine schedule, DMD (m 8, s 24, fp32
snapshots) with ``--dmd``, a checkpoint every 50 steps into ``--ckpt``
(two kept). Kill it mid-run and rerun with the same ``--ckpt``: it
resumes bit-exactly. Runs on the card unless ``--device cpu`` (and raises
without one); ``launch/train.py`` runs the arch's own config.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import DMDConfig, OptimizerConfig, TrainConfig
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.models.transformer import LanguageModel, init_params
from repro_torch.train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--dmd", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    acfg = get_config(args.arch)
    mc = reduced(acfg.model, n_layers=args.layers, d_model=args.width,
                 d_ff=args.width * 4, vocab_size=2048,
                 n_heads=max(args.width // 64, 1),
                 n_kv_heads=max(args.width // 128, 1), head_dim=64)
    acfg = dataclasses.replace(
        acfg, model=mc,
        dmd=DMDConfig(enabled=args.dmd, m=8, s=24, tol=1e-4,
                      warmup_steps=40, cooldown_steps=6,
                      snapshot_dtype="float32"),
        optimizer=OptimizerConfig(name="adamw", lr=6e-4, weight_decay=0.1,
                                  grad_clip=1.0, schedule="cosine",
                                  warmup_steps=20, total_steps=args.steps),
        parallel=dataclasses.replace(acfg.parallel, grad_accum=1,
                                     remat="none"),
        train=TrainConfig(global_batch=args.batch, seq_len=args.seq,
                          checkpoint_every=50, checkpoint_dir=args.ckpt,
                          keep_checkpoints=2))

    model = LanguageModel(mc, chunk_k=min(args.seq, 512), device=args.device)
    n_params = model.param_count(init_params(mc, device="meta"))
    print(f"{args.arch} (reduced): {n_params / 1e6:.1f}M params, "
          f"dmd={'on' if args.dmd else 'off'}, device {model.device}")

    trainer = Trainer(model, acfg, checkpoint_dir=args.ckpt or None,
                      device=model.device)
    start = (latest_step(args.ckpt) or 0) if args.ckpt else 0
    if start:
        print(f"resuming from checkpoint at step {start}")
    batches = synthetic_lm_batches(0, args.batch, args.seq, mc.vocab_size,
                                   start_step=start, device=model.device)
    losses = []
    t0 = time.time()
    trainer.fit(batches, steps=args.steps, log_every=10,
                state=trainer.init_state(key=torch.Generator(
                    device=model.device).manual_seed(acfg.train.seed)),
                on_metrics=lambda s, m: losses.append(float(m["loss"])))
    dt = time.time() - t0
    tok_s = (args.steps - start) * args.batch * args.seq / max(dt, 1e-9)
    print(f"done: {dt:.1f}s, {tok_s:,.0f} tokens/s")
    return losses


if __name__ == "__main__":
    main()
