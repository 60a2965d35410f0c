"""Training launcher for the dense LM, the reference's ``launch/train.py``.

    python -m repro_torch.launch.train --arch tinyllama-1.1b [--steps 200]
        [--ckpt DIR] [--reduced] [--no-dmd] [--global-batch N] [--seq N]
        [--layers N] [--eager] [--device cuda]

The reference's flags and rules: ``--reduced`` trains the same-family
shrunk config (``configs.reduced``) at batch 8 x 64 without remat; without
it the config's own widths, the ``train_4k`` shape's batch (256 x 4096)
and its remat. The DMD warm-up is ``min(dmd.warmup_steps, steps // 4)``;
``--ckpt DIR`` checkpoints every 50 steps and resumes from the newest
checkpoint there, bit-exactly; SIGTERM saves after the current step and
exits. The data is ``data/tokens.py``'s synthetic stream, a function of
the step, so a resumed run sees the same batches.

The reference places the full config on its production mesh. The port
runs on one card: without ``--reduced`` it first reckons the state's
bytes (params, the optimizer's moments, the fp32 gradient sum and one
microbatch's gradient, and the DMD ring of m snapshots) and raises, with
those bytes, where they exceed 90% of the card's memory. It never shrinks
the model by itself: ``--layers N`` cuts the depth on request (the only
flag the reference does not have). ``--multi-pod`` raises: a mesh is not
ported (ROADMAP Queue 1 item 4). ``--eager`` turns the CUDA graphs off.
Without ``--device cpu`` it needs a card and raises otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced as reduce_model
from repro_torch.configs import shape_by_name
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.kernels.device import resolve_device
from repro_torch.models.transformer import LanguageModel, init_params
from repro_torch.train import Trainer
from repro_torch.train.step import state_resident

# optimizer moments in bytes per parameter (fp32 state)
MOMENT_BYTES = {"sgd": 0, "momentum": 4, "adam": 8, "adamw": 8}
CARD_FRACTION = 0.9                 # of the card's memory the state may use


def configure(arch: str, *, steps: int, reduced: bool = False,
              no_dmd: bool = False, global_batch: int = 0, seq: int = 0,
              ckpt: str = "", n_layers: int = 0):
    """The ArchConfig the reference's launcher builds from the same flags;
    `n_layers` > 0 cuts the depth."""
    acfg = get_config(arch)
    mc = reduce_model(acfg.model) if reduced else acfg.model
    if n_layers:
        mc = dataclasses.replace(mc, n_layers=n_layers)
    gb = global_batch or (8 if reduced else
                          shape_by_name("train_4k").global_batch)
    seq = seq or (64 if reduced else 4096)
    return dataclasses.replace(
        acfg, model=mc,
        dmd=dataclasses.replace(acfg.dmd, enabled=not no_dmd,
                                warmup_steps=min(acfg.dmd.warmup_steps,
                                                 steps // 4)),
        train=dataclasses.replace(acfg.train, global_batch=gb, seq_len=seq,
                                  checkpoint_every=50 if ckpt else 0,
                                  checkpoint_dir=ckpt))


def make_model(acfg, *, reduced: bool = False, device="cuda"
               ) -> LanguageModel:
    """The reference launcher's model: chunk_k min(seq, 1024), the
    config's remat unless reduced."""
    return LanguageModel(acfg.model, chunk_k=min(acfg.train.seq_len, 1024),
                         remat="none" if reduced else acfg.parallel.remat,
                         device=device)


def param_count(model: LanguageModel) -> int:
    """Parameters of the model's config, counted on the meta device."""
    return model.param_count(init_params(model.cfg, device="meta"))


def state_bytes(acfg, n_params: int) -> dict:
    """The training state's bytes by part: params in the model's dtype,
    the optimizer's fp32 moments, the fp32 gradient sum and one
    microbatch's gradient in the params' dtype, and the DMD ring of m
    snapshots."""
    p = torch.empty((), dtype=getattr(torch, acfg.model.dtype)).element_size()
    dmd = acfg.dmd
    snap = torch.empty((), dtype=getattr(torch, dmd.snapshot_dtype)
                       ).element_size()
    parts = {"params": p, "moments": MOMENT_BYTES[acfg.optimizer.name],
             "grads": 4 + p, "ring": dmd.m * snap if dmd.enabled else 0}
    return {k: v * n_params for k, v in parts.items()}


def check_fits(acfg, n_params: int, total: int) -> int:
    """The state's bytes; raises where they exceed CARD_FRACTION of the
    card's `total` bytes (the port does not shard the state over a
    mesh)."""
    need = sum(state_bytes(acfg, n_params).values())
    if need > CARD_FRACTION * total:
        raise RuntimeError(
            f"{acfg.model.name} at {acfg.model.n_layers} layers: the "
            f"training state alone needs {need} bytes ({n_params} params, "
            f"{state_bytes(acfg, n_params)}), more than {CARD_FRACTION} of "
            f"the card's {total} bytes; the port runs on one card (a mesh "
            "is ROADMAP Queue 1 item 4): cut the depth with --layers or "
            "train --reduced")
    return need


def make_trainer(acfg, model: LanguageModel, *, ckpt: str = "",
                 cuda_graphs: bool = True,
                 fail_at_step: Optional[int] = None) -> Trainer:
    return Trainer(model, acfg, checkpoint_dir=ckpt or None,
                   device=model.device, cuda_graphs=cuda_graphs,
                   fail_at_step=fail_at_step)


def fresh_state(trainer: Trainer):
    """Fresh params drawn on the trainer's device from ``train.seed``, as
    the loop's resident state: the per-leaf tensors are freed once packed,
    and the state's tensors are the ones ``fit`` updates in place."""
    gen = torch.Generator(device=trainer.device).manual_seed(
        trainer.acfg.train.seed)
    return state_resident(trainer.acc, trainer.acfg,
                          trainer.init_state(key=gen))


def run(acfg, model: LanguageModel, *, steps: int, ckpt: str = "",
        cuda_graphs: bool = True, log_every: int = 10,
        on_metrics: Optional[Callable] = None,
        trainer: Optional[Trainer] = None, state=None,
        fail_at_step: Optional[int] = None):
    """Train to step `steps` on the synthetic token stream, from `state`,
    else from the newest checkpoint in `ckpt`, else from ``fresh_state``.
    Returns (trainer, final state)."""
    if trainer is None:
        trainer = make_trainer(acfg, model, ckpt=ckpt,
                               cuda_graphs=cuda_graphs,
                               fail_at_step=fail_at_step)
    if state is None:
        start = (latest_step(ckpt) or 0) if ckpt else 0
        state = fresh_state(trainer)          # the restore's template
    else:
        start = int(state.step)
    tc = acfg.train
    batches = synthetic_lm_batches(tc.seed, tc.global_batch, tc.seq_len,
                                   acfg.model.vocab_size, start_step=start,
                                   device=model.device)
    return trainer, trainer.fit(batches, steps, state=state,
                                log_every=log_every, on_metrics=on_metrics)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--no-dmd", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--eager", action="store_true",
                    help="no CUDA graphs on a CUDA device")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError("--multi-pod needs the production mesh, "
                                  "which is not ported (ROADMAP Queue 1 "
                                  "item 4)")
    device = resolve_device(args.device)
    acfg = configure(args.arch, steps=args.steps, reduced=args.reduced,
                     no_dmd=args.no_dmd, global_batch=args.global_batch,
                     seq=args.seq, ckpt=args.ckpt, n_layers=args.layers)
    model = make_model(acfg, reduced=args.reduced, device=device)
    n_params = param_count(model)
    if device.type == "cuda" and not args.reduced:
        check_fits(acfg, n_params,
                   torch.cuda.get_device_properties(device).total_memory)
    gb, seq = acfg.train.global_batch, acfg.train.seq_len
    print(f"{args.arch}: {n_params / 1e6:.1f}M params, "
          f"dmd={'off' if args.no_dmd else 'on'}, batch={gb}x{seq}")
    losses = []
    t0 = time.perf_counter()
    trainer, state = run(acfg, model, steps=args.steps, ckpt=args.ckpt,
                         cuda_graphs=not args.eager,
                         on_metrics=lambda t, m: losses.append(
                             float(m["loss"])))
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = len(losses)
    print(f"{done} steps in {wall:.3f} s on {device} "
          f"({wall / max(done, 1) * 1e3:.3f} ms/step, "
          f"{done * gb * seq / max(wall, 1e-9):.0f} tokens/s), loss "
          f"{losses[0] if losses else float('nan'):.4f} -> "
          f"{losses[-1] if losses else float('nan'):.4f}, graphs "
          f"{trainer.graph_stats}")


if __name__ == "__main__":
    main()
