"""Training launcher for the LMs (the dense, VLM, MoE, SSM, hybrid and
enc-dec families), the reference's ``launch/train.py``.

    python -m repro_torch.launch.train --arch tinyllama-1.1b [--steps 200]
        [--ckpt DIR] [--reduced] [--no-dmd] [--global-batch N] [--seq N]
        [--layers N] [--eager] [--device cuda]

``--arch qwen3-moe-30b-a3b --layers 2 --global-batch 8`` trains
Qwen3-30B-A3B at its full widths with the config's DMD on every param
(bf16 ring of 8): 32 B a param of state, so 3 of its 48 layers already
exceed 90% of an 80 GB card. ``--arch mamba2-2.7b --layers 34`` and
``--arch zamba2-2.7b --layers 29`` (4 groups of 6 Mamba layers and the
shared block, then a 5-layer Mamba remainder) train Mamba2 and Zamba2 at
their full widths with DMD on every param (bf16 ring of 14), peaking at
0.85 and 0.78 of an 80 GB H100: 44 B a param of state, so their full
depths (118.9 and 103.0 GB) do not fit, and zamba2's 30 layers (5 groups)
pass ``check_fits`` but run out of memory. The dense decoders at their
full widths: ``minicpm-2b`` (44 B a param: its bf16 ring of 14; its full
40 layers need 120 GB), ``granite-20b`` and ``gemma3-27b`` (32 B a param,
rings of 8; gemma's tied 262144 x 5376 embedding alone is 45 GB of
state). ``check_fits`` admits 23, 4 and 2 layers; on an 80 GB H100 21, 3
and 1 train (``chip_smoke.py`` trains 2, 2 and 1; gemma's
first layers are window layers, of 1024 tokens). ``qwen2-vl-7b`` (36 B a
param: its bf16 ring of 10; the full depth's state is 274 GB) trains on
the stream's M-RoPE positions, three equal arange streams as the
reference's stream gives them (RoPE in effect; ``chip_smoke.py`` trains it
under an image block's streams, which differ); ``whisper-base`` (72 B a
param: an fp32 ring of 14; 6.35 GB at full depth) on the stream's stub
frames.

The reference's flags and rules: ``--reduced`` trains the same-family
shrunk config (``configs.reduced``) at batch 8 x 64 without remat; without
it the config's own widths, the ``train_4k`` shape's batch (256 x 4096)
and its remat. The DMD warm-up is ``min(dmd.warmup_steps, steps // 4)``;
``--ckpt DIR`` checkpoints every 50 steps and resumes from the newest
checkpoint there, bit-exactly; SIGTERM saves after the current step and
exits. The data is ``data/tokens.py``'s synthetic stream, a function of
the step, so a resumed run sees the same batches; with the model's
``mrope`` and ``frames`` keywords (``stream_kwargs``), as the reference's
launcher passes them.

The reference places the full config on its production mesh. The port
runs on one card unless asked for a mesh: ``--mesh DxM`` (or ``PxDxM``)
trains on a (data, model) or (pod, data, model) mesh of ranks, one process
each, and ``--multi-pod`` on the production (2, 16, 16) mesh. Under
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``
set) each process joins the group it describes; without it the launcher
spawns the mesh's ranks itself. Rank r runs on card ``r % cards``;
``--backend`` (default gloo) is the process group's: NCCL needs a card for
each rank, gloo lets ranks share one. A mesh runs its steps eagerly: on a
card it needs ``--eager`` (the Trainer raises otherwise). Without ``--reduced`` on a card it first reckons the state's
bytes (params, the optimizer's moments, the fp32 gradient sum and one
microbatch's gradient, and the DMD ring of m snapshots; under a mesh a
rank's blocks of them plus the params its tensor-parallel forward reads,
its "model" blocks gathered over the other axes, and their gradient)
and raises, with those bytes, where they exceed 90% of the card's memory,
or of a rank's share of it where ranks share a card. It never shrinks the
model by itself: ``--layers N`` cuts the depth on request (the only flag
the reference does not have). ``--eager`` turns the CUDA graphs off.
Without ``--device cpu`` it needs a card and raises otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced as reduce_model
from repro_torch.configs import shape_by_name
from repro_torch.data.tokens import stream_kwargs, synthetic_lm_batches
from repro_torch.kernels.device import resolve_device
from repro_torch.launch.mesh import Mesh, init_from_env, parse_mesh, run_ranks
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


def make_model(acfg, *, reduced: bool = False, device="cuda", mesh=None
               ) -> LanguageModel:
    """The reference launcher's model: chunk_k min(seq, 1024), the
    config's remat unless reduced, ``head_tp=not reduced`` (a reduced
    model under a mesh attends in kv-SP, as the reference's launcher
    makes it, ``src/repro/launch/train.py:53``). Under a `mesh` whose
    "model" axis is larger than one it passes
    ``parallel.pad_attn_heads_to``, as the reference's launcher does: its
    padded heads serve head-parallel compute over "model". Without one it
    passes none: on one card the padded heads would only add work."""
    pad = (acfg.parallel.pad_attn_heads_to
           if mesh is not None and mesh.axis_size("model") > 1 else 0)
    return LanguageModel(acfg.model, head_tp=not reduced,
                         chunk_k=min(acfg.train.seq_len, 1024),
                         remat="none" if reduced else acfg.parallel.remat,
                         device=device, pad_heads_to=pad)


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


def local_param_count(model: LanguageModel, mesh,
                      model_only: bool = False) -> int:
    """Parameters of one rank's blocks under `mesh` (anything with
    ``axis_names`` and ``devices.shape``), counted on the meta device;
    `model_only`: of its blocks over "model" alone (the params a
    tensor-parallel forward reads, gathered over the other axes)."""
    from repro_torch.core.paths import leaves_with_paths
    from repro_torch.distributed.sharding import (Spec, entry_axes,
                                                  local_shape, param_specs)

    params = init_params(model.cfg, device="meta")
    specs = param_specs(params, mesh)

    def spec(path):
        if not model_only:
            return specs[path]
        return Spec(*(e if "model" in entry_axes(e) else None
                      for e in specs[path]))
    return sum(int(np.prod(local_shape(x.shape, spec(p), mesh),
                           dtype=np.int64))
               for p, x in leaves_with_paths(params))


def check_fits(acfg, n_params: int, total: int, *,
               n_local: Optional[int] = None, share: int = 1,
               n_read: Optional[int] = None) -> int:
    """The state's bytes on one rank; raises where they exceed
    CARD_FRACTION of the card's `total` bytes over the `share` ranks that
    use the card. Under a mesh (`n_local`: the params of a rank's blocks)
    a rank holds its blocks of the state and, in a step, the params its
    forward reads (`n_read`, default all: its "model" blocks gathered
    over the other axes) and their gradient (in the params' dtype and in
    fp32)."""
    need = sum(state_bytes(acfg, n_params if n_local is None
                           else n_local).values())
    if n_local is not None:
        p = torch.empty((), dtype=getattr(torch, acfg.model.dtype)
                        ).element_size()
        need += (2 * p + 4) * (n_params if n_read is None else n_read)
    if need > CARD_FRACTION * total / share:
        raise RuntimeError(
            f"{acfg.model.name} at {acfg.model.n_layers} layers: the "
            f"training state alone needs {need} bytes a rank ({n_params} "
            f"params, {n_local} a rank's, {share} rank(s) to the card), "
            f"more than {CARD_FRACTION} of the card's {total} bytes"
            f"{'' if share == 1 else f' / {share}'}: cut the depth with "
            "--layers, shard over more cards, or train --reduced")
    return need


def make_trainer(acfg, model: LanguageModel, *, ckpt: str = "",
                 cuda_graphs: bool = True,
                 fail_at_step: Optional[int] = None, mesh=None) -> Trainer:
    return Trainer(model, acfg, checkpoint_dir=ckpt or None,
                   device=model.device, cuda_graphs=cuda_graphs,
                   fail_at_step=fail_at_step, mesh=mesh)


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
        fail_at_step: Optional[int] = None, mesh=None):
    """Train to step `steps` on the synthetic token stream, from `state`,
    else from the newest checkpoint in `ckpt`, else from ``fresh_state``.
    Returns (trainer, final state)."""
    if trainer is None:
        trainer = make_trainer(acfg, model, ckpt=ckpt,
                               cuda_graphs=cuda_graphs,
                               fail_at_step=fail_at_step, mesh=mesh)
    if state is None:
        start = (latest_step(ckpt) or 0) if ckpt else 0
        state = fresh_state(trainer)          # the restore's template
    else:
        start = int(state.step)
    tc = acfg.train
    batches = synthetic_lm_batches(tc.seed, tc.global_batch, tc.seq_len,
                                   acfg.model.vocab_size, start_step=start,
                                   device=model.device,
                                   **stream_kwargs(acfg.model))
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
    ap.add_argument("--mesh", default="",
                    help="train on a DxM (or PxDxM) mesh of ranks")
    ap.add_argument("--backend", default="gloo",
                    help="the ranks' process group: gloo (ranks may share a "
                         "card) or nccl (a card each)")
    args = ap.parse_args(argv)
    shape = None
    if args.multi_pod:
        shape = (2, 16, 16)
    elif args.mesh:
        shape = parse_mesh(args.mesh)
    if shape is None:
        _train(0, args, None)
        return
    world = int(np.prod(shape))
    if "RANK" in os.environ:
        got = int(os.environ["WORLD_SIZE"])
        if got != world:
            raise ValueError(f"a {shape} mesh needs {world} ranks; torchrun "
                             f"started {got}")
        rank, _ = init_from_env(args.backend)
        _train(rank, args, shape)
    elif args.multi_pod:
        raise ValueError(f"--multi-pod's production mesh needs {world} "
                         "ranks: launch them with torchrun")
    else:
        # by its module's name, so that the spawned ranks can import it
        from repro_torch.launch import train as launcher
        run_ranks(launcher._train, world, args, shape, backend=args.backend,
                  join_timeout=24 * 3600,
                  threads=max(1, (os.cpu_count() or 1) // world))


def _train(rank: int, args, shape) -> None:
    """One rank of the launcher (the only one, without a mesh)."""
    device = resolve_device(args.device)
    mesh = None
    if shape is not None:
        if device.type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        mesh = Mesh(shape, device=device)
    say = print if rank == 0 else (lambda *a, **k: None)
    acfg = configure(args.arch, steps=args.steps, reduced=args.reduced,
                     no_dmd=args.no_dmd, global_batch=args.global_batch,
                     seq=args.seq, ckpt=args.ckpt, n_layers=args.layers)
    model = make_model(acfg, reduced=args.reduced, device=device,
                       mesh=mesh)
    n_params = param_count(model)
    if device.type == "cuda" and not args.reduced:
        if mesh is None:
            check_fits(acfg, n_params,
                       torch.cuda.get_device_properties(device).total_memory)
        else:
            n_ranks = int(np.prod(mesh.shape))
            check_fits(acfg, n_params,
                       torch.cuda.get_device_properties(device).total_memory,
                       n_local=local_param_count(model, mesh),
                       share=-(-n_ranks // torch.cuda.device_count()),
                       n_read=local_param_count(model, mesh,
                                                model_only=True))
    gb, seq = acfg.train.global_batch, acfg.train.seq_len
    say(f"{args.arch}: {n_params / 1e6:.1f}M params, "
        f"dmd={'off' if args.no_dmd else 'on'}, batch={gb}x{seq}"
        + ("" if mesh is None else f", mesh {mesh.shape} on "
           f"{mesh.backend}")
        + (f", heads padded to {model.pad_heads_to}" if model.pad_heads_to
           else ""))
    losses = []
    t0 = time.perf_counter()
    trainer, state = run(acfg, model, steps=args.steps, ckpt=args.ckpt,
                         cuda_graphs=not args.eager, mesh=mesh,
                         on_metrics=lambda t, m: losses.append(
                             float(m["loss"])))
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = len(losses)
    say(f"{done} steps in {wall:.3f} s on {device} "
          f"({wall / max(done, 1) * 1e3:.3f} ms/step, "
          f"{done * gb * seq / max(wall, 1e-9):.0f} tokens/s), loss "
          f"{losses[0] if losses else float('nan'):.4f} -> "
          f"{losses[-1] if losses else float('nan'):.4f}, graphs "
          f"{trainer.graph_stats}")


if __name__ == "__main__":
    main()
