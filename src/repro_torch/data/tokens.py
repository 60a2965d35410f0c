"""Deterministic synthetic LM token pipeline.

Batches are a pure function of (seed, step): a restarted worker replays the
identical stream, on any device (the draw is made by a CPU generator seeded
from both numbers, then moved). Tokens follow a Zipf-ish distribution so
losses behave like text rather than uniform noise. The stream is the port's
own: ``jax.random`` cannot be reproduced in torch, so the reference's
``repro/data/tokens.py`` and this module share the contract, not the
values.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.device import resolve_device


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step) through numpy's
    ``SeedSequence``, so nearby pairs give unrelated streams."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def batch_for_step(seed: int, step: int, global_batch: int, seq_len: int,
                   vocab_size: int, *, mrope: bool = False,
                   frames: Optional[tuple] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    gen = _generator(seed, step)
    # Zipf-ish: exponentiate a uniform in [1e-6, 1) to skew token ids low
    u = 1e-6 + torch.rand((global_batch, seq_len + 1), generator=gen) * (
        1.0 - 1e-6)
    ids = (u ** 3.0 * vocab_size).to(torch.int32) % vocab_size
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    if frames is not None:
        batch["frames"] = torch.randn((global_batch,) + tuple(frames),
                                      generator=gen)
    batch = {k: v.to(dev) for k, v in batch.items()}
    if mrope:
        batch["positions"] = torch.arange(
            seq_len, dtype=torch.int32, device=dev)[None, None, :].expand(
                global_batch, 3, seq_len)
    return batch


def stream_kwargs(mc) -> Dict[str, object]:
    """The batch stream's model keywords for a model config, as the
    reference's launcher and Trainer pass them: ``mrope`` (M-RoPE models
    take (B, 3, S) positions) and ``frames`` (the enc-dec family's
    (encoder_seq_len, d_model) stub frames)."""
    return {"mrope": bool(mc.mrope_sections),
            "frames": ((mc.encoder_seq_len, mc.d_model)
                       if mc.family == "encdec" else None)}


def image_positions(batch: int, seq_len: int, grid: Tuple[int, int],
                    start: int = 0, device="cuda") -> torch.Tensor:
    """(batch, 3, seq_len) int32 M-RoPE streams of a prompt that opens with
    an image block of grid[0] x grid[1] patch tokens from the stub
    frontend (t fixed at `start`, h and w the patch's row and column, each
    offset by `start`), then text whose three streams continue together
    from the grid's maximum + 1 (Qwen2-VL's rule)."""
    gh, gw = grid
    n = gh * gw
    if n > seq_len:
        raise ValueError(f"an image block of {n} tokens in {seq_len}")
    dev = resolve_device(device)
    patch = torch.arange(n, device=dev)
    pos = torch.empty((batch, 3, seq_len), dtype=torch.int32, device=dev)
    pos[:, 0, :n] = start
    pos[:, 1, :n] = start + patch // gw
    pos[:, 2, :n] = start + patch % gw
    pos[:, :, n:] = start + max(gh, gw) + torch.arange(seq_len - n,
                                                       device=dev)
    return pos


# Reserved stream offset for the validation split. The training stream
# indexes batches by optimizer step, so every index a run can reach is a
# TRAINING batch; the validation fold lives past 2^30 steps: disjoint from
# any reachable training index, deterministic, and step-independent (a
# resumed run sees the identical split).
VAL_FOLD = 1 << 30


def validation_batch(seed: int, global_batch: int, seq_len: int,
                     vocab_size: int, *, index: int = 0,
                     **kw) -> Dict[str, torch.Tensor]:
    """One deterministic validation batch DISJOINT from the training stream:
    drawn at the reserved ``VAL_FOLD`` offset that ``batch_for_step``'s
    step-indexed training stream never reaches. The jump controller's gate
    scores on this split. ``index`` selects among validation batches."""
    return batch_for_step(seed, VAL_FOLD + index, global_batch, seq_len,
                          vocab_size, **kw)


def synthetic_lm_batches(seed: int, global_batch: int, seq_len: int,
                         vocab_size: int, *, start_step: int = 0,
                         **kw) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_for_step(seed, step, global_batch, seq_len, vocab_size,
                             **kw)
        step += 1
