"""The serve engine's audit build: drive an engine through a warm-up wave
and a steady wave and attach its registry counts to an AuditContext for
the ``serve-compile`` pass (the reference's ``attach_serve``, its config
and its waves).

The warm-up touches EVERY program the bucket policy allows (each prompt
bucket at each batch bucket, both inserts, the decode) and the steady
wave hits every bucket again at OTHER in-bucket prompt lengths: with
correct bucketing nothing is built after ``mark_steady()``
(``steady_compiles == 0``, ``n_programs <= max_programs``), while the
``force-recompile`` mutation (exact-length "buckets") builds a fresh
prefill program per novel steady length and the pass bites.

A family without a serving path (the paper's MLP) is audited on the
reduced TinyLlama engine instead (``stand_in`` in the counts), so that
the serve-compile pass and its mutation bite on every config; the
reference reports such a build as skipped.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.paths import leaves_with_paths
from repro_torch.serve.engine import ServeConfig, ServeEngine

# (prompt lengths per wave): pairs exercise batch bucket 2, singles 1
WARMUP_WAVES = ([3, 3], [7, 7], [2], [5])
STEADY_WAVES = ([4, 4], [8, 8], [1], [6])
# the serving model of a family that has none
STAND_IN = "tinyllama-1.1b"


def serve_config(mutate: Optional[Callable] = None) -> ServeConfig:
    """The audit engine's config; `mutate` is the ``Mutation.serve_cfg``
    seam (ServeConfig -> ServeConfig)."""
    cfg = ServeConfig(n_slots=4, prompt_buckets=(4, 8), batch_buckets=(1, 2),
                      max_new_tokens=4)
    return mutate(cfg) if mutate is not None else cfg


def run_waves(engine: ServeEngine) -> None:
    """The warm-up waves, ``mark_steady()``, then the steady waves."""
    def drive(waves):
        for wave in waves:
            for n in wave:
                engine.submit(list(range(1, n + 1)))
            engine.run_until_drained()

    drive(WARMUP_WAVES)
    engine.mark_steady()
    drive(STEADY_WAVES)


def _table_storage(engine: ServeEngine) -> Dict[str, int]:
    return {p: t.untyped_storage().data_ptr()
            for p, t in leaves_with_paths(engine._dstate["caches"])}


def serve_audit(model, params, mutate: Optional[Callable] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any], ServeEngine]:
    """An engine over (model, params) through the waves: (its registry
    counts with ``dropped`` and, as ``table_kept`` of ``table_leaves``,
    the slot-table cache tensors that kept their storage over the whole
    run; its ``serve_decode`` target; the engine)."""
    engine = ServeEngine(model, params, serve_config(mutate))
    table = _table_storage(engine)
    run_waves(engine)
    after = _table_storage(engine)
    info = engine.audit_info()
    info["dropped"] = engine.stats["dropped"]
    info["table_leaves"] = len(table)
    info["table_kept"] = sum(after.get(p) == v for p, v in table.items())
    return info, engine.audit_targets(), engine


def attach_serve(ctx, mutate: Optional[Callable] = None) -> None:
    """Build an engine for ``ctx``'s model config (the same, possibly
    reduced, model the audit trained; the reduced TinyLlama for a family
    without a serving path), run the waves on ``ctx.device``, and attach
    ``ctx.serve`` and the ``serve_decode`` target."""
    from repro_torch.audit.targets import REDUCED_OVERRIDES
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import LanguageModel

    cfg = serve_config(mutate)
    mc, stand_in = ctx.acfg.model, None
    if mc.family == "mlp":
        mc = reduced(get_config(STAND_IN).model, **REDUCED_OVERRIDES)
        stand_in = f"{STAND_IN}-reduced"
    model = LanguageModel(mc, head_tp=False,
                          chunk_k=min(16, cfg.prompt_buckets[-1]),
                          device=ctx.device)
    params = model.init(torch.Generator(device=ctx.device).manual_seed(0))
    info, targets, _ = serve_audit(model, params, mutate)
    if stand_in is not None:
        info["stand_in"] = stand_in
    ctx.serve = info
    ctx.targets.update(targets)
