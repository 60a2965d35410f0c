"""Pinned ceilings for the trace-budget pass: the port's own counts.

A pin is a hard ceiling on the recorded op count (``eqns``: aten ops and
opaque kernel / host-solve calls, views and transfers apart;
``audit/ops.py``) and on the kernel calls (``launches``) of ONE audit
target under ONE config key (``AuditContext.config_key``: the arch, plus
``-reduced``). They are not the reference's jaxpr counts: an eager step
records what it runs, which differs from what a jaxpr traces. Unpinned
(config, target) pairs report their counts as info and never fail.

The counts do not depend on the device: the card runs check the same
pins (``chip_smoke.py`` phase 20). Each ceiling sits 25-40% over the
count measured with torch 2.13 on the CPU, noted beside it.

Bump procedure: a legitimate growth of a step (a new fused feature, a
torch upgrade that decomposes an op differently) raises a ceiling in THIS
file, in the same change that grew the step, with the newly measured
count in the comment. Never bump to make a run pass without knowing which
ops appeared: run ``python -m repro_torch.audit --arch <arch> [--reduced]
--device cpu`` and diff the per-target counts first.
"""
from __future__ import annotations

from typing import Dict, Optional

# {config_key: {target: {"eqns": ceiling, "launches": ceiling}}}; each
# ceiling is the measured count (torch 2.13, CPU) times 1.3, rounded down
# and never below the count
TRACE_PINS: Dict[str, Dict[str, Dict[str, int]]] = {
    # the paper MLP (PAPER_SIZES, m 14, eig mode, one arena bucket of 8
    # leaves; resident params)
    "pollutant-mlp": {
        "train_step": {"eqns": 132, "launches": 1},   # measured 102, 1 (K1)
        "dmd_step": {"eqns": 235, "launches": 1},     # measured 181, 1 (K2)
        "dmd_step_gated": {"eqns": 444, "launches": 1},  # measured 342, 1
        "record_update": {"eqns": 5, "launches": 1},  # measured 4, 1 (K1)
    },
    "pollutant-mlp-reduced": {
        "train_step": {"eqns": 109, "launches": 1},   # measured 84, 1
        "dmd_step": {"eqns": 230, "launches": 1},     # measured 177, 1
        "dmd_step_gated": {"eqns": 419, "launches": 1},  # measured 323, 1
        "record_update": {"eqns": 5, "launches": 1},  # measured 4, 1
    },
    # reduced TinyLlama (two buckets: fp32 and bf16 leaves); train_step's
    # kernel calls are K7 and K7b per layer and K1 per bucket
    "tinyllama-1.1b-reduced": {
        "train_step": {"eqns": 568, "launches": 7},   # measured 437, 6
        "dmd_step": {"eqns": 245, "launches": 2},     # measured 189, 2 (K2)
        "dmd_step_gated": {"eqns": 1072, "launches": 10},  # measured 825, 8
        "record_update": {"eqns": 10, "launches": 2},  # measured 8, 2 (K1)
    },
    # the bespoke 24-layer MLP of tests/test_torch_audit.py (48 leaves, one
    # bucket, m 6): one K1 per record, not one per leaf
    "deep-mlp-24x32": {
        "train_step": {"eqns": 600, "launches": 1},   # measured 462, 1
    },
    # the same reduced TinyLlama at dmd.scope="bucket": train_step is the
    # leaf scope's op for op, the jump a little smaller. The op count
    # cannot see a silent fallback to per-leaf solves (the host eigh is
    # one op either way): the solve-budget pass owns that guard
    "tinyllama-1.1b-reduced-bucket": {
        "train_step": {"eqns": 568, "launches": 7},   # measured 437, 6
        "dmd_step": {"eqns": 219, "launches": 2},     # measured 169, 2
    },
}


def trace_ceiling(config_key: str, target: str) -> Optional[Dict[str, int]]:
    """The pinned ceilings for one (config, target), or None if unpinned."""
    return TRACE_PINS.get(config_key, {}).get(target)
