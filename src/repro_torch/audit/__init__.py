"""repro_torch.audit: the port's invariant auditor (the reference's
``repro.audit``).

The DMD speed-up holds only while a few fragile choices hold: the state
written in place (no hidden copy of the O(m·n) rings; the addresses a
CUDA graph captures stay valid), O(buckets) kernel calls per step (the
packed arena), fp32 Grams with no silent casts, no host sync in the hot
loop, 128-lane arena segments, a collision-free group schedule, and a
serve engine that never builds past its buckets. This package checks
them: a registry of passes over (a) the recorded ops of the fused train
step, both jump variants and record_update (``audit/ops.py`` records an
eager call op by op, each hand kernel as one opaque op), and (b) the
static LeafPlan / GroupSchedule / ArenaBucket tables, for any config.

    PYTHONPATH=src python -m repro_torch.audit --arch pollutant-mlp \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.audit.lint src/repro_torch

The CLI prints a text report, writes ``AUDIT_torch_<config_key>.json``
and exits nonzero on a violation; ``--mutate <name>`` seeds a known
violation (``audit/mutations.py``) to prove each pass bites.
"""
from repro_torch.audit.registry import (AuditReport, PassResult, Violation,
                                        get_pass, list_passes, register_pass)

__all__ = ["AuditReport", "PassResult", "Violation", "get_pass",
           "list_passes", "register_pass", "run_audit"]


def run_audit(arch: str, *, reduced: bool = False, mutate=None,
              passes=None, serve: bool = False, device="cuda",
              mesh_shape=None) -> AuditReport:
    """Build the audit targets for ``arch`` on `device` and run every
    registered pass (or the named subset): ``targets.build_context`` and
    ``registry.run_passes``. With `mesh_shape` this is one rank's audit
    (the caller has joined the process group). The CLI adds the report
    file and the exit code."""
    return _context_and_report(arch, reduced=reduced, mutate=mutate,
                               passes=passes, serve=serve, device=device,
                               mesh_shape=mesh_shape)[1]


def _context_and_report(arch, *, reduced, mutate, passes, serve, device,
                        mesh_shape):
    from repro_torch.audit.registry import run_passes
    from repro_torch.audit.targets import build_context

    ctx = build_context(arch, reduced=reduced, mutate=mutate, serve=serve,
                        device=device, mesh_shape=mesh_shape)
    return ctx, run_passes(ctx, only=passes)


def audit_rank(rank: int, args: dict, mesh_shape):
    """One rank of ``python -m repro_torch.audit`` (``args`` its parsed
    flags): (ok, the text report, the config key, the JSON payload)."""
    ctx, report = _context_and_report(
        args["arch"], reduced=args["reduced"], mutate=args["mutate"],
        passes=args["passes"].split(",") if args["passes"] else None,
        serve=args["serve"], device=args["device"], mesh_shape=mesh_shape)
    payload = report.to_dict()
    payload["tables"] = ctx.tables()
    return report.ok, report.render(), ctx.config_key, payload
