"""Pass registry and report types of the audit (the reference's, as is).

A pass is a named function ``(ctx) -> (violations, info)`` over an
``AuditContext`` (``repro_torch.audit.targets``), registered with::

    @register_pass("donation-alias", doc="...")
    def donation_alias(ctx): ...

``run_passes`` runs the table in registration order and folds the results
into an ``AuditReport``, which renders as text (the CLI's report) or a
JSON-able dict (``AUDIT_torch_<config_key>.json``). A pass that raises is
itself a violation: an auditor that crashes must not read as clean.
"""
from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Violation:
    """One audited invariant, broken. ``where`` names the target or table
    row; ``detail`` is the evidence (counts, shapes, offsets)."""
    passname: str
    where: str
    detail: str
    severity: str = "error"        # "error" fails the audit; "warning" is
                                   # reported but does not fail it

    def to_dict(self) -> dict:
        return {"pass": self.passname, "where": self.where,
                "detail": self.detail, "severity": self.severity}


@dataclass
class PassResult:
    name: str
    doc: str
    violations: List[Violation] = field(default_factory=list)
    info: Dict[str, object] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(v.severity == "error" for v in self.violations)


@dataclass
class AuditReport:
    arch: str
    meta: Dict[str, object]
    results: List[PassResult] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def violations(self) -> List[Violation]:
        return [v for r in self.results for v in r.violations]

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "ok": self.ok,
            "meta": dict(self.meta),
            "passes": [{
                "name": r.name, "ok": r.ok, "doc": r.doc,
                "violations": [v.to_dict() for v in r.violations],
                "info": {k: _jsonable(v) for k, v in r.info.items()},
            } for r in self.results],
        }

    def render(self) -> str:
        lines = [f"repro_torch.audit — {self.arch} "
                 f"({', '.join(f'{k}={v}' for k, v in self.meta.items())})",
                 "=" * 72]
        for r in self.results:
            mark = "PASS" if r.ok else "FAIL"
            lines.append(f"[{mark}] {r.name:<22} {r.doc}")
            for k, v in sorted(r.info.items()):
                lines.append(f"       . {k} = {_jsonable(v)}")
            for v in r.violations:
                tag = "!" if v.severity == "error" else "~"
                lines.append(f"       {tag} {v.where}: {v.detail}")
        n_err = sum(1 for v in self.violations if v.severity == "error")
        n_warn = sum(1 for v in self.violations if v.severity == "warning")
        lines.append("=" * 72)
        lines.append(f"{'CLEAN' if self.ok else 'VIOLATIONS'}: "
                     f"{n_err} error(s), {n_warn} warning(s) across "
                     f"{len(self.results)} passes")
        return "\n".join(lines)


def _jsonable(v):
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


PassFn = Callable[[object], Tuple[List[Violation], Dict[str, object]]]

_REGISTRY: Dict[str, Tuple[PassFn, str]] = {}


def register_pass(name: str, doc: str = ""):
    """Decorator: add ``fn(ctx) -> (violations, info)`` to the registry.
    Passes run in registration order (``repro_torch.audit.passes`` defines
    it)."""
    def deco(fn: PassFn) -> PassFn:
        _REGISTRY[name] = (fn, doc or (fn.__doc__ or "").strip().split(
            "\n")[0])
        return fn
    return deco


def get_pass(name: str) -> PassFn:
    return _REGISTRY[name][0]


def list_passes() -> List[str]:
    return list(_REGISTRY)


def run_passes(ctx, only: Optional[Sequence[str]] = None) -> AuditReport:
    """Run the registered passes (or the named subset) over `ctx`, the
    built-in ones registered first."""
    from repro_torch.audit import passes  # noqa: F401 (registers)

    names = list(only) if only else list(_REGISTRY)
    unknown = [n for n in names if n not in _REGISTRY]
    if unknown:
        raise KeyError(f"unknown audit pass(es) {unknown}; "
                       f"known: {list(_REGISTRY)}")
    report = AuditReport(arch=ctx.arch, meta=ctx.meta())
    for name in names:
        fn, doc = _REGISTRY[name]
        result = PassResult(name=name, doc=doc)
        try:
            violations, info = fn(ctx)
            result.violations = list(violations)
            result.info = dict(info)
        except Exception as e:
            result.violations = [Violation(
                passname=name, where="(pass crashed)",
                detail=f"{type(e).__name__}: {e}\n"
                       f"{traceback.format_exc(limit=6)}")]
        report.results.append(result)
    return report
