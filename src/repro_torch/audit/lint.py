"""AST lint over the port's sources:

    PYTHONPATH=src python -m repro_torch.audit.lint src/repro_torch

Source-level rules beside the recorded-op passes (the reference's
``repro.audit.lint``, restated for eager torch). Two tiers:

HOT modules (``HOT_PREFIXES``: the kernel wrappers, the DMD core and the
train step), which run inside the hot loop and inside captured CUDA
graphs, where host work either stalls the host on the card or breaks the
capture:

  host-time        time.time / perf_counter / monotonic / sleep,
                   datetime.now: a host-clock read in a step
  host-sync        .item() / .tolist() / .cpu() / .numpy() /
                   torch.cuda.synchronize(): a device-to-host read
                   (``core/dmd.py``'s host solve is the sanctioned one)
  nonstatic-shape  int(...) / float(...) around a ``torch.`` call: a
                   device value turned into a host number

EVERY module:

  unused-import    import debt

Exit code is nonzero iff there is a finding. ``# lint: allow-<rule>`` on
the offending line, with the reason beside it, suppresses it.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, Tuple

# modules whose code runs in the hot loop (and in captured graphs)
HOT_PREFIXES = (
    "repro_torch/kernels/",
    "repro_torch/core/",
    "repro_torch/train/step.py",
)
# the DMD solve's host step is the one sanctioned device-to-host read
SYNC_WHITELIST = ("repro_torch/core/dmd.py",)

HOST_TIME = {"time.time", "time.perf_counter", "time.monotonic",
             "time.sleep", "datetime.now", "datetime.datetime.now"}
HOST_SYNC = {"item", "tolist", "cpu", "numpy"}
SYNC_CALLS = {"torch.cuda.synchronize"}

Finding = Tuple[str, int, str, str]     # (file, line, rule, detail)


def _dotted(node) -> str:
    """'a.b.c' for an attribute/name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _allowed(src_lines: List[str], lineno: int, rule: str) -> bool:
    line = src_lines[lineno - 1] if 0 < lineno <= len(src_lines) else ""
    if f"lint: allow-{rule}" in line:
        return True
    # a ruff-style noqa for an unused import suppresses the same rule here
    return rule == "unused-import" and "noqa" in line and "F401" in line


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, src: str, hot: bool):
        self.rel = rel
        self.lines = src.splitlines()
        self.hot = hot
        self.sync_ok = any(rel.endswith(w) for w in SYNC_WHITELIST)
        self.findings: List[Finding] = []
        self.imports: dict = {}          # alias -> lineno
        self.used: set = set()

    def _add(self, node, rule: str, detail: str):
        if not _allowed(self.lines, node.lineno, rule):
            self.findings.append((self.rel, node.lineno, rule, detail))

    # -- unused-import bookkeeping ------------------------------------
    def visit_Import(self, node):
        for a in node.names:
            alias = a.asname or a.name.split(".")[0]
            self.imports.setdefault(alias, node.lineno)

    def visit_ImportFrom(self, node):
        for a in node.names:
            if a.name == "*":
                continue
            alias = a.asname or a.name
            self.imports.setdefault(alias, node.lineno)

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.used.add(node.id)

    def visit_Assign(self, node):
        # names re-exported through __all__ count as used
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if "__all__" in targets:
            for el in ast.walk(node.value):
                if isinstance(el, ast.Constant) and isinstance(el.value,
                                                               str):
                    self.used.add(el.value)
        self.generic_visit(node)

    # -- hot-module rules ---------------------------------------------
    def visit_Call(self, node):
        dotted = _dotted(node.func)
        leaf = dotted.rsplit(".", 1)[-1] if dotted else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        if self.hot:
            if dotted in HOST_TIME:
                self._add(node, "host-time",
                          f"{dotted}() reads the host clock in a hot "
                          "module")
            if not self.sync_ok and (
                    dotted in SYNC_CALLS or (
                        leaf in HOST_SYNC
                        and isinstance(node.func, ast.Attribute))):
                self._add(node, "host-sync",
                          f"{dotted or '.' + leaf}() reads the device "
                          "back to the host in a hot module")
            if (isinstance(node.func, ast.Name)
                    and node.func.id in ("int", "float") and node.args):
                inner = node.args[0]
                if isinstance(inner, ast.Call):
                    d = _dotted(inner.func)
                    if d.startswith("torch."):
                        self._add(
                            node, "nonstatic-shape",
                            f"{node.func.id}({d}(...)) turns a device "
                            "value into a host number: shape math in "
                            "kernel and step modules must be static "
                            "Python ints")
        self.generic_visit(node)

    def finish(self):
        for alias, lineno in sorted(self.imports.items(),
                                    key=lambda kv: kv[1]):
            if alias in self.used or alias in ("_", "annotations"):
                continue
            if not _allowed(self.lines, lineno, "unused-import"):
                self.findings.append(
                    (self.rel, lineno, "unused-import",
                     f"{alias!r} imported but unused"))


def _rel(path: Path) -> str:
    """The path from the package directory on (``repro_torch/core/dmd.py``)
    where it lies in one, else as given."""
    parts = path.as_posix().split("/")
    if "repro_torch" in parts:
        return "/".join(parts[parts.index("repro_torch"):])
    return path.as_posix()


def lint_source(src: str, rel: str) -> List[Finding]:
    """The findings of one module's source, `rel` its package path (which
    decides whether it is HOT)."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [(rel, e.lineno or 0, "syntax", str(e))]
    hot = any(rel.startswith(h) for h in HOT_PREFIXES)
    v = _Visitor(rel, src, hot)
    v.visit(tree)
    v.finish()
    return v.findings


def lint_paths(paths) -> List[Finding]:
    findings: List[Finding] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_source(f.read_text(), _rel(f.resolve())))
    return findings


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: python -m repro_torch.audit.lint <path> [path ...]")
        return 2
    findings = lint_paths(args)
    for rel, line, rule, detail in findings:
        print(f"{rel}:{line}: [{rule}] {detail}")
    print(f"repro_torch.audit.lint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
