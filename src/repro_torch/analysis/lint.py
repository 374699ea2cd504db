"""Pass 1 — dispatch-completeness lint over the port's model code.

Walks the model code's AST and flags *raw compute*: calls that burn FLOPs
without routing through a registry tunable. In torch that is
``torch.matmul`` / ``mm`` / ``bmm`` / ``einsum`` / ``tensordot``,
``F.linear``, the ``@`` operator, and ``torch.softmax`` / ``F.softmax``
(``torch.nn.functional`` spelled out counts too). Every such site is either
a dispatch-coverage gap the tuner cannot see, or a deliberate decision, and
deliberate decisions must say why:

    y = x.float() @ w  # repro: allow-raw(router projection over a handful of experts)

    # repro: allow-raw(the chunk loop's decay-masked scores await a fused kernel)
    def chunk_step(...):
        ...

Pragma grammar (``repro.analysis.lint``'s): ``# repro: allow-raw(<reason>)``.
A same-line pragma covers that line's sites. A pragma on its *own* line
covers the entire statement that begins on the next line, compound
statements included, so one pragma above a ``def`` covers every raw site in
that function. Reasons are free text (no parentheses) and surface as
``info`` findings, so the map of remaining untuned sites is one ``check``
run away.

JAX's lint also flags ``lax.scan`` recurrences. The port has no scan
primitive: its recurrences are Python loops over torch ops, whose products
inside are the categories above, so that category has no counterpart here.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Report

PRAGMA_RE = re.compile(r"#\s*repro:\s*allow-raw\(([^)]*)\)")

# Dotted-call patterns that count as raw compute. Matched against the full
# dotted path of the callee (e.g. "torch.einsum", "F.linear").
_FLOP_TAILS = {"einsum", "matmul", "mm", "bmm", "tensordot"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.nn.functional.softmax' for Attribute chains rooted at a Name,
    else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _classify_call(path: str) -> Optional[str]:
    parts = path.split(".")
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _FLOP_TAILS:
        return f"raw {parts[-1]}"
    functional = parts[:-1] in (["F"], ["torch", "nn", "functional"], ["nn", "functional"])
    if functional and parts[-1] == "linear":
        return "raw linear"
    if parts[-1] == "softmax" and (functional or parts[:-1] == ["torch"]):
        return "raw softmax"
    return None


class _RawComputeVisitor(ast.NodeVisitor):
    def __init__(self) -> None:
        self.sites: List[Tuple[int, str]] = []       # (lineno, label)

    def visit_Call(self, node: ast.Call) -> None:
        path = _dotted(node.func)
        if path is not None:
            label = _classify_call(path)
            if label is not None:
                self.sites.append((node.lineno, f"{label} ({path})"))
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.MatMult):
            self.sites.append((node.lineno, "raw @ matmul operator"))
        self.generic_visit(node)


def _collect_pragmas(
    source_lines: Sequence[str],
) -> Tuple[Dict[int, str], Dict[int, str]]:
    """(same-line pragmas, own-line pragmas), keyed by 1-based line number.

    A pragma is *own-line* when nothing but whitespace precedes the comment;
    it then covers the statement beginning on the following line.
    """
    same_line: Dict[int, str] = {}
    own_line: Dict[int, str] = {}
    for i, line in enumerate(source_lines, start=1):
        m = PRAGMA_RE.search(line)
        if not m:
            continue
        reason = m.group(1).strip() or "unspecified"
        if line[: m.start()].strip():
            same_line[i] = reason
        else:
            own_line[i] = reason
    return same_line, own_line


def _covered_ranges(
    tree: ast.AST, own_line: Dict[int, str]
) -> List[Tuple[int, int, str]]:
    """(first, last, reason) line ranges covered by own-line pragmas."""
    out: List[Tuple[int, int, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        reason = own_line.get(node.lineno - 1)
        if reason is not None:
            out.append((node.lineno, node.end_lineno or node.lineno, reason))
    return out


def lint_source(source: str, path: str, report: Report) -> None:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:                          # pragma: no cover
        report.add("lint", "error", f"{path}:{e.lineno or 0}", f"syntax error: {e.msg}")
        return
    visitor = _RawComputeVisitor()
    visitor.visit(tree)
    if not visitor.sites:
        return
    same_line, own_line = _collect_pragmas(source.splitlines())
    ranges = _covered_ranges(tree, own_line)

    def _reason_for(lineno: int) -> Optional[str]:
        if lineno in same_line:
            return same_line[lineno]
        for first, last, reason in ranges:
            if first <= lineno <= last:
                return reason
        return None

    for lineno, label in sorted(visitor.sites):
        loc = f"{path}:{lineno}"
        reason = _reason_for(lineno)
        if reason is not None:
            report.add("lint", "info", loc, f"{label} — allowed: {reason}")
            report.stats["lint_allowed"] = report.stats.get("lint_allowed", 0) + 1
        else:
            report.add(
                "lint", "error", loc,
                f"{label} not routed through a registry tunable; dispatch it "
                "or annotate `# repro: allow-raw(<reason>)`",
            )
            report.stats["lint_raw"] = report.stats.get("lint_raw", 0) + 1


def lint_paths(paths: Sequence[str], report: Optional[Report] = None) -> Report:
    """Lint every ``.py`` file under each path (file or directory)."""
    report = report if report is not None else Report()
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(
                    os.path.join(root, n) for n in names if n.endswith(".py")
                )
        elif p.endswith(".py"):
            files.append(p)
    report.stats["lint_files"] = len(files)
    for f in sorted(files):
        with open(f) as fh:
            lint_source(fh.read(), f, report)
    return report


def default_models_dir() -> str:
    """src/repro_torch/models — the layer the lint holds to the dispatch
    contract."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(here), "models")
