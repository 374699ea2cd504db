"""Finding/Report types shared by every static-analysis pass (a copy of
``repro.analysis.findings``: the same severities, exit-code policy,
``format`` and ``to_json``).

A *finding* is one diagnostic: which pass produced it, how severe it is,
where it points, and what it says. A *report* aggregates findings across
passes plus free-form stats (counts the CLI prints and tests assert on).

Severity contract:

* ``error`` — a contract violation: an untuned raw-compute site, a racy
  or uncovered output, a missing backward oracle, a stale database key. The default
  exit code is non-zero when any error is present.
* ``warn``  — suspicious but possibly intentional: an unknown platform
  fingerprint, a capacity key that drifted from the arch config. Fails
  only under ``--strict``.
* ``info``  — accounting: pragma-suppressed sites, per-platform pruning
  counts. Never affects the exit code.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Sequence

SEVERITIES = ("error", "warn", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str      # "lint" | "legality" | "contracts" | "db"
    severity: str       # one of SEVERITIES
    location: str       # "path:line", "kernel@platform", db key, ...
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    def format(self) -> str:
        return f"{self.severity:>5}  [{self.pass_name}] {self.location}: {self.message}"

    def to_json(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


class Report:
    """Ordered findings + stats, with the exit-code policy in one place."""

    def __init__(self) -> None:
        self.findings: List[Finding] = []
        self.stats: Dict[str, Any] = {}

    def add(self, pass_name: str, severity: str, location: str, message: str) -> None:
        self.findings.append(Finding(pass_name, severity, location, message))

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.stats.update(other.stats)

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    def errors(self) -> List[Finding]:
        return self.by_severity("error")

    def warnings(self) -> List[Finding]:
        return self.by_severity("warn")

    def counts(self) -> Dict[str, int]:
        return {s: len(self.by_severity(s)) for s in SEVERITIES}

    def exit_code(self, strict: bool = False) -> int:
        """0 = clean. Errors always fail; warnings fail only under strict."""
        if self.errors():
            return 1
        if strict and self.warnings():
            return 1
        return 0

    def format(self, verbose: bool = False) -> str:
        sev_rank = {s: i for i, s in enumerate(SEVERITIES)}
        shown = [
            f for f in self.findings if verbose or f.severity != "info"
        ]
        shown.sort(key=lambda f: (sev_rank[f.severity], f.pass_name, f.location))
        lines = [f.format() for f in shown]
        c = self.counts()
        lines.append(
            f"analysis: {c['error']} error(s), {c['warn']} warning(s), "
            f"{c['info']} info"
        )
        return "\n".join(lines)

    def to_json(self) -> Dict[str, Any]:
        return {
            "findings": [f.to_json() for f in self.findings],
            "counts": self.counts(),
            "stats": self.stats,
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=1, sort_keys=True)
