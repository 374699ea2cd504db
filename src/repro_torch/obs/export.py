"""Exporters: JSON snapshot, JSONL event sink, Prometheus textfile.

The port of ``repro.obs.export``: the same snapshot schema, file formats
and renderings.

One snapshot schema (``ObsCollector.snapshot``) feeds every consumer:
``--metrics-out`` writes it, ``python -m repro_torch.obs report/diff``
renders and compares it, and :func:`write_prom` reshapes it into the
Prometheus textfile exposition format (node_exporter's textfile-collector
contract) so a fleet scraper ingests the same numbers with zero extra
plumbing.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterable, List

from ..core.database import atomic_write_json


def write_snapshot(snapshot: Dict[str, Any], path: str) -> None:
    atomic_write_json(path, snapshot)


def load_snapshot(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        raise SystemExit(f"error: metrics snapshot {path}: no such file")
    with open(path) as f:
        return json.load(f)


def write_jsonl(events: Iterable[Dict[str, Any]], path: str) -> None:
    """Append-friendly structured event sink: one JSON object per line."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        for ev in events:
            f.write(json.dumps(dict(ev), sort_keys=True) + "\n")


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "repro_" + _NAME_RE.sub("_", name)


def _prom_tags(tags: Dict[str, str]) -> str:
    if not tags:
        return ""
    body = ",".join(
        f'{_NAME_RE.sub("_", k)}="{str(v).replace(chr(92), "")}"'
        for k, v in sorted(tags.items())
    )
    return "{" + body + "}"


def write_prom(snapshot: Dict[str, Any], path: str) -> None:
    """Prometheus textfile exposition of one snapshot.

    Counters/gauges map 1:1; histograms export ``_count`` / ``_sum`` plus
    quantile gauges (``quantile="0.5|0.95|0.99"``) — summary-style, since the
    log buckets are an internal representation.
    """
    lines: List[str] = []
    for name, rows in snapshot.get("counters", {}).items():
        lines.append(f"# TYPE {_prom_name(name)} counter")
        for row in rows:
            lines.append(
                f"{_prom_name(name)}{_prom_tags(row.get('tags', {}))} {row['value']:g}"
            )
    for name, rows in snapshot.get("gauges", {}).items():
        lines.append(f"# TYPE {_prom_name(name)} gauge")
        for row in rows:
            lines.append(
                f"{_prom_name(name)}{_prom_tags(row.get('tags', {}))} {row['value']:g}"
            )
    for name, rows in snapshot.get("histograms", {}).items():
        base = _prom_name(name)
        lines.append(f"# TYPE {base} summary")
        for row in rows:
            tags = dict(row.get("tags", {}))
            for q, field in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                lines.append(
                    f"{base}{_prom_tags({**tags, 'quantile': q})} {row[field]:g}"
                )
            lines.append(f"{base}_count{_prom_tags(tags)} {row['count']:g}")
            lines.append(f"{base}_sum{_prom_tags(tags)} {row['sum']:g}")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# Rendering + diffing (the CLI's meat, kept importable for tests)
# ---------------------------------------------------------------------------


def format_snapshot(snap: Dict[str, Any], max_events: int = 0) -> str:
    meta = snap.get("meta", {})
    lines = [
        f"obs snapshot [{meta.get('name', '?')}] "
        f"sample_rate={meta.get('sample_rate', 1.0)}"
    ]
    counters = snap.get("counters", {})
    if counters:
        lines.append("counters:")
        for name, rows in counters.items():
            for row in rows:
                lines.append(f"  {name}{_fmt_tags(row)} = {row['value']:g}")
    gauges = snap.get("gauges", {})
    if gauges:
        lines.append("gauges:")
        for name, rows in gauges.items():
            for row in rows:
                lines.append(f"  {name}{_fmt_tags(row)} = {row['value']:g}")
    hists = snap.get("histograms", {})
    if hists:
        lines.append("histograms (s):")
        for name, rows in hists.items():
            for row in rows:
                lines.append(
                    f"  {name}{_fmt_tags(row)}: n={row['count']} "
                    f"p50={row['p50']:.3g} p95={row['p95']:.3g} "
                    f"p99={row['p99']:.3g} mean={row['mean']:.3g}"
                )
    warnings = snap.get("warnings", [])
    for w in warnings:
        extra = {k: v for k, v in w.items()
                 if k not in ("ts", "kind", "name", "key")}
        lines.append(f"  WARNING {w.get('name')} [{w.get('key', '')}] {extra}")
    if max_events:
        spans = [e for e in snap.get("events", []) if e.get("kind") == "span"]
        for ev in spans[-max_events:]:
            lines.append(
                f"  span {ev.get('name')}#{ev.get('span_id')} "
                f"parent={ev.get('parent_id')} dur={ev.get('dur_s', 0):.4g}s"
            )
    return "\n".join(lines)


def _fmt_tags(row: Dict[str, Any]) -> str:
    tags = row.get("tags", {})
    if not tags:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(tags.items())) + "}"


def diff_snapshots(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Structured b-minus-a: counter deltas, gauge moves, percentile shifts.

    The drift-adjacent workflow: export a snapshot after the canary run and
    after the suspect run, diff them, and the shifted histograms name where
    the time went.
    """
    out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}

    def rows_by_tags(section, name):
        return {
            tuple(sorted(r.get("tags", {}).items())): r
            for r in section.get(name, [])
        }

    for name in sorted(set(a.get("counters", {})) | set(b.get("counters", {}))):
        ra, rb = rows_by_tags(a.get("counters", {}), name), rows_by_tags(
            b.get("counters", {}), name)
        for tkey in sorted(set(ra) | set(rb)):
            va = ra.get(tkey, {}).get("value", 0.0)
            vb = rb.get(tkey, {}).get("value", 0.0)
            if va != vb:
                out["counters"].setdefault(name, []).append(
                    {"tags": dict(tkey), "a": va, "b": vb, "delta": vb - va}
                )
    for name in sorted(set(a.get("gauges", {})) | set(b.get("gauges", {}))):
        ra, rb = rows_by_tags(a.get("gauges", {}), name), rows_by_tags(
            b.get("gauges", {}), name)
        for tkey in sorted(set(ra) | set(rb)):
            va = ra.get(tkey, {}).get("value", 0.0)
            vb = rb.get(tkey, {}).get("value", 0.0)
            if va != vb:
                out["gauges"].setdefault(name, []).append(
                    {"tags": dict(tkey), "a": va, "b": vb, "delta": vb - va}
                )
    for name in sorted(set(a.get("histograms", {})) | set(b.get("histograms", {}))):
        ra, rb = rows_by_tags(a.get("histograms", {}), name), rows_by_tags(
            b.get("histograms", {}), name)
        for tkey in sorted(set(ra) | set(rb)):
            pa, pb = ra.get(tkey), rb.get(tkey)
            row = {"tags": dict(tkey)}
            changed = False
            for field in ("count", "p50", "p95", "p99", "mean"):
                va = pa.get(field, 0.0) if pa else 0.0
                vb = pb.get(field, 0.0) if pb else 0.0
                row[field] = {"a": va, "b": vb, "delta": vb - va}
                changed = changed or va != vb
                if field != "count" and va > 0:
                    row[field]["ratio"] = vb / va
            if changed:
                out["histograms"].setdefault(name, []).append(row)
    return out


def format_diff(diff: Dict[str, Any]) -> str:
    lines = ["obs diff (b - a):"]
    for name, rows in diff.get("counters", {}).items():
        for row in rows:
            lines.append(
                f"  {name}{_fmt_tags(row)}: {row['a']:g} -> {row['b']:g} "
                f"({row['delta']:+g})"
            )
    for name, rows in diff.get("gauges", {}).items():
        for row in rows:
            lines.append(
                f"  {name}{_fmt_tags(row)}: {row['a']:g} -> {row['b']:g} "
                f"({row['delta']:+g})"
            )
    for name, rows in diff.get("histograms", {}).items():
        for row in rows:
            p50 = row["p50"]
            ratio = p50.get("ratio")
            shift = f" ({ratio:.2f}x)" if ratio else ""
            lines.append(
                f"  {name}{_fmt_tags(row)}: p50 {p50['a']:.3g} -> "
                f"{p50['b']:.3g}{shift}, p99 {row['p99']['a']:.3g} -> "
                f"{row['p99']['b']:.3g}"
            )
    if len(lines) == 1:
        lines.append("  (no differences)")
    return "\n".join(lines)
