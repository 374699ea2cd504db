"""Persistent tuning database: records keyed by (kernel, platform, shape
bucket, dtype).

Same JSON schema (version 2) and key format as ``repro.core.database``, so
one file can hold both packages' records under their own platform keys and
the JAX package's campaign tooling reads the port's records. Each dim is
bucketed to the next power of two (dims <= 8 kept exact) so serving's
varying shapes hit a record.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import tempfile
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..testing.faults import fault_point as _fault_point

log = logging.getLogger("repro_torch.database")

SCHEMA_VERSION = 2


def atomic_write_json(path: str, blob: Dict[str, Any]) -> None:
    """Write-to-temp + rename so readers never see a torn file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def shape_bucket(shape: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for d in shape:
        d = int(d)
        if d <= 8:
            out.append(d)
        else:
            p = 1
            while p < d:
                p <<= 1
            out.append(p)
    return tuple(out)


def make_key(
    kernel: str,
    platform: str,
    shapes: Sequence[Sequence[int]],
    dtype: str,
    extra: str = "",
) -> str:
    sh = "/".join("x".join(map(str, shape_bucket(s))) for s in shapes)
    key = f"{kernel}|{platform}|{sh}|{dtype}"
    if extra:
        key += f"|{extra}"
    return key


def split_key(key: str) -> Tuple[str, str, Tuple[Tuple[int, ...], ...], str, str]:
    """Inverse of :func:`make_key`: (kernel, platform, shapes, dtype, extra)."""
    parts = key.split("|")
    kernel, platform = parts[0], parts[1] if len(parts) > 1 else "?"
    shapes: Tuple[Tuple[int, ...], ...] = ()
    if len(parts) > 2 and parts[2]:
        shapes = tuple(tuple(int(d) for d in s.split("x") if d)
                       for s in parts[2].split("/") if s)
    dtype = parts[3] if len(parts) > 3 else ""
    extra = "|".join(parts[4:]) if len(parts) > 4 else ""
    return kernel, platform, shapes, dtype, extra


def shape_distance(a: Sequence[Sequence[int]], b: Sequence[Sequence[int]]) -> float:
    """Sum over all dims of |log2(a_d) - log2(b_d)| between two bucketed
    shape tuples; infinite when the ranks differ."""
    if len(a) != len(b):
        return math.inf
    total = 0.0
    for sa, sb in zip(a, b):
        if len(sa) != len(sb):
            return math.inf
        for da, db in zip(sa, sb):
            da, db = max(int(da), 1), max(int(db), 1)
            total += abs(math.log2(da) - math.log2(db))
    return total


@dataclasses.dataclass
class Record:
    key: str
    config: Dict[str, Any]
    objective: float                  # seconds (lower is better)
    evaluator: str                    # 'wallclock' | 'costmodel'
    evaluations: int                  # search cost that produced this record
    timestamp: float
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Record":
        return Record(**d)


class TuningDatabase:
    """JSON-file-backed store with atomic writes and an in-memory cache.

    Cover sets ("kernel|platform" -> entries ``{"config", "support",
    "share"}``, broadest first) are the campaign's fallback for shape
    buckets it never tuned (the ``CoverSet`` tier).
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._records: Dict[str, Record] = {}
        self._covers: Dict[str, List[Dict[str, Any]]] = {}
        if path and os.path.exists(path):
            self._load()

    def _load(self) -> None:
        # A torn or foreign file degrades to an empty database: records are
        # always recoverable by re-tuning.
        try:
            _fault_point(f"db.load:{self.path}")
            with open(self.path) as f:
                blob = json.load(f)
        except (ValueError, OSError) as e:
            log.warning("tuning db %s unreadable (%s: %s); starting empty",
                        self.path, type(e).__name__, e)
            return
        if blob.get("schema", 0) != SCHEMA_VERSION:
            log.warning("tuning db %s has schema %s != %s; ignoring its records",
                        self.path, blob.get("schema", 0), SCHEMA_VERSION)
            return
        self._records = {
            k: Record.from_json(v) for k, v in blob.get("records", {}).items()
        }
        self._covers = dict(blob.get("covers", {}))

    def save(self) -> None:
        if not self.path:
            return
        blob: Dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "records": {k: r.to_json() for k, r in self._records.items()},
        }
        if self._covers:
            blob["covers"] = self._covers
        atomic_write_json(self.path, blob)

    def lookup(self, key: str) -> Optional[Record]:
        return self._records.get(key)

    def put(self, record: Record, save: bool = True) -> None:
        with self._lock:
            prev = self._records.get(record.key)
            # Keep the better record: a noisy re-tune must not clobber a
            # good stored winner.
            if prev is None or record.objective <= prev.objective:
                self._records[record.key] = record
            if save:
                self.save()

    def keys(self) -> Iterable[str]:
        return list(self._records)

    def records(self) -> List[Record]:
        return list(self._records.values())

    def __len__(self) -> int:
        return len(self._records)

    # -- cover sets ---------------------------------------------------------
    @staticmethod
    def cover_key(kernel: str, platform: str) -> str:
        return f"{kernel}|{platform}"

    def covers(self) -> Dict[str, List[Dict[str, Any]]]:
        return {k: [dict(e) for e in v] for k, v in self._covers.items()}

    def put_cover(self, kernel: str, platform: str, entries: Sequence[Dict[str, Any]],
                  save: bool = True) -> None:
        """Store the cover set of (kernel, platform), broadest entry first."""
        with self._lock:
            self._covers[self.cover_key(kernel, platform)] = [dict(e) for e in entries]
            if save:
                self.save()

    def lookup_cover(self, kernel: str, platform: str,
                     shapes: Optional[Sequence[Sequence[int]]] = None) -> List[Dict[str, Any]]:
        """Cover entries of (kernel, platform); with ``shapes``, nearest
        support first (least log2 distance of the bucketed shapes), ties in
        stored order."""
        entries = self._covers.get(self.cover_key(kernel, platform), [])
        if shapes is None:
            return [dict(e) for e in entries]
        q = tuple(shape_bucket(s) for s in shapes)

        def dist(entry: Dict[str, Any]) -> float:
            ds = [shape_distance(q, [tuple(dim) for dim in sup])
                  for sup in entry.get("support") or []]
            ds = [d for d in ds if d < math.inf]
            return min(ds) if ds else math.inf

        order = sorted(range(len(entries)), key=lambda i: (dist(entries[i]), i))
        return [dict(entries[i]) for i in order]

    # -- bulk ---------------------------------------------------------------
    def export(self, path: str, platform: Optional[str] = None) -> "TuningDatabase":
        """Write a standalone database at ``path`` holding one platform's
        records and cover sets (all of them when ``platform`` is None): the
        file a deployment ships beside the code."""
        out = TuningDatabase(None)
        for rec in self.records():
            if platform is None or split_key(rec.key)[1] == platform:
                out.put(rec, save=False)
        out._covers = {k: [dict(e) for e in v] for k, v in self._covers.items()
                       if platform is None or k.split("|")[-1] == platform}
        out.path = path
        out.save()
        return out


def now() -> float:
    return time.time()
