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
import os
import tempfile
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

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

    Cover sets written by the JAX campaign tooling are carried through load
    and save untouched; the port reads none yet.
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


def now() -> float:
    return time.time()
