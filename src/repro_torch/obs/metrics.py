"""Metric primitives: counters, gauges, log-bucketed latency histograms.

A copy of ``repro.obs.metrics``: the same buckets, so a histogram here
reports the same quantiles as the JAX package's on the same samples.

The histogram is the piece that earns its keep: serving latencies and
dispatch-resolution times need p50/p95/p99 over unbounded streams, but an
engine serving millions of requests cannot keep every sample. Log-spaced
buckets (4 per octave, ~9% relative error at the bucket midpoint) give
quantiles in O(buckets) memory regardless of stream length — the standard
HDR/Prometheus trade, sized for microseconds-to-minutes latencies.

These classes are deliberately lock-free: the owning
:class:`repro_torch.obs.collect.ObsCollector` serializes mutation under its own
lock, so the primitives stay cheap enough for hot paths.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

# 4 buckets per octave: bucket i covers [GROWTH**i, GROWTH**(i+1)).
_GROWTH = 2.0 ** 0.25
_LOG_GROWTH = math.log(_GROWTH)
# Values at or below this floor share one underflow bucket (index _MIN_IDX):
# nothing we time is meaningfully below a nanosecond.
_MIN_IDX = -120


class Counter:
    """Monotonic count (events, tokens, dispatches)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def add(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self.value}


class Gauge:
    """Last-written value (queue depth, slot occupancy, tokens/s)."""

    __slots__ = ("value", "updates")
    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0
        self.updates = 0

    def set(self, v: float) -> None:
        self.value = float(v)
        self.updates += 1

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self.value, "updates": self.updates}


class Histogram:
    """Log-bucketed distribution with O(buckets) memory quantiles."""

    __slots__ = ("count", "sum", "min", "max", "_buckets")
    kind = "histogram"

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}

    @staticmethod
    def _index(v: float) -> int:
        if v <= 0.0:
            return _MIN_IDX
        return max(_MIN_IDX, int(math.floor(math.log(v) / _LOG_GROWTH)))

    @staticmethod
    def _midpoint(idx: int) -> float:
        if idx <= _MIN_IDX:
            return 0.0
        return _GROWTH ** (idx + 0.5)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        idx = self._index(v)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (bucket geometric midpoint, clamped to the
        observed min/max so tiny samples don't report beyond the data)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= target:
                return min(max(self._midpoint(idx), self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram in (snapshot merging across resumed runs)."""
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for idx, n in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + n

    def snapshot(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


def tags_key(tags: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    """Canonical (sorted, stringified) form of a tag set — the registry key."""
    return tuple(sorted((k, str(v)) for k, v in tags.items()))


def render_tags(key: Tuple[Tuple[str, str], ...]) -> Dict[str, str]:
    return dict(key)


def percentile_row(snapshot: Dict[str, Any], name: str,
                   tags: Optional[Dict[str, str]] = None) -> Optional[Dict[str, Any]]:
    """Pull one histogram row (matching `tags`, or the only row) out of an
    :meth:`ObsCollector.snapshot` dict — the helper the launchers' stats
    reports use to print p50/p95/p99 without re-walking the schema."""
    rows: List[Dict[str, Any]] = snapshot.get("histograms", {}).get(name, [])
    if not rows:
        return None
    if tags is None:
        return rows[0]
    want = {k: str(v) for k, v in tags.items()}
    for row in rows:
        if all(row.get("tags", {}).get(k) == v for k, v in want.items()):
            return row
    return None
