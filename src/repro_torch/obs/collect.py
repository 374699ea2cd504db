"""The observability collector: scoped metrics registry + bounded event log.

The port of ``repro.obs.collect``. One :class:`ObsCollector` owns a
tagged-metric registry (counters / gauges / histograms from
:mod:`.metrics`) and a bounded ring buffer of structured events.
Collectors live on a contextvar stack exactly like
:class:`repro_torch.core.runtime.TunedRuntime` — ``with obs.collect(...)``
scopes one over a region, nested scopes win, threads and asyncio tasks are
isolated, and a fresh thread falls back to the process-default collector.

The process-default collector is **disabled**: every module-level recording
helper (``counter`` / ``gauge`` / ``observe`` / ``event`` / ``span``) starts
with one ``enabled`` check and returns immediately, so instrumented hot
paths cost a contextvar read + a branch when nobody is collecting.
Warnings are the one exception: :func:`warn_once` is for rare structural
hazards (a quarantined dispatch site, a degraded engine) and records + logs
exactly once per (collector, name, key) even when metric collection is
off, so the hazard is never silently dropped.

Sampling: high-frequency call sites (per-token serving paths) gate on
:meth:`ObsCollector.sample`, a deterministic 1-in-N tick driven by
``sample_rate`` — the "default sampling" configuration is ``1.0`` (record
everything); a loaded fleet dials it down without touching call sites.
"""
from __future__ import annotations

import collections
import contextvars
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import Counter, Gauge, Histogram, render_tags, tags_key

log = logging.getLogger("repro_torch.obs")

_EVENT_KINDS = ("event", "span", "warning")


class Event(dict):
    """One structured event: a plain dict (JSONL-friendly) with a schema.

    Keys: ``ts`` (unix seconds), ``kind`` (``event | span | warning``),
    ``name``, plus free-form fields; span events carry ``span_id`` /
    ``parent_id`` / ``dur_s`` so a tree can be rebuilt offline.
    """


class ObsCollector:
    """Scoped metrics registry + bounded event ring buffer."""

    def __init__(
        self,
        name: str = "obs",
        enabled: bool = True,
        sample_rate: float = 1.0,
        max_events: int = 4096,
        profiler_annotations: bool = False,
    ):
        self.name = name
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.profiler_annotations = bool(profiler_annotations)
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._events: "collections.deque[Event]" = collections.deque(
            maxlen=self.max_events
        )
        self._warned: set = set()
        self._tick = 0
        self.created = time.time()

    # -- scoping (token-free, mirroring TunedRuntime) -------------------------
    def __enter__(self) -> "ObsCollector":
        _stack.set(_stack.get() + (self,))
        return self

    def __exit__(self, *exc) -> None:
        s = _stack.get()
        for i in range(len(s) - 1, -1, -1):
            if s[i] is self:
                _stack.set(s[:i] + s[i + 1:])
                return

    # -- sampling -------------------------------------------------------------
    def sample(self) -> bool:
        """Deterministic 1-in-N gate for high-frequency sites (per-token
        paths). ``sample_rate >= 1`` always records; ``0`` never does."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        n = max(1, int(round(1.0 / self.sample_rate)))
        self._tick += 1
        return self._tick % n == 0

    # -- metrics --------------------------------------------------------------
    def _metric(self, cls, name: str, tags: Dict[str, Any]):
        key = (cls.kind, name, tags_key(tags))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics.setdefault(key, cls())
        return m

    def counter(self, name: str, n: float = 1.0, **tags: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._metric(Counter, name, tags).add(n)

    def gauge(self, name: str, value: float, **tags: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._metric(Gauge, name, tags).set(value)

    def observe(self, name: str, value: float, **tags: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._metric(Histogram, name, tags).observe(value)

    # -- events ---------------------------------------------------------------
    def event(self, name: str, kind: str = "event", **fields: Any) -> None:
        if not self.enabled and kind != "warning":
            return
        self.record_event(name, kind, **fields)

    def record_event(self, name: str, kind: str = "event", **fields: Any) -> None:
        if kind not in _EVENT_KINDS:
            raise ValueError(f"event kind {kind!r} not in {_EVENT_KINDS}")
        ev = Event(ts=time.time(), kind=kind, name=name, **fields)
        with self._lock:
            self._events.append(ev)

    def warn_once(self, name: str, key: str = "", **fields: Any) -> bool:
        """Structured one-time warning: ring-buffer event (kind="warning") +
        one ``logging`` line, deduped per (name, key) on this collector.
        Fires even when metric collection is disabled — hazards must not
        vanish just because nobody asked for metrics. Returns True when this
        call was the one that fired."""
        dedup = (name, key)
        with self._lock:
            if dedup in self._warned:
                return False
            self._warned.add(dedup)
        self.record_event(name, kind="warning", key=key, **fields)
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        log.warning("%s [%s] %s", name, key, detail)
        return True

    def events(self, kind: Optional[str] = None) -> List[Event]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        return evs

    # -- export ---------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Serializable state: tagged metric rows + the event ring buffer."""
        out: Dict[str, Any] = {
            "meta": {
                "name": self.name,
                "enabled": self.enabled,
                "sample_rate": self.sample_rate,
                "created": self.created,
                "exported": time.time(),
            },
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        section = {"counter": "counters", "gauge": "gauges",
                   "histogram": "histograms"}
        with self._lock:
            for (kind, name, tkey), m in sorted(
                self._metrics.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2])
            ):
                row = {"tags": render_tags(tkey), **m.snapshot()}
                out[section[kind]].setdefault(name, []).append(row)
            out["events"] = [dict(e) for e in self._events]
        out["warnings"] = [e for e in out["events"] if e.get("kind") == "warning"]
        return out

    def write(self, path: str) -> None:
        """JSON snapshot — the ``--metrics-out`` artifact that
        ``python -m repro_torch.obs report`` renders."""
        from .export import write_snapshot

        write_snapshot(self.snapshot(), path)

    def write_jsonl(self, path: str) -> None:
        from .export import write_jsonl

        write_jsonl(self.events(), path)

    def write_prom(self, path: str) -> None:
        from .export import write_prom

        write_prom(self.snapshot(), path)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._events.clear()
            self._warned.clear()
            self._tick = 0

    def __repr__(self) -> str:
        state = "enabled" if self.enabled else "disabled"
        return (f"<ObsCollector {self.name} {state} "
                f"sample={self.sample_rate} metrics={len(self._metrics)}>")


# ---------------------------------------------------------------------------
# Context-local stack + process default
# ---------------------------------------------------------------------------

_stack: "contextvars.ContextVar[Tuple[ObsCollector, ...]]" = contextvars.ContextVar(
    "repro_torch_obs_stack", default=()
)

_default_lock = threading.Lock()
_default: Optional[ObsCollector] = None


def _default_collector() -> ObsCollector:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                # Disabled by default: instrumentation must be free unless
                # somebody scopes an enabled collector (the overhead
                # contract). warn_once still records through it.
                _default = ObsCollector(name="default", enabled=False)
    return _default


def current_collector() -> ObsCollector:
    """The innermost active collector, or the (disabled) process default."""
    s = _stack.get()
    return s[-1] if s else _default_collector()


def collect(
    name: str = "obs",
    enabled: bool = True,
    sample_rate: float = 1.0,
    max_events: int = 4096,
    profiler_annotations: bool = False,
) -> ObsCollector:
    """Create a scoped collector (use as ``with obs.collect(...) as col``)."""
    return ObsCollector(
        name=name, enabled=enabled, sample_rate=sample_rate,
        max_events=max_events, profiler_annotations=profiler_annotations,
    )


def enabled() -> bool:
    """Fast ambient check: is anything collecting here?"""
    return current_collector().enabled


# Module-level conveniences: record on whatever collector is ambient.
def counter(name: str, n: float = 1.0, **tags: Any) -> None:
    current_collector().counter(name, n, **tags)


def gauge(name: str, value: float, **tags: Any) -> None:
    current_collector().gauge(name, value, **tags)


def observe(name: str, value: float, **tags: Any) -> None:
    current_collector().observe(name, value, **tags)


def event(name: str, **fields: Any) -> None:
    current_collector().event(name, **fields)


def warn_once(name: str, key: str = "", **fields: Any) -> bool:
    return current_collector().warn_once(name, key=key, **fields)
