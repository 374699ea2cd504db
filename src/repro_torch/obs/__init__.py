"""repro_torch.obs — the observability plane of the port.

The port of ``repro.obs`` without its drift detector (which needs the
analytic cost model, not ported yet). Two coordinated layers, scoped and
thread-isolated the same way the dispatch runtime is:

* **tracing** (:mod:`.trace`) — ``obs.span("serve.admit")`` context
  managers build a contextvar-scoped span tree; each span lands in a
  log-bucketed latency histogram plus a bounded ring buffer of structured
  events, and may opt into ``torch.profiler.record_function`` so spans
  appear as named ranges in a torch.profiler window.
* **metrics** (:mod:`.metrics` via :class:`.ObsCollector`) — counters,
  gauges and log-bucketed histograms (p50/p95/p99 without unbounded
  memory), recorded at the hot paths: dispatch resolution (per-tier
  latency, cache hit/miss), the guard's quarantines, trainer steps,
  serving ticks and requests, and campaign jobs.

The *default* collector is disabled, and every recording path begins with
a single ``enabled`` check. Scoping mirrors ``repro_torch.runtime``::

    import repro_torch.obs as obs

    with obs.collect(name="serve") as col:
        engine.serve()
    col.write("metrics.json")          # python -m repro_torch.obs report

Exports: JSON snapshot (``write``), JSONL event sink (``write_jsonl``),
Prometheus textfile (``write_prom``); ``python -m repro_torch.obs
report/diff`` renders and compares snapshots.
"""
from .collect import (  # noqa: F401
    Event,
    ObsCollector,
    collect,
    counter,
    current_collector,
    enabled,
    event,
    gauge,
    observe,
    warn_once,
)
from .metrics import Counter, Gauge, Histogram  # noqa: F401
from .trace import current_span, span  # noqa: F401

__all__ = [
    "Counter",
    "Event",
    "Gauge",
    "Histogram",
    "ObsCollector",
    "collect",
    "counter",
    "current_collector",
    "current_span",
    "enabled",
    "event",
    "gauge",
    "observe",
    "span",
    "warn_once",
]
