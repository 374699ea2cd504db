"""Tracing spans: a contextvar-scoped span tree over the hot paths.

The port of ``repro.obs.trace``.

``obs.span("train.step")`` opens one node; nested spans (including across
``await`` points and never across threads — contextvars give the same
isolation the dispatch runtime relies on) record their parent, so the ring
buffer's span events rebuild into a tree offline (``python -m
repro_torch.obs report`` renders the top names).

Each completed span lands twice on the ambient collector:

* histogram ``span.<name>`` — duration distribution (p50/p95/p99). Tags are
  deliberately NOT attached to the histogram: span callers pass per-call
  fields (step numbers, request ids) whose cardinality would explode the
  registry; those go on the event instead.
* event ``kind="span"`` — ``{name, dur_s, span_id, parent_id, **tags}`` in
  the bounded ring buffer.

Opt-in profiler visibility: a collector created with
``profiler_annotations=True`` wraps every span in
``torch.profiler.record_function(name)``, so spans show up as named ranges
in a torch.profiler window next to the kernels they enclose. (The JAX
package's flag is ``xla_annotations``, around ``jax.profiler.
TraceAnnotation``.) Failure to import/enter the annotation is swallowed —
tracing must never take down the workload.

A disabled collector short-circuits before any allocation: the span body
runs bare, and ``yield`` sees ``None``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import time
from typing import Any, Dict, Iterator, Optional

from .collect import current_collector

_ids = itertools.count(1)

_span_ctx: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "repro_torch_obs_span", default=None
)


@dataclasses.dataclass
class Span:
    """One live span node (exposed so callers can attach fields mid-span)."""

    name: str
    span_id: int
    parent_id: Optional[int]
    tags: Dict[str, Any]
    t0: float = 0.0

    def set(self, **fields: Any) -> None:
        """Attach fields to the span's completion event."""
        self.tags.update(fields)


def current_span() -> Optional[Span]:
    return _span_ctx.get()


@contextlib.contextmanager
def span(name: str, **tags: Any) -> Iterator[Optional[Span]]:
    """Open one span on the ambient collector (no-op when disabled)."""
    col = current_collector()
    if not col.enabled:
        yield None
        return
    parent = _span_ctx.get()
    sp = Span(
        name=name,
        span_id=next(_ids),
        parent_id=parent.span_id if parent is not None else None,
        tags=dict(tags),
    )
    tok = _span_ctx.set(sp)
    ann = None
    if col.profiler_annotations:
        try:
            from torch.profiler import record_function

            ann = record_function(name)
            ann.__enter__()
        except Exception:
            ann = None
    sp.t0 = time.perf_counter()
    try:
        yield sp
    finally:
        dur = time.perf_counter() - sp.t0
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception:
                pass
        _span_ctx.reset(tok)
        col.observe(f"span.{name}", dur)
        col.event(
            name, kind="span", dur_s=dur, span_id=sp.span_id,
            parent_id=sp.parent_id, **sp.tags,
        )


def span_tree(events) -> Dict[Optional[int], list]:
    """Group span events by parent_id — the offline tree view the CLI
    renders (children keyed under their parent's span_id; roots under
    ``None``)."""
    tree: Dict[Optional[int], list] = {}
    for ev in events:
        if ev.get("kind") != "span":
            continue
        tree.setdefault(ev.get("parent_id"), []).append(ev)
    return tree
