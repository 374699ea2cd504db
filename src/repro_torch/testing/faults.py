"""Deterministic fault injection for the port's dispatch plane.

A copy of ``repro.testing.faults`` (the port imports nothing of the JAX
package, though that module is stdlib-only). A :class:`FaultPlan` is a
seeded list of :class:`FaultRule` entries, each naming an injection *site*
(fnmatch pattern) and a failure *kind*. Code under test declares its sites
with :func:`fault_point`::

    fault_point("dispatch.kernel:matmul", tier="exact")

and the active plan decides, deterministically from its seed and the
per-site call count, whether that call fails. Sites wired in the port:

    dispatch.kernel:<tunable>     runtime kernel execution (guarded or not)
    campaign.job:<kernel>         campaign runner job attempt
    db.load:<path>                tuning-database file read

The JAX package's ``bgtune.worker:<kernel>``, ``checkpoint.write:<step>``
and ``train.step:<step>`` come with the port's background tuner,
checkpointer and recovery loop.

Fault kinds:

    error     raise :class:`InjectedFault` (an ordinary ``Exception`` —
              what guards/retries are expected to absorb)
    nan       return the rule to the call site, which must corrupt its
              concrete output with NaNs (the non-finite-probe drill)
    latency   ``time.sleep(rule.delay_s)`` then continue (straggler /
              timeout drill)
    crash     raise :class:`InjectedWorkerCrash` — a ``BaseException``
              that escapes ``except Exception`` retry loops, killing the
              worker thread it fires on (crash-isolation drill)
    torn      raise ``ValueError`` mimicking a torn/corrupt file read
              (what ``json.load`` raises on a half-written file)

Activation is contextvar-scoped (``with plan:``) so concurrent tests are
isolated; a plan can additionally be installed process-globally
(``plan.install()``) for worker threads that start with a fresh context.
Every firing is recorded in ``plan.fired`` so tests can assert exactly
which faults were exercised. With no plan active, :func:`fault_point` is
one module-global bool check — the production hot path stays free.

This module is stdlib-only by design: the dispatch runtime imports it at
module scope and must not gain a dependency cycle (or a torch import).
"""
from __future__ import annotations

import contextvars
import dataclasses
import fnmatch
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple


class InjectedFault(RuntimeError):
    """A seeded, injected failure — ordinary Exception; guards absorb it."""


class InjectedWorkerCrash(BaseException):
    """An injected crash that escapes ``except Exception`` retry loops.

    Raised for kind="crash": the thread it fires on dies (its top-level
    ``except Exception`` cannot catch a BaseException), which is exactly
    the condition worker-isolation logic must survive.
    """


_KINDS = ("error", "nan", "latency", "crash", "torn")


@dataclasses.dataclass
class FaultRule:
    """One injection rule: where, what, and how often.

    ``site`` is an fnmatch pattern against the call site's name
    (``"dispatch.kernel:matmul*"``). ``when`` optionally narrows by the
    site's context fields (fnmatch per value — e.g. ``{"tier": "exact"}``
    fires only when the guarded call runs a stored record, leaving the
    heuristic fall-through healthy). ``p`` is the per-eligible-call firing
    probability drawn from the plan's seeded stream; ``after`` skips the
    first N eligible calls and ``times`` caps total firings, so "fail the
    3rd save, once" is expressible and exactly reproducible.
    """

    site: str
    kind: str = "error"
    p: float = 1.0
    times: Optional[int] = None
    after: int = 0
    delay_s: float = 0.0
    when: Dict[str, str] = dataclasses.field(default_factory=dict)
    message: str = ""
    # runtime state
    seen: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {_KINDS}")

    def matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        if not fnmatch.fnmatchcase(site, self.site):
            return False
        for k, pat in self.when.items():
            if not fnmatch.fnmatchcase(str(ctx.get(k, "")), str(pat)):
                return False
        return True


class FaultPlan:
    """A seeded set of fault rules, activatable as a context manager.

    Deterministic: the same plan (rules + seed) against the same sequence
    of :func:`fault_point` calls fires the same faults. ``fired`` keeps
    ``(site, kind, rule_index)`` tuples in firing order for assertions.
    """

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0, name: str = "faults"):
        self.rules: List[FaultRule] = list(rules)
        self.seed = int(seed)
        self.name = name
        self.fired: List[Tuple[str, str, int]] = []
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    # -- activation -----------------------------------------------------------
    def __enter__(self) -> "FaultPlan":
        global _enabled
        _ctx.set(_ctx.get() + (self,))
        _enabled = True
        return self

    def __exit__(self, *exc) -> None:
        s = _ctx.get()
        for i in range(len(s) - 1, -1, -1):
            if s[i] is self:
                _ctx.set(s[:i] + s[i + 1:])
                break
        _refresh_enabled()

    def install(self) -> "FaultPlan":
        """Also activate process-globally: worker threads start with a fresh
        contextvar context and would otherwise never see a scoped plan."""
        global _global_plan, _enabled
        _global_plan = self
        _enabled = True
        return self

    def uninstall(self) -> None:
        global _global_plan
        if _global_plan is self:
            _global_plan = None
        _refresh_enabled()

    # -- consultation ---------------------------------------------------------
    def consult(self, site: str, ctx: Dict[str, Any]) -> Optional[FaultRule]:
        with self._lock:
            for i, rule in enumerate(self.rules):
                if not rule.matches(site, ctx):
                    continue
                rule.seen += 1
                if rule.seen <= rule.after:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                self.fired.append((site, rule.kind, i))
                return rule
        return None

    def count(self, site_pattern: str = "*", kind: Optional[str] = None) -> int:
        return sum(
            1 for s, k, _ in self.fired
            if fnmatch.fnmatchcase(s, site_pattern) and (kind is None or k == kind)
        )

    def __repr__(self) -> str:
        return (f"<FaultPlan {self.name} seed={self.seed} "
                f"rules={len(self.rules)} fired={len(self.fired)}>")


# ---------------------------------------------------------------------------
# Activation plumbing
# ---------------------------------------------------------------------------

_ctx: "contextvars.ContextVar[Tuple[FaultPlan, ...]]" = contextvars.ContextVar(
    "repro_torch_fault_plans", default=()
)
_global_plan: Optional[FaultPlan] = None
# Module-global fast path: False means no plan has been active anywhere, so
# fault_point is a single bool check on production hot paths.
_enabled = False


def _refresh_enabled() -> None:
    global _enabled
    _enabled = bool(_ctx.get()) or _global_plan is not None


def active_plan() -> Optional[FaultPlan]:
    """The innermost scoped plan, else the process-global one, else None."""
    s = _ctx.get()
    if s:
        return s[-1]
    return _global_plan


def fault_point(site: str, **ctx: Any) -> Optional[FaultRule]:
    """Declare one injection site; enact whatever the active plan says.

    Raises :class:`InjectedFault` (kind="error"), ``ValueError``
    (kind="torn"), or :class:`InjectedWorkerCrash` (kind="crash"); sleeps
    for kind="latency"; returns the rule for kinds the *call site* must
    enact itself (kind="nan" — only the site knows its output value).
    Returns None when nothing fires.
    """
    if not _enabled:
        return None
    plan = active_plan()
    if plan is None:
        return None
    rule = plan.consult(site, ctx)
    if rule is None:
        return None
    if rule.kind == "error":
        raise InjectedFault(rule.message or f"injected fault at {site}")
    if rule.kind == "crash":
        raise InjectedWorkerCrash(rule.message or f"injected crash at {site}")
    if rule.kind == "torn":
        raise ValueError(rule.message or f"injected torn read at {site}")
    if rule.kind == "latency":
        time.sleep(rule.delay_s)
        return rule
    return rule  # "nan": the site corrupts its own (concrete) output
