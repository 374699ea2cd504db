"""The dispatch runtime: scoped tuned contexts and resolution policies.

A :class:`TunedRuntime` pins a tuning database, a mode (``"kernel"`` or
``"reference"``) and a resolution policy for everything run under ``with``
it. Runtimes nest (inner wins; unspecified fields inherit from the runtime
active at construction) and live on a context-local stack, so each thread
and each task sees its own scope.

Resolution runs a pipeline of policies, ``ExactHit -> TuneNow -> CoverSet
-> Heuristic -> Reference`` by default (TuneNow acts only where tuning is
allowed), with a bounded LRU cache of resolutions per runtime (and an
optional time to live). Keys are namespaced by the platform of the call's
device unless the runtime pins ``platform=``. :class:`Telemetry` counts
which tier served each kernel x bucket, per dispatch phase (``fwd``,
``bwd``, ``opt``).

A kernel-mode dispatch is differentiable: the bound variant runs inside a
``torch.autograd.Function`` (:class:`KernelCall`) whose backward follows the
tunable's ``DispatchSpec.vjp``. With ``vjp="dispatch"`` the backward plan
runs under ``dispatch_phase("bwd")`` and each gradient is a dispatch site of
its own, resolved through the same runtime with its own database key; this
is the counterpart of ``repro.core.runtime._kernel_call``'s ``custom_vjp``.
A kernel writes into a fresh ``torch.empty`` output through ctypes, so
without this wrapper its output would carry no ``grad_fn`` and the layer
would silently drop out of the graph; a dispatch that has no backward and
whose inputs require grad raises instead.

Guarded execution (``guard=True``, the default, as in ``repro``): a
stored record's config that raises quarantines its database key in the
runtime's :class:`HealthBook` and the call falls through to the heuristic
config; an injected fault (:mod:`repro_torch.testing`) or a failed
non-finite probe quarantines it and the reference serves it. Any other
error of the heuristic config raises (see :meth:`TunedRuntime._guarded_call`).
Quarantines back off exponentially and re-probe when they lapse; the guard
is consulted at every eager call, so a quarantined bucket serves the
reference only until its probe succeeds. ``guard_nonfinite=True`` also
counts a non-finite output of a bucket's first (probe) execution as a
fault. ``config=`` overrides and ``guard=False`` stay unguarded. Under an
enabled :mod:`repro_torch.obs` collector each dispatch runs in a
``span("dispatch")``, resolution is timed (``dispatch.resolve_s``) and
counted (``dispatch.calls``), and a quarantine is counted and warned once.

Differences from ``repro.core.runtime``, all on purpose:

* the default mode is the kernel path; there is no environment switch;
* :class:`~repro_torch.kernels._build.KernelUnavailable` (no toolkit, a
  failed build, a library that does not load, a tensor on a device with no
  kernel) and :class:`~repro_torch.kernels._build.CudaError` (a launch the
  card refused) raise through the guard: a kernel that does not exist on
  this host is not a fault of one variant, and serving the reference in its
  place would hide it;
* the reference answers only the fault plane's faults and failed
  non-finite probes; a real error of the heuristic config raises, where
  ``repro``'s guard serves the reference for any exception;
* a call site may name its own plain version (``dispatch(...,
  reference=fn)``) for where it takes the reference tier, so a faulted
  site computes what reference mode computes there.

A sticky CUDA error (an illegal address) surfaces at a later
synchronisation, outside any guard; nothing here tries to catch it.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..obs.collect import current_collector as _obs_collector
from ..obs.trace import span as _obs_span
from ..testing import faults as _faults
from ..testing.faults import InjectedFault
from .annotate import DispatchSpec, Tunable, get_tunable
from .database import TuningDatabase, split_key
from .params import Config
from .platform import platform_key
from .tuner import _args_key, first_device

_MODES = ("kernel", "reference")


class DispatchFault(RuntimeError):
    """A guarded dispatch's own fault signal (a failed non-finite probe):
    raised and caught inside the guard, quarantining the bucket."""


# "bgtune" is the BackgroundTune tier (repro_torch.core.bgtune): a miss
# served the heuristic config while a worker tunes the bucket.
TIERS = ("override", "exact", "tune", "bgtune", "cover", "heuristic", "reference")

# Dispatch phases: forward sites, gradient sites (dispatches made while a
# backward plan runs) and the optimizer update (the trainer tags it "opt").
PHASES = ("fwd", "bwd", "opt")

_phase_ctx: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "repro_torch_dispatch_phase", default="fwd"
)


@contextlib.contextmanager
def dispatch_phase(phase: str):
    """Tag every dispatch in this scope with ``phase`` ('fwd'|'bwd'|'opt')."""
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} not in {PHASES}")
    tok = _phase_ctx.set(phase)
    try:
        yield
    finally:
        _phase_ctx.reset(tok)


def current_phase() -> str:
    return _phase_ctx.get()


@dataclasses.dataclass
class ResolutionRequest:
    """Everything a policy may consult to resolve one kernel x bucket."""

    tunable: Tunable
    args: tuple                      # canonicalized positional args
    key: str
    db: TuningDatabase
    key_extra: str = ""
    platform: str = ""
    # Per-call tuning permission (the runtime's default unless the caller
    # of resolve() overrode it, as warmup(allow_tune=True) does).
    allow_tune: bool = False
    tune_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Resolution:
    """``config=None`` means: run the reference implementation.

    ``cache=False`` keeps the resolution out of the runtime's cache (a
    quarantined bucket re-resolves at every call); ``probe=True`` asks the
    guard to validate this execution before the health book clears the
    bucket."""

    config: Optional[Config]
    tier: str
    key: Optional[str] = None
    cache: bool = True
    probe: bool = False


class ResolutionPolicy:
    """One tier: ``resolve`` returns a Resolution, or None to pass it on."""

    name = "policy"

    def resolve(self, req: ResolutionRequest) -> Optional[Resolution]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"


class ExactHit(ResolutionPolicy):
    """A stored record with a config legal for this exact key."""

    name = "exact"

    def resolve(self, req: ResolutionRequest) -> Optional[Resolution]:
        rec = req.db.lookup(req.key)
        if rec is not None and req.tunable.why_illegal(rec.config, *req.args) is None:
            return Resolution(dict(rec.config), self.name)
        return None


class TuneNow(ResolutionPolicy):
    """Tune the bucket on the spot (writes the record), where the runtime
    or the resolve() call allows it."""

    name = "tune"

    def resolve(self, req: ResolutionRequest) -> Optional[Resolution]:
        if not req.allow_tune:
            return None
        from .tuner import autotune

        res = autotune(req.tunable, req.args, db=req.db, key_extra=req.key_extra,
                       platform=req.platform, **req.tune_kwargs)
        return Resolution(dict(res.best_config), self.name)


class CoverSet(ResolutionPolicy):
    """The nearest cover-set entry whose config is legal for the call: a
    measured config for an unseen bucket."""

    name = "cover"

    def resolve(self, req: ResolutionRequest) -> Optional[Resolution]:
        shapes = split_key(req.key)[2]
        for entry in req.db.lookup_cover(req.tunable.name, req.platform, shapes):
            cfg = entry.get("config")
            if cfg is not None and req.tunable.why_illegal(cfg, *req.args) is None:
                return Resolution(dict(cfg), self.name)
        return None


class Heuristic(ResolutionPolicy):
    """The shape heuristic default. Always succeeds."""

    name = "heuristic"

    def resolve(self, req: ResolutionRequest) -> Optional[Resolution]:
        return Resolution(req.tunable.default_config(*req.args), self.name)


class Reference(ResolutionPolicy):
    """Terminal tier: run the reference implementation."""

    name = "reference"

    def resolve(self, req: ResolutionRequest) -> Optional[Resolution]:
        return Resolution(None, self.name)


def default_policy() -> Tuple[ResolutionPolicy, ...]:
    return (ExactHit(), TuneNow(), CoverSet(), Heuristic(), Reference())


@dataclasses.dataclass
class _Health:
    level: str              # "record" (this db record) | "kernel" (any variant)
    fails: int = 0
    until: float = 0.0      # monotonic stamp the quarantine lapses (probe due)
    backoff: float = 0.0    # current re-probe interval


class HealthBook:
    """Per-runtime quarantine ledger for faulting kernel executions.

    Keyed by full database keys. Two levels: ``"record"`` — the stored or
    measured config of this bucket faulted (resolution skips the database
    tiers and serves the heuristic); ``"kernel"`` — the heuristic config
    faulted too (resolution goes straight to the reference). An entry
    re-probes after an exponential backoff (capped), so a transient fault
    heals without a restart and a persistent one re-quarantines with a
    longer interval. Past ``capacity`` entries the first to lapse are
    dropped (a dropped entry costs one extra probe).
    """

    def __init__(self, base_s: float = 5.0, max_s: float = 300.0,
                 capacity: int = 1024):
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: Dict[str, _Health] = {}

    def consult(self, key: str) -> Optional[Tuple[str, str]]:
        """None when healthy; ("probe"|"blocked", level) when quarantined."""
        with self._lock:
            h = self._entries.get(key)
            if h is None:
                return None
            state = "probe" if time.monotonic() >= h.until else "blocked"
            return state, h.level

    def quarantine(self, key: str, level: str) -> _Health:
        with self._lock:
            h = self._entries.get(key)
            if h is None:
                h = self._entries[key] = _Health(level=level)
            elif level == "kernel":
                h.level = "kernel"      # escalate; never de-escalate here
            h.fails += 1
            h.backoff = min(self.max_s, self.base_s * (2 ** (h.fails - 1)))
            h.until = time.monotonic() + h.backoff
            while len(self._entries) > self.capacity:
                victim = min(self._entries, key=lambda k: self._entries[k].until)
                del self._entries[victim]
            return h

    def record_ok(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            return {
                k: {"level": h.level, "fails": h.fails,
                    "backoff_s": h.backoff, "probe_in_s": max(0.0, h.until - now)}
                for k, h in self._entries.items()
            }


class Telemetry:
    """Per-runtime counters: which tier served each kernel x bucket.

    ``tiers`` counts dispatches per tier; ``by_key`` is ``{db key: {tier:
    count}}`` (reference-mode and ``config=`` dispatches, which compute no
    key, count under ``"<kernel>|*"``); ``phases`` is ``{phase: {tier:
    count}}`` and ``by_key_phase`` ``{phase: {db key: {tier: count}}}``;
    ``cache_hits`` / ``calls`` measure the resolution cache,
    ``cache_evictions`` its bound.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.tiers: Dict[str, int] = {}
            self.by_key: Dict[str, Dict[str, int]] = {}
            self.phases: Dict[str, Dict[str, int]] = {}
            self.by_key_phase: Dict[str, Dict[str, Dict[str, int]]] = {}
            self.calls = 0
            self.cache_hits = 0
            self.cache_evictions = 0

    def record(self, kernel: str, key: Optional[str], tier: str,
               cached: bool = False, col=None) -> None:
        k = key if key is not None else f"{kernel}|*"
        phase = _phase_ctx.get()
        with self._lock:
            self.calls += 1
            self.cache_hits += int(cached)
            self.tiers[tier] = self.tiers.get(tier, 0) + 1
            per = self.by_key.setdefault(k, {})
            per[tier] = per.get(tier, 0) + 1
            ph = self.phases.setdefault(phase, {})
            ph[tier] = ph.get(tier, 0) + 1
            pk = self.by_key_phase.setdefault(phase, {}).setdefault(k, {})
            pk[tier] = pk.get(tier, 0) + 1
        # The same accounting as a tagged obs counter (one enabled check when
        # nobody collects; a dispatch hands down the collector it looked up);
        # the per-key breakdown stays here.
        col = col if col is not None else _obs_collector()
        if col.enabled:
            col.counter("dispatch.calls", kernel=kernel, tier=tier, phase=phase,
                        cached="hit" if cached else "miss")

    def record_eviction(self, count: int = 1) -> None:
        with self._lock:
            self.cache_evictions += count

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            total = self.calls or 1
            return {
                "calls": self.calls,
                "cache_hits": self.cache_hits,
                "cache_hit_rate": self.cache_hits / total if self.calls else 0.0,
                "cache_evictions": self.cache_evictions,
                "tiers": dict(self.tiers),
                "tier_rates": {t: n / total for t, n in self.tiers.items()},
                "by_key": {k: dict(v) for k, v in self.by_key.items()},
                "phases": {p: dict(v) for p, v in self.phases.items()},
                "by_key_phase": {p: {k: dict(v) for k, v in per.items()}
                                 for p, per in self.by_key_phase.items()},
            }

    def report(self) -> str:
        snap = self.snapshot()
        lines = [
            "dispatch telemetry: %d calls, %d cache hits (%.0f%%), %d evictions"
            % (snap["calls"], snap["cache_hits"], 100 * snap["cache_hit_rate"],
               snap["cache_evictions"])
        ]
        for tier in TIERS:
            if tier in snap["tiers"]:
                lines.append(f"  tier {tier:<9} {snap['tiers'][tier]}"
                             f" ({100 * snap['tier_rates'][tier]:.0f}%)")
        for phase in PHASES:
            per = snap["phases"].get(phase)
            if per:
                detail = ", ".join(f"{t}={per[t]}" for t in TIERS if t in per)
                lines.append(f"  phase {phase:<8} {sum(per.values())} ({detail})")
        for key in sorted(snap["by_key"]):
            per = snap["by_key"][key]
            detail = ", ".join(f"{t}={per[t]}" for t in TIERS if t in per)
            lines.append(f"  {key}: {detail}")
        return "\n".join(lines)


_INHERIT = object()

_stack: "contextvars.ContextVar[Tuple[TunedRuntime, ...]]" = contextvars.ContextVar(
    "repro_torch_runtime_stack", default=()
)
_root_lock = threading.Lock()
_root: Optional["TunedRuntime"] = None


class TunedRuntime:
    """A scoped dispatch context: db x mode x policy x cache x telemetry.

    Records are keyed under the platform of the device the call's tensors
    live on (``h100-sxm``, ``torch-cpu``, ...), or under ``platform`` when
    one is pinned (a database namespace of its own). The resolution cache
    holds at most ``cache_capacity`` entries (LRU), each for at most
    ``cache_ttl`` seconds when that is set. ``allow_tune`` lets the TuneNow
    tier tune a missing bucket on the spot with ``tune_kwargs``.
    ``bwd_dispatch=False`` turns every ``vjp="dispatch"`` backward into the
    reference VJP. ``guard`` (default on) and ``guard_nonfinite`` (default
    off) set the fault guard (module docstring); ``health`` is its ledger.
    """

    def __init__(
        self,
        db: Union[TuningDatabase, None, object] = _INHERIT,
        mode: Union[str, object] = _INHERIT,
        policy: Union[Sequence[ResolutionPolicy], None, object] = _INHERIT,
        allow_tune: Union[bool, object] = _INHERIT,
        tune_kwargs: Union[Dict[str, Any], None, object] = _INHERIT,
        platform: Union[str, None, object] = _INHERIT,
        cache_capacity: Union[int, object] = _INHERIT,
        cache_ttl: Union[float, None, object] = _INHERIT,
        bwd_dispatch: Union[bool, object] = _INHERIT,
        guard: Union[bool, object] = _INHERIT,
        guard_nonfinite: Union[bool, object] = _INHERIT,
        name: str = "",
        _is_root: bool = False,
    ):
        parent = None if _is_root else current_runtime()

        def inherit(value, field, default):
            if value is not _INHERIT:
                return value
            return getattr(parent, field) if parent is not None else default

        db = inherit(db, "db", None)
        self.db: TuningDatabase = db if db is not None else TuningDatabase(None)
        self.mode = inherit(mode, "mode", "kernel")
        if self.mode not in _MODES:
            raise ValueError(f"mode {self.mode!r} not in {_MODES}")
        pol = inherit(policy, "policy", None)
        self.policy: Tuple[ResolutionPolicy, ...] = (
            tuple(pol) if pol is not None else default_policy()
        )
        self.allow_tune = bool(inherit(allow_tune, "allow_tune", False))
        self.tune_kwargs: Dict[str, Any] = dict(
            tune_kwargs if tune_kwargs not in (_INHERIT, None) else {})
        self.platform: Optional[str] = inherit(platform, "platform", None)
        self.cache_capacity = max(0, int(inherit(cache_capacity, "cache_capacity", 4096)))
        self.cache_ttl: Optional[float] = inherit(cache_ttl, "cache_ttl", None)
        self.bwd_dispatch = bool(inherit(bwd_dispatch, "bwd_dispatch", True))
        # A variant that raises quarantines its bucket and the call falls
        # through instead of raising; guard=False restores raise-through.
        self.guard = bool(inherit(guard, "guard", True))
        # Opt-in: a non-finite output of a bucket's first execution is a
        # fault (legitimate kernels may emit -inf masks, so off by default).
        self.guard_nonfinite = bool(inherit(guard_nonfinite, "guard_nonfinite", False))
        self.health = HealthBook()
        self.name = name or ("default" if _is_root else f"runtime@{id(self):x}")
        self.telemetry = Telemetry()
        # key -> (db it was resolved against, Resolution, monotonic stamp)
        self._cache: "collections.OrderedDict[str, Tuple[TuningDatabase, Resolution, float]]" = (
            collections.OrderedDict()
        )
        self._cache_lock = threading.Lock()

    # Token-free scoping: pop the innermost occurrence of self, so one
    # runtime may be entered from several threads or tasks at once.
    def __enter__(self) -> "TunedRuntime":
        _stack.set(_stack.get() + (self,))
        return self

    def __exit__(self, *exc) -> None:
        s = _stack.get()
        for i in range(len(s) - 1, -1, -1):
            if s[i] is self:
                _stack.set(s[:i] + s[i + 1:])
                return

    @property
    def kernel_mode_active(self) -> bool:
        return self.mode == "kernel"

    # -- cache ---------------------------------------------------------------
    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def clear_cache(self) -> None:
        """Drop every cached resolution (after changing the database)."""
        with self._cache_lock:
            self._cache.clear()

    def _cache_evict(self, key: str) -> None:
        with self._cache_lock:
            self._cache.pop(key, None)

    def _cache_get(self, key: str) -> Optional[Resolution]:
        now = time.monotonic()
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                return None
            db, res, stamp = hit
            if db is not self.db:
                return None
            if self.cache_ttl is not None and now - stamp > self.cache_ttl:
                del self._cache[key]
                self.telemetry.record_eviction()
                return None
            self._cache.move_to_end(key)
            return res

    def _cache_put(self, key: str, res: Resolution) -> None:
        if self.cache_capacity <= 0:
            return
        evicted = 0
        with self._cache_lock:
            self._cache[key] = (self.db, res, time.monotonic())
            self._cache.move_to_end(key)
            while len(self._cache) > self.cache_capacity:
                self._cache.popitem(last=False)
                evicted += 1
        if evicted:
            self.telemetry.record_eviction(evicted)

    # -- resolution ----------------------------------------------------------
    def platform_for(self, cargs: Sequence[Any]) -> str:
        """The pinned platform, else the platform of the call's device."""
        return self.platform or platform_key(first_device(cargs))

    def key_for(self, tunable: Tunable, cargs: Sequence[Any], key_extra: str = "") -> str:
        return _args_key(tunable, cargs, self.platform_for(cargs), key_extra)

    def resolve(self, tunable: Union[str, Tunable], args: Sequence[Any],
                key_extra: str = "", allow_tune: Optional[bool] = None,
                tune_kwargs: Optional[Dict[str, Any]] = None) -> Resolution:
        """Run the policy pipeline for (tunable, canonical args), cached.

        ``allow_tune`` / ``tune_kwargs`` override the runtime's own for this
        call only; a cached resolution wins over ``allow_tune=True``
        (``clear_cache()`` first to tune buckets already resolved).

        With the guard on, the health book is consulted first: a bucket
        quarantined at level ``kernel`` resolves to the reference, one at
        level ``record`` among the tiers that read no database record, and
        one whose backoff lapsed re-runs the pipeline as a probe (uncached,
        ``probe=True``) so the guard re-validates it.
        """
        return self._resolve(_as_tunable(tunable), args, key_extra, allow_tune, tune_kwargs,
                             _obs_collector())

    def _resolve(self, tunable: Tunable, args: Sequence[Any], key_extra: str,
                 allow_tune: Optional[bool], tune_kwargs: Optional[Dict[str, Any]],
                 col) -> Resolution:
        platform = self.platform_for(args)
        t0 = time.perf_counter() if col.enabled else 0.0
        key = _args_key(tunable, args, platform, key_extra)
        probe = skip_record_tiers = False
        if self.guard:
            h = self.health.consult(key)
            if h is not None:
                state, level = h
                if state == "probe":
                    probe = True
                elif level == "kernel":
                    res = Resolution(None, "reference", key=key, cache=False)
                    self._record(tunable, key, res.tier, False, col, t0)
                    return res
                else:
                    skip_record_tiers = True
        if not (probe or skip_record_tiers):
            hit = self._cache_get(key)
            if hit is not None:
                self._record(tunable, key, hit.tier, True, col, t0)
                return hit
        req = ResolutionRequest(
            tunable=tunable, args=tuple(args), key=key, db=self.db, key_extra=key_extra,
            platform=platform,
            allow_tune=self.allow_tune if allow_tune is None else bool(allow_tune),
            tune_kwargs={**self.tune_kwargs, **(tune_kwargs or {})})
        pipeline = self.policy
        if skip_record_tiers:
            # the stored or measured config of this bucket faulted
            pipeline = tuple(p for p in pipeline if p.name not in ("exact", "tune", "cover"))
        res = None
        for pol in pipeline:
            res = pol.resolve(req)
            if res is not None:
                break
        if res is None:
            res = Resolution(None, "reference")
        res.key = key
        if probe or skip_record_tiers:
            res.cache, res.probe = False, probe
        elif self.guard and self.guard_nonfinite and res.config is not None:
            # a bucket's first execution is probed; the cached copy is not
            res = dataclasses.replace(res, probe=True)
        if res.cache:
            self._cache_put(key, dataclasses.replace(res, probe=False))
        self._record(tunable, key, res.tier, False, col, t0)
        return res

    def _record(self, tunable: Tunable, key: str, tier: str, cached: bool, col,
                t0: float) -> None:
        self.telemetry.record(tunable.name, key, tier, cached=cached, col=col)
        if col.enabled:
            col.observe("dispatch.resolve_s", time.perf_counter() - t0, tier=tier,
                        phase=_phase_ctx.get(), cached="hit" if cached else "miss")

    # -- dispatch ------------------------------------------------------------
    def dispatch(self, tunable: Union[str, Tunable], *args,
                 config: Optional[Config] = None,
                 dp_dims: Optional[Dict[int, int]] = None,
                 reference: Optional[Callable] = None, **kwargs):
        """Execute one tunable through this runtime.

        Reference mode wins over everything, ``config=`` included. In kernel
        mode ``config=`` bypasses resolution (tier ``override``) and the
        guard; otherwise the resolved config runs on the canonical args
        behind the guard, and the Reference tier runs the reference on the
        original args: ``reference`` when the call site names one (its own
        plain version of the same function), else the spec's. A kernel-mode
        call is differentiable through :class:`KernelCall`. ``dp_dims`` is
        the JAX package's local-shard keying of transposed operands; on one
        device it changes nothing and is accepted for call-site parity.

        Under an enabled obs collector the call runs inside
        ``span("dispatch")`` (kernel and phase on the event).
        """
        del dp_dims
        tunable = _as_tunable(tunable)
        col = _obs_collector()        # looked up once a dispatch, handed down
        if col.enabled:
            with _obs_span("dispatch", kernel=tunable.name, phase=_phase_ctx.get()):
                return self._dispatch_impl(tunable, args, config, reference, kwargs, col)
        return self._dispatch_impl(tunable, args, config, reference, kwargs, col)

    def _dispatch_impl(self, tunable: Tunable, args, config, reference, kwargs, col):
        spec = tunable.dispatch or _DEFAULT_SPEC
        if not self.kernel_mode_active:
            self.telemetry.record(tunable.name, None, "reference", col=col)
            return _reference_call(tunable, spec, args, kwargs, reference)
        cargs, restore = spec.canon(args)
        if config is not None:
            # pinned by hand (tests, benchmarks): the real traceback wanted
            self.telemetry.record(tunable.name, None, "override", col=col)
            return restore(_kernel_call(self, tunable, spec, config, cargs, kwargs))
        res = self._resolve(tunable, cargs, spec.extra_for(kwargs), None, None, col)
        if res.config is None:
            return _reference_call(tunable, spec, args, kwargs, reference)
        if not self.guard:
            _kernel_fault(tunable, res.tier)
            return restore(_kernel_call(self, tunable, spec, res.config, cargs, kwargs))
        return self._guarded_call(tunable, spec, res, args, cargs, restore, reference,
                                  kwargs)

    def _guarded_call(self, tunable, spec, res, args, cargs, restore, reference, kwargs):
        """Run a resolved variant behind the fault guard.

        A stored or measured record (tiers exact, tune, cover) whose config
        raises, whatever it raised, quarantines its bucket at level
        ``record`` and gives way to the heuristic config when that differs.
        The reference serves a bucket only for a fault of the fault plane
        (:class:`~repro_torch.testing.InjectedFault`) or a failed
        non-finite probe (:class:`DispatchFault`), and then quarantines it
        at level ``kernel``; any other error of the last kernel config tried
        raises, and the health book takes no entry for it: a kernel that
        fails on the card is never answered by its plain version. The
        serving tier gets a telemetry row of its own.
        :class:`KernelUnavailable`, :class:`CudaError` (a launch the card
        refused), the missing-backward contract error and the checkpoint
        recompute's stop signal raise through at every tier, as do
        ``BaseException``s (KeyboardInterrupt, an injected crash).
        """
        key = res.key
        mode = _backward_mode(self, tunable, spec, cargs)
        try:
            rule = _kernel_fault(tunable, res.tier)
            out = _run_variant(self, tunable, spec, res.config, cargs, kwargs, mode)
            if rule is not None and rule.kind == "nan":
                out = _nan_corrupt(out)
            if res.probe:
                # the probe's isfinite().all() waits for the device: probes only
                if self.guard_nonfinite and _has_nonfinite(out):
                    raise DispatchFault(f"non-finite output from {tunable.name} "
                                        "during its probe")
                self.health.record_ok(key)
            return restore(out)
        except Exception as e:
            _raise_through(e)
            err, tier = e, res.tier
        if tier in _RECORD_TIERS:
            hcfg = tunable.default_config(*cargs)
            if hcfg != res.config:
                self._note_quarantine(tunable, key, tier, "record", err)
                try:
                    _kernel_fault(tunable, "heuristic")
                    out = _run_variant(self, tunable, spec, hcfg, cargs, kwargs, mode)
                    self.telemetry.record(tunable.name, key, "heuristic")
                    return restore(out)
                except Exception as e2:
                    _raise_through(e2)
                    err, tier = e2, "heuristic"
        if not isinstance(err, _PLAIN_MAY_SERVE):
            raise err
        self._note_quarantine(tunable, key, tier, "kernel", err)
        self.telemetry.record(tunable.name, key, "reference")
        return _reference_call(tunable, spec, args, kwargs, reference)

    def _note_quarantine(self, tunable: Tunable, key: str, tier: str, level: str,
                         exc: Exception) -> None:
        self.health.quarantine(key, level)
        self._cache_evict(key)
        col = _obs_collector()
        if col.enabled:
            col.counter("dispatch.quarantine", kernel=tunable.name, tier=tier, level=level)
        # fires with collection off too: a silently demoted site is the hazard
        col.warn_once("dispatch.quarantine", key=f"{key}|{level}", kernel=tunable.name,
                      tier=tier, level=level, error=f"{type(exc).__name__}: {exc}")

    def fusion_wins(self, tunable: Union[str, Tunable], *args, **kwargs) -> bool:
        """Whether a fused-epilogue site should dispatch fused here.

        True iff the kernel path is active and the database holds a record
        with a valid config for the canonical call's exact key: a campaign
        that tuned the fused site opts it in, and every other site keeps
        its unfused chain (and its own records). A pure lookup: no
        telemetry, no cache write, no tuning.
        """
        if not self.kernel_mode_active:
            return False
        try:
            tunable = _as_tunable(tunable)
        except KeyError:
            return False
        spec = tunable.dispatch or _DEFAULT_SPEC
        cargs, _ = spec.canon(args)
        rec = self.db.lookup(self.key_for(tunable, cargs, spec.extra_for(kwargs)))
        return rec is not None and tunable.space.is_valid(rec.config)

    def __repr__(self) -> str:
        db = self.db.path or "memory"
        plat = self.platform or "detected"
        return (f"<TunedRuntime {self.name} mode={self.mode} db={db} platform={plat} "
                f"policy=({', '.join(p.name for p in self.policy)})>")


_DEFAULT_SPEC = DispatchSpec()


def _reference_call(tunable: Tunable, spec: DispatchSpec, args, kwargs,
                    reference: Optional[Callable] = None):
    ref = reference if reference is not None else spec.reference_for(tunable)
    if ref is None:
        raise TypeError(f"tunable {tunable.name!r} has no reference implementation")
    return ref(*args, **kwargs)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What :class:`KernelCall` needs beyond the tensors: the runtime the
    forward ran under (re-entered by the backward, which autograd may run
    on another thread), the bound variant and its backward mode."""

    runtime: "TunedRuntime"
    tunable: Tunable
    spec: DispatchSpec
    variant: Any
    mode: str                       # "dispatch" | "reference"
    kwargs: Dict[str, Any]


class KernelCall(torch.autograd.Function):
    """One bound kernel variant on canonical args, with its backward.

    Forward runs the variant and saves ``(args, primal, *aux)`` (the primal
    and aux only under the residual contract, as ``repro``'s ``custom_vjp``
    does). Backward re-enters the forward's runtime and, under
    ``dispatch_phase("bwd")``, runs either the spec's backward plan
    (``mode="dispatch"``) or the autograd VJP of the reference on the saved
    args (``mode="reference"``), then aligns one gradient per arg with the
    arg's dtype, ``None`` for integer args.
    """

    @staticmethod
    def forward(ctx, plan: _Plan, *cargs):
        out = plan.variant(*cargs, **plan.kwargs)
        n_res = plan.spec.residuals
        primal, aux = (out[0], tuple(out[1:])) if n_res else (out, ())
        ctx.plan, ctx.n_args = plan, len(cargs)
        if n_res:
            ctx.save_for_backward(*cargs, primal, *aux)
        else:
            ctx.save_for_backward(*cargs)
        return tuple(primal) if isinstance(primal, (tuple, list)) else primal

    @staticmethod
    def backward(ctx, *cts):
        plan, n = ctx.plan, ctx.n_args
        saved = ctx.saved_tensors
        args, rest = saved[:n], saved[n:]
        cts = tuple(c.contiguous() for c in cts)
        ct = cts[0] if len(cts) == 1 else cts
        with plan.runtime, dispatch_phase("bwd"):
            if plan.mode == "dispatch":
                grads = plan.spec.bwd(ct, *args, *rest, **plan.kwargs)
            else:
                from ..kernels.ref import vjp

                ref = plan.spec.reference_for(plan.tunable)
                grads = vjp(lambda *a: ref(*a, **plan.kwargs), args, ct)
        return (None,) + _match_grads(plan.tunable.name, grads, args,
                                      ctx.needs_input_grad[1:])


def _match_grads(name: str, grads, args, needs) -> tuple:
    """One gradient per canonical arg: ``None`` where none is needed or the
    arg is not floating point (labels), zeros where the plan gave none, else
    the gradient in the arg's dtype (``_match_cotangents`` in ``repro``)."""
    grads = tuple(grads)
    if len(grads) != len(args):
        raise ValueError(f"backward plan of {name} returned {len(grads)} gradients "
                         f"for {len(args)} args")
    out = []
    for g, a, need in zip(grads, args, needs):
        if not need or not a.is_floating_point():
            out.append(None)
        elif g is None:
            out.append(torch.zeros_like(a))
        else:
            out.append(g.to(a.dtype))
    return tuple(out)


def _backward_mode(runtime: "TunedRuntime", tunable: Tunable, spec: DispatchSpec,
                   cargs: tuple) -> Optional[str]:
    """None when no input needs a gradient, else how :class:`KernelCall`
    differentiates the call ("dispatch" or "reference"). Raises for a
    tunable that declares no backward: a contract error of the tunable,
    which no other variant would mend, so it is raised before the guard."""
    if not (torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in cargs)):
        return None
    mode = spec.vjp
    if mode == "dispatch" and (spec.bwd is None or not runtime.bwd_dispatch):
        mode = "reference"
    if mode == "reference" and spec.reference_for(tunable) is None:
        mode = "none"
    if mode == "none":
        raise RuntimeError(
            f"{tunable.name}: a kernel-mode dispatch of inputs that require grad, but "
            f"the tunable declares no backward (vjp={spec.vjp!r}); its output would "
            "carry no gradient")
    return mode


def _run_variant(runtime: "TunedRuntime", tunable: Tunable, spec: DispatchSpec,
                 config: Config, cargs: tuple, kwargs: Dict[str, Any], mode: Optional[str]):
    """Run one bound variant on canonical args: the bare variant when no
    gradient is needed (``mode=None``), else through :class:`KernelCall`."""
    variant = tunable.variant(**config)
    if mode is None:
        out = variant(*cargs, **kwargs)
        return out[0] if spec.residuals else out
    return KernelCall.apply(_Plan(runtime, tunable, spec, variant, mode, kwargs), *cargs)


def _kernel_call(runtime: "TunedRuntime", tunable: Tunable, spec: DispatchSpec,
                 config: Config, cargs: tuple, kwargs: Dict[str, Any]):
    """Run one bound variant on canonical args; differentiable when an input
    requires grad (see :class:`KernelCall`), the bare variant otherwise."""
    return _run_variant(runtime, tunable, spec, config, cargs, kwargs,
                        _backward_mode(runtime, tunable, spec, cargs))


# the stored or measured tiers: a config of theirs that faults gives way to
# the heuristic config
_RECORD_TIERS = ("exact", "tune", "cover")
# the faults the plain path may answer: the fault plane's own, and a failed
# non-finite probe
_PLAIN_MAY_SERVE = (InjectedFault, DispatchFault)


def _kernel_fault(tunable: Tunable, tier: str):
    """The ``dispatch.kernel:<tunable>`` fault site: one flag read, and no
    site name built, while no fault plan is active."""
    if not _faults._enabled:
        return None
    return _faults.fault_point(f"dispatch.kernel:{tunable.name}", tier=tier)


def raises_through(exc: BaseException) -> bool:
    """Whether no guard or degraded path may absorb ``exc``: a kernel that
    does not exist on this host (:class:`KernelUnavailable`), a launch the
    card refused (:class:`CudaError`), or the signal ``torch.utils.checkpoint``
    raises through a recompute once it holds every tensor the backward needs
    (control flow, not a fault)."""
    import torch.utils.checkpoint as ckpt

    from ..kernels._build import CudaError, KernelUnavailable

    stop = getattr(ckpt, "_StopRecomputationError", ())
    return isinstance(exc, (KernelUnavailable, CudaError, stop))


def _raise_through(exc: Exception) -> None:
    if raises_through(exc):
        raise exc


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def _has_nonfinite(out) -> bool:
    """True when a floating-point output holds a NaN or an inf. Each check
    waits for the device, which is why only probes run it."""
    return any(t.is_floating_point() and not bool(torch.isfinite(t).all())
               for t in _tensors(out))


def _nan_corrupt(out):
    """Floating-point outputs replaced by NaNs (fault kind "nan")."""
    if isinstance(out, torch.Tensor):
        return torch.full_like(out, float("nan")) if out.is_floating_point() else out
    if isinstance(out, (tuple, list)):
        return type(out)(_nan_corrupt(o) for o in out)
    return out


def _as_tunable(t: Union[str, Tunable]) -> Tunable:
    if isinstance(t, Tunable):
        return t
    try:
        return get_tunable(t)
    except KeyError:
        ensure_registered()
        return get_tunable(t)


def ensure_registered() -> None:
    """Import the modules whose ``@tunable`` decorators fill the registry:
    the kernels and the model-level tunables (``attn_chunks``)."""
    from .. import kernels  # noqa: F401
    from ..models import tunables  # noqa: F401


def _root_runtime() -> TunedRuntime:
    global _root
    if _root is None:
        with _root_lock:
            if _root is None:
                _root = TunedRuntime(db=None, mode="kernel", policy=None,
                                     name="default", _is_root=True)
    return _root


def current_runtime() -> TunedRuntime:
    """The innermost active runtime, or the process-default one."""
    s = _stack.get()
    return s[-1] if s else _root_runtime()


def runtime(
    db: Union[TuningDatabase, None, object] = _INHERIT,
    mode: Union[str, object] = _INHERIT,
    policy: Union[Sequence[ResolutionPolicy], None, object] = _INHERIT,
    allow_tune: Union[bool, object] = _INHERIT,
    tune_kwargs: Union[Dict[str, Any], None, object] = _INHERIT,
    platform: Union[str, None, object] = _INHERIT,
    cache_capacity: Union[int, object] = _INHERIT,
    cache_ttl: Union[float, None, object] = _INHERIT,
    bwd_dispatch: Union[bool, object] = _INHERIT,
    guard: Union[bool, object] = _INHERIT,
    guard_nonfinite: Union[bool, object] = _INHERIT,
    name: str = "",
) -> TunedRuntime:
    """Create a scoped dispatch runtime (use as ``with runtime(...)``)."""
    return TunedRuntime(db=db, mode=mode, policy=policy, allow_tune=allow_tune,
                        tune_kwargs=tune_kwargs, platform=platform,
                        cache_capacity=cache_capacity, cache_ttl=cache_ttl,
                        bwd_dispatch=bwd_dispatch, guard=guard,
                        guard_nonfinite=guard_nonfinite, name=name)


def dispatch(tunable: Union[str, Tunable], *args,
             config: Optional[Config] = None,
             dp_dims: Optional[Dict[int, int]] = None,
             reference: Optional[Callable] = None, **kwargs):
    """Dispatch through whichever runtime is active at the call."""
    return current_runtime().dispatch(tunable, *args, config=config, dp_dims=dp_dims,
                                      reference=reference, **kwargs)


def fusion_wins(tunable: Union[str, Tunable], *args, **kwargs) -> bool:
    return current_runtime().fusion_wins(tunable, *args, **kwargs)


def entry_point(name: str) -> Callable:
    """A deployment entry point for a registered tunable: ``fn(*args,
    config=None, **call_kwargs)`` that dispatches through
    :func:`current_runtime`, so it honours whatever runtime is active where
    it is *called*, not where it was made (``repro.core.runtime``'s)."""

    def call(*args, config: Optional[Config] = None, **kwargs):
        return current_runtime().dispatch(name, *args, config=config, **kwargs)

    call.__name__ = name
    call.__qualname__ = name
    call.__doc__ = (f"Registry-dispatched entry point for tunable {name!r} (resolution: the "
                    "active TunedRuntime's policy pipeline).")
    return call
