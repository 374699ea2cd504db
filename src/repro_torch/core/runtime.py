"""The dispatch runtime: scoped tuned contexts and resolution policies.

A :class:`TunedRuntime` pins a tuning database, a mode (``"kernel"`` or
``"reference"``) and a resolution policy for everything run under ``with``
it. Runtimes nest (inner wins; unspecified fields inherit from the runtime
active at construction) and live on a context-local stack, so each thread
and each task sees its own scope.

Resolution runs a pipeline of policies, ``ExactHit -> Heuristic ->
Reference`` by default, with a bounded LRU cache of resolutions per
runtime. :class:`Telemetry` counts which tier served each kernel x bucket.

Two differences from ``repro.core.runtime``, both on purpose:

* the default mode is the kernel path; there is no environment switch;
* there is no fault guard: a kernel that raises raises through.
"""
from __future__ import annotations

import collections
import contextvars
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from .annotate import DispatchSpec, Tunable, get_tunable
from .database import TuningDatabase
from .params import Config
from .platform import platform_key
from .tuner import _args_key, first_device

_MODES = ("kernel", "reference")
TIERS = ("override", "exact", "heuristic", "reference")


@dataclasses.dataclass
class ResolutionRequest:
    """Everything a policy may consult to resolve one kernel x bucket."""

    tunable: Tunable
    args: tuple                      # canonicalized positional args
    key: str
    db: TuningDatabase


@dataclasses.dataclass
class Resolution:
    """``config=None`` means: run the reference implementation."""

    config: Optional[Config]
    tier: str
    key: Optional[str] = None


class ResolutionPolicy:
    """One tier: ``resolve`` returns a Resolution, or None to pass it on."""

    name = "policy"

    def resolve(self, req: ResolutionRequest) -> Optional[Resolution]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"


class ExactHit(ResolutionPolicy):
    """A stored record with a valid config for this exact key."""

    name = "exact"

    def resolve(self, req: ResolutionRequest) -> Optional[Resolution]:
        rec = req.db.lookup(req.key)
        if rec is not None and req.tunable.space.is_valid(rec.config):
            return Resolution(dict(rec.config), self.name)
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
    return (ExactHit(), Heuristic(), Reference())


class Telemetry:
    """Per-runtime counters: which tier served each kernel x bucket.

    ``tiers`` counts dispatches per tier; ``by_key`` is ``{db key: {tier:
    count}}`` (reference-mode and ``config=`` dispatches, which compute no
    key, count under ``"<kernel>|*"``); ``cache_hits`` / ``calls`` measure
    the resolution cache, ``cache_evictions`` its bound.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.tiers: Dict[str, int] = {}
            self.by_key: Dict[str, Dict[str, int]] = {}
            self.calls = 0
            self.cache_hits = 0
            self.cache_evictions = 0

    def record(self, kernel: str, key: Optional[str], tier: str,
               cached: bool = False) -> None:
        k = key if key is not None else f"{kernel}|*"
        with self._lock:
            self.calls += 1
            self.cache_hits += int(cached)
            self.tiers[tier] = self.tiers.get(tier, 0) + 1
            per = self.by_key.setdefault(k, {})
            per[tier] = per.get(tier, 0) + 1

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
    live on (``h100-sxm``, ``torch-cpu``, ...). The resolution cache holds
    at most ``cache_capacity`` entries (LRU).
    """

    def __init__(
        self,
        db: Union[TuningDatabase, None, object] = _INHERIT,
        mode: Union[str, object] = _INHERIT,
        policy: Union[Sequence[ResolutionPolicy], None, object] = _INHERIT,
        cache_capacity: Union[int, object] = _INHERIT,
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
        self.cache_capacity = max(0, int(inherit(cache_capacity, "cache_capacity", 4096)))
        self.name = name or ("default" if _is_root else f"runtime@{id(self):x}")
        self.telemetry = Telemetry()
        # key -> (db it was resolved against, Resolution)
        self._cache: "collections.OrderedDict[str, Tuple[TuningDatabase, Resolution]]" = (
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

    def _cache_get(self, key: str) -> Optional[Resolution]:
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                return None
            db, res = hit
            if db is not self.db:
                return None
            self._cache.move_to_end(key)
            return res

    def _cache_put(self, key: str, res: Resolution) -> None:
        if self.cache_capacity <= 0:
            return
        evicted = 0
        with self._cache_lock:
            self._cache[key] = (self.db, res)
            self._cache.move_to_end(key)
            while len(self._cache) > self.cache_capacity:
                self._cache.popitem(last=False)
                evicted += 1
        if evicted:
            self.telemetry.record_eviction(evicted)

    # -- resolution ----------------------------------------------------------
    def key_for(self, tunable: Tunable, cargs: Sequence[Any], key_extra: str = "") -> str:
        return _args_key(tunable, cargs, platform_key(first_device(cargs)), key_extra)

    def resolve(self, tunable: Union[str, Tunable], args: Sequence[Any],
                key_extra: str = "") -> Resolution:
        """Run the policy pipeline for (tunable, canonical args), cached."""
        tunable = _as_tunable(tunable)
        key = self.key_for(tunable, args, key_extra)
        hit = self._cache_get(key)
        if hit is not None:
            self.telemetry.record(tunable.name, key, hit.tier, cached=True)
            return hit
        req = ResolutionRequest(tunable=tunable, args=tuple(args), key=key, db=self.db)
        res = None
        for pol in self.policy:
            res = pol.resolve(req)
            if res is not None:
                break
        if res is None:
            res = Resolution(None, "reference")
        res.key = key
        self._cache_put(key, res)
        self.telemetry.record(tunable.name, key, res.tier)
        return res

    # -- dispatch ------------------------------------------------------------
    def dispatch(self, tunable: Union[str, Tunable], *args,
                 config: Optional[Config] = None, **kwargs):
        """Execute one tunable through this runtime.

        Reference mode wins over everything, ``config=`` included. In kernel
        mode ``config=`` bypasses resolution (tier ``override``); otherwise
        the resolved config runs on the canonical args, and the Reference
        tier runs the spec's reference on the original args.
        """
        tunable = _as_tunable(tunable)
        spec = tunable.dispatch or _DEFAULT_SPEC
        if not self.kernel_mode_active:
            self.telemetry.record(tunable.name, None, "reference")
            return _reference_call(tunable, spec, args, kwargs)
        cargs, restore = spec.canon(args)
        if config is not None:
            self.telemetry.record(tunable.name, None, "override")
        else:
            res = self.resolve(tunable, cargs, key_extra=spec.extra_for(kwargs))
            if res.config is None:
                return _reference_call(tunable, spec, args, kwargs)
            config = res.config
        out = tunable.variant(**config)(*cargs, **kwargs)
        return restore(out[0] if spec.residuals else out)

    def fusion_wins(self, tunable: Union[str, Tunable], *args, **kwargs) -> bool:
        """Whether a fused-epilogue site should dispatch fused here.

        False until the fused kernels (``matmul_bias_act``,
        ``rmsnorm_matmul``) are ported: every site keeps its unfused chain.
        """
        return False

    def __repr__(self) -> str:
        db = self.db.path or "memory"
        return (f"<TunedRuntime {self.name} mode={self.mode} db={db} "
                f"policy=({', '.join(p.name for p in self.policy)})>")


_DEFAULT_SPEC = DispatchSpec()


def _reference_call(tunable: Tunable, spec: DispatchSpec, args, kwargs):
    ref = spec.reference_for(tunable)
    if ref is None:
        raise TypeError(f"tunable {tunable.name!r} has no reference implementation")
    return ref(*args, **kwargs)


def _as_tunable(t: Union[str, Tunable]) -> Tunable:
    if isinstance(t, Tunable):
        return t
    try:
        return get_tunable(t)
    except KeyError:
        ensure_registered()
        return get_tunable(t)


def ensure_registered() -> None:
    """Import the modules whose ``@tunable`` decorators fill the registry."""
    from .. import kernels  # noqa: F401


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
    cache_capacity: Union[int, object] = _INHERIT,
    name: str = "",
) -> TunedRuntime:
    """Create a scoped dispatch runtime (use as ``with runtime(...)``)."""
    return TunedRuntime(db=db, mode=mode, policy=policy,
                        cache_capacity=cache_capacity, name=name)


def dispatch(tunable: Union[str, Tunable], *args,
             config: Optional[Config] = None, **kwargs):
    """Dispatch through whichever runtime is active at the call."""
    return current_runtime().dispatch(tunable, *args, config=config, **kwargs)


def fusion_wins(tunable: Union[str, Tunable], *args, **kwargs) -> bool:
    return current_runtime().fusion_wins(tunable, *args, **kwargs)
