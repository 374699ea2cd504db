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

Two differences from ``repro.core.runtime``, both on purpose:

* the default mode is the kernel path; there is no environment switch;
* there is no fault guard: a kernel that raises raises through.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from .annotate import DispatchSpec, Tunable, get_tunable
from .database import TuningDatabase, split_key
from .params import Config
from .platform import platform_key
from .tuner import _args_key, first_device

_MODES = ("kernel", "reference")
TIERS = ("override", "exact", "tune", "cover", "heuristic", "reference")

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
               cached: bool = False) -> None:
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
    reference VJP.
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
        """
        tunable = _as_tunable(tunable)
        platform = self.platform_for(args)
        key = _args_key(tunable, args, platform, key_extra)
        hit = self._cache_get(key)
        if hit is not None:
            self.telemetry.record(tunable.name, key, hit.tier, cached=True)
            return hit
        req = ResolutionRequest(
            tunable=tunable, args=tuple(args), key=key, db=self.db, key_extra=key_extra,
            platform=platform,
            allow_tune=self.allow_tune if allow_tune is None else bool(allow_tune),
            tune_kwargs={**self.tune_kwargs, **(tune_kwargs or {})})
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
                 config: Optional[Config] = None,
                 dp_dims: Optional[Dict[int, int]] = None, **kwargs):
        """Execute one tunable through this runtime.

        Reference mode wins over everything, ``config=`` included. In kernel
        mode ``config=`` bypasses resolution (tier ``override``); otherwise
        the resolved config runs on the canonical args, and the Reference
        tier runs the spec's reference on the original args. A kernel-mode
        call is differentiable through :class:`KernelCall`. ``dp_dims`` is
        the JAX package's local-shard keying of transposed operands; on one
        device it changes nothing and is accepted for call-site parity.
        """
        del dp_dims
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
        return restore(_kernel_call(self, tunable, spec, config, cargs, kwargs))

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


def _reference_call(tunable: Tunable, spec: DispatchSpec, args, kwargs):
    ref = spec.reference_for(tunable)
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


def _kernel_call(runtime: "TunedRuntime", tunable: Tunable, spec: DispatchSpec,
                 config: Config, cargs: tuple, kwargs: Dict[str, Any]):
    """Run one bound variant on canonical args; differentiable when an input
    requires grad (see :class:`KernelCall`), the bare variant otherwise."""
    variant = tunable.variant(**config)
    needs_grad = torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in cargs)
    if not needs_grad:
        out = variant(*cargs, **kwargs)
        return out[0] if spec.residuals else out
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
    return KernelCall.apply(_Plan(runtime, tunable, spec, variant, mode, kwargs), *cargs)


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
    name: str = "",
) -> TunedRuntime:
    """Create a scoped dispatch runtime (use as ``with runtime(...)``)."""
    return TunedRuntime(db=db, mode=mode, policy=policy, allow_tune=allow_tune,
                        tune_kwargs=tune_kwargs, platform=platform,
                        cache_capacity=cache_capacity, cache_ttl=cache_ttl,
                        bwd_dispatch=bwd_dispatch, name=name)


def dispatch(tunable: Union[str, Tunable], *args,
             config: Optional[Config] = None,
             dp_dims: Optional[Dict[int, int]] = None, **kwargs):
    """Dispatch through whichever runtime is active at the call."""
    return current_runtime().dispatch(tunable, *args, config=config, dp_dims=dp_dims,
                                      **kwargs)


def fusion_wins(tunable: Union[str, Tunable], *args, **kwargs) -> bool:
    return current_runtime().fusion_wins(tunable, *args, **kwargs)
