"""The annotation layer: ``@tunable`` declares a kernel's knobs and deployment.

Decorating a function with :func:`tunable` registers it under a name with
its knob space, its reference implementation and its shape heuristic. The
function takes the knobs as keyword-only arguments and computes the same
result for every valid config, so calling it bare runs the heuristic (or
default) config. ``dispatch=DispatchSpec(...)`` tells the dispatch runtime
(:mod:`repro_torch.core.runtime`) how to key and call it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

from .params import Config, ParamSpace

_REGISTRY: Dict[str, "Tunable"] = {}


@dataclasses.dataclass(frozen=True)
class DispatchSpec:
    """Declarative deployment spec for one tunable.

    * ``reference`` — the reference-mode implementation, called as
      ``reference(*args, **call_kwargs)`` on the original arguments and
      returning the primal only. Defaults to the tunable's reference.
    * ``key_extra`` — maps the call kwargs to the database key suffix, so
      calls with equal shapes but different semantics get distinct records.
    * ``canonicalize`` — ``(*args) -> (canon_args, restore)``: rewrites the
      positional args into the layout the kernel and its keys expect, plus a
      function applied to the kernel's primal output to undo the rewrite.
    * ``data_parallel_args`` — canonical args whose leading dim is batch-like
      (kept for key compatibility; the port has no mesh yet).
    * ``vjp`` / ``bwd`` — the backward plan; accepted and not yet used (the
      port serves, it does not train yet).
    * ``residuals`` — the kernel returns ``(primal, *aux)`` with this many
      auxiliary outputs; dispatch hands callers the primal only.
    """

    reference: Optional[Callable] = None
    key_extra: Optional[Callable[[Dict[str, Any]], str]] = None
    canonicalize: Optional[Callable[..., Tuple[tuple, Callable]]] = None
    data_parallel_args: Tuple[int, ...] = (0,)
    vjp: str = "reference"
    bwd: Optional[Callable] = None
    residuals: int = 0

    def reference_for(self, tunable: "Tunable") -> Optional[Callable]:
        return self.reference if self.reference is not None else tunable.reference

    def extra_for(self, call_kwargs: Dict[str, Any]) -> str:
        return self.key_extra(call_kwargs) if self.key_extra else ""

    def canon(self, args: tuple) -> Tuple[tuple, Callable]:
        if self.canonicalize is None:
            return args, lambda out: out
        return self.canonicalize(*args)


class Tunable:
    def __init__(
        self,
        name: str,
        fn: Callable,
        space: ParamSpace,
        reference: Optional[Callable] = None,
        default: Optional[Config] = None,
        heuristic: Optional[Callable[..., Config]] = None,
        dispatch: Optional[DispatchSpec] = None,
    ):
        self.name = name
        self.fn = fn
        self.space = space
        self.reference = reference
        self._default = default
        self.heuristic = heuristic
        self.dispatch = dispatch
        functools.update_wrapper(self, fn)

    def default_config(self, *args) -> Config:
        if self.heuristic is not None and args:
            cfg = self.heuristic(*args)
            if self.space.is_valid(cfg):
                return cfg
        if self._default is not None:
            return dict(self._default)
        return self.space.default()

    def variant(self, **config) -> Callable:
        """Bind one concrete config: one code variant."""
        why = self.space.why_invalid(config)
        if why is not None:
            raise ValueError(f"invalid config for {self.name}: {why}")
        return functools.partial(self.fn, **config)

    def __call__(self, *args, **overrides):
        """Run with the default config plus validated knob overrides; non-knob
        kwargs (``eps``, ``causal``, ...) pass through untouched."""
        cfg = self.default_config(*args)
        knobs = set(self.space.names)
        passthrough = {k: v for k, v in overrides.items() if k not in knobs}
        cfg.update({k: v for k, v in overrides.items() if k in knobs})
        why = self.space.why_invalid(cfg)
        if why is not None:
            raise ValueError(f"invalid config for {self.name}: {why}")
        return self.fn(*args, **cfg, **passthrough)

    def __repr__(self) -> str:
        return f"<tunable {self.name} over {self.space!r}>"


def tunable(
    name: str,
    space: ParamSpace,
    reference: Optional[Callable] = None,
    default: Optional[Config] = None,
    heuristic: Optional[Callable[..., Config]] = None,
    dispatch: Optional[DispatchSpec] = None,
) -> Callable[[Callable], Tunable]:
    def deco(fn: Callable) -> Tunable:
        t = Tunable(name, fn, space, reference, default, heuristic, dispatch)
        _REGISTRY[name] = t
        return t

    return deco


def get_tunable(name: str) -> Tunable:
    return _REGISTRY[name]


def registered() -> Dict[str, Tunable]:
    return dict(_REGISTRY)
