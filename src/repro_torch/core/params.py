"""Tunable parameter spaces: the knob declarations of a kernel.

A :class:`Param` is one knob with a finite ordered domain; a
:class:`ParamSpace` is the cartesian product of knobs filtered by
cross-knob :class:`Constraint`s (e.g. "the tile's shared memory must fit
one block"). Same semantics and config-key format as ``repro.core.params``;
the search helpers come with the tuner.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

Config = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Param:
    """A single named knob with a finite ordered domain."""

    name: str
    choices: Tuple[Any, ...]

    def __post_init__(self):
        if not self.choices:
            raise ValueError(f"param {self.name!r} has an empty domain")
        if len(set(map(repr, self.choices))) != len(self.choices):
            raise ValueError(f"param {self.name!r} has duplicate choices")

    @property
    def cardinality(self) -> int:
        return len(self.choices)


def PowerOfTwoParam(name: str, lo: int, hi: int) -> Param:
    """Powers of two in [lo, hi] inclusive: the canonical tile-size domain."""
    if lo <= 0 or hi < lo:
        raise ValueError(f"bad power-of-two range [{lo}, {hi}]")
    v = 1 << max(0, math.ceil(math.log2(lo)))
    vals = []
    while v <= hi:
        vals.append(v)
        v <<= 1
    if not vals:
        raise ValueError(f"no powers of two in [{lo}, {hi}]")
    return Param(name, tuple(vals))


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A validity predicate over a full config; ``reason`` names it in errors."""

    fn: Callable[[Config], bool]
    reason: str = "constraint"

    def __call__(self, config: Config) -> bool:
        return bool(self.fn(config))


class ParamSpace:
    """Cartesian product of :class:`Param`s filtered by :class:`Constraint`s."""

    def __init__(self, params: Sequence[Param], constraints: Sequence[Constraint] = ()):
        names = [p.name for p in params]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate param names: {names}")
        self.params: Tuple[Param, ...] = tuple(params)
        self.constraints: Tuple[Constraint, ...] = tuple(constraints)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.params)

    @property
    def cardinality(self) -> int:
        """Size of the unconstrained product (upper bound on variants)."""
        return math.prod(p.cardinality for p in self.params)

    def why_invalid(self, config: Config) -> Optional[str]:
        if set(config) != set(self.names):
            return f"keys {sorted(config)} != space {sorted(self.names)}"
        for p in self.params:
            if config[p.name] not in p.choices:
                return f"{p.name}={config[p.name]!r} not in domain"
        for c in self.constraints:
            if not c(config):
                return c.reason
        return None

    def is_valid(self, config: Config) -> bool:
        return self.why_invalid(config) is None

    def enumerate(self) -> Iterator[Config]:
        """All valid configs, in deterministic lexicographic order."""
        for combo in itertools.product(*(p.choices for p in self.params)):
            cfg = dict(zip(self.names, combo))
            if all(c(cfg) for c in self.constraints):
                yield cfg

    def default(self) -> Config:
        """First valid config in enumeration order."""
        for cfg in self.enumerate():
            return cfg
        raise RuntimeError("search space is empty")

    @staticmethod
    def config_key(config: Config) -> str:
        """Stable string key for a config (database + dedup)."""
        return ",".join(f"{k}={config[k]}" for k in sorted(config))

    def __repr__(self) -> str:
        ps = ", ".join(f"{p.name}[{p.cardinality}]" for p in self.params)
        return f"ParamSpace({ps}; |product|={self.cardinality})"
