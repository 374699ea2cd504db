"""Tunable parameter spaces: the knob declarations of a kernel.

A :class:`Param` is one knob with a finite ordered domain; a
:class:`ParamSpace` is the cartesian product of knobs filtered by
cross-knob :class:`Constraint`s (e.g. "the tile's shared memory must fit
one block"). Same semantics, config-key format and random draws as
``repro.core.params``, so a search strategy seeded alike proposes the same
configs in both packages.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

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

    def index_of(self, value: Any) -> int:
        try:
            return self.choices.index(value)
        except ValueError:
            raise KeyError(f"value {value!r} not in domain of param {self.name!r}") from None

    def neighbors(self, value: Any) -> List[Any]:
        """Adjacent choices in domain order (the coordinate-descent moves)."""
        i = self.index_of(value)
        return [self.choices[j] for j in (i - 1, i + 1) if 0 <= j < len(self.choices)]

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.choices)


def EnumParam(name: str, choices: Sequence[Any]) -> Param:
    return Param(name, tuple(choices))


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
        self._by_name = {p.name: p for p in self.params}

    def __getitem__(self, name: str) -> Param:
        return self._by_name[name]

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

    def _ok(self, config: Config) -> bool:
        return all(c(config) for c in self.constraints)

    def sample(self, rng: random.Random, max_tries: int = 1000) -> Config:
        """One random valid config (rejection sampling, then a scan of the
        valid configs so tight constraints still make progress)."""
        for _ in range(max_tries):
            cfg = {p.name: p.sample(rng) for p in self.params}
            if self._ok(cfg):
                return cfg
        valid = list(itertools.islice(self.enumerate(), 10000))
        if not valid:
            raise RuntimeError("search space is empty: "
                               + "; ".join(c.reason for c in self.constraints))
        return rng.choice(valid)

    def neighbors(self, config: Config) -> List[Config]:
        """Valid one-knob-step neighbors (the hillclimb/annealing move set)."""
        out: List[Config] = []
        for p in self.params:
            for v in p.neighbors(config[p.name]):
                cand = dict(config)
                cand[p.name] = v
                if self._ok(cand):
                    out.append(cand)
        return out

    def random_neighbor(self, config: Config, rng: random.Random) -> Config:
        nbrs = self.neighbors(config)
        return rng.choice(nbrs) if nbrs else dict(config)

    def crossover(self, a: Config, b: Config, rng: random.Random) -> Config:
        """Uniform crossover (genetic search); ``a`` when no child is valid."""
        for _ in range(32):
            child = {name: (a if rng.random() < 0.5 else b)[name] for name in self.names}
            if self._ok(child):
                return child
        return dict(a)

    def default(self) -> Config:
        """First valid config in enumeration order."""
        for cfg in self.enumerate():
            return cfg
        raise RuntimeError("search space is empty")

    def legal_configs(self, platform: Any = None,
                      shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                      dtypes: Any = None, kernel: Optional[str] = None) -> List[Config]:
        """Valid configs that every kernel tuning over this space can also
        launch on ``platform`` (a profile, a platform key, or the detected
        device), by the launch models of :mod:`repro_torch.core.gridmodel`
        at each kernel's nominal shapes; with ``shapes`` (one call's), the
        configs ``kernel`` (default: the first kernel registered on the
        space) can launch at them. A space with no launch model behind it
        (the torch-code backwards, model-level chunk knobs) is returned
        whole."""
        kernels = getattr(self, "_grid_kernels", ())
        if not kernels:
            return list(self.enumerate())
        if kernel is not None or shapes is not None:
            kernels = (kernel or kernels[0],)
        from .gridmodel import config_verdict, resolve_profile

        profile = resolve_profile(platform)
        return [cfg for cfg in self.enumerate()
                if all(config_verdict(k, cfg, profile, shapes, dtypes) is None for k in kernels)]

    @staticmethod
    def config_key(config: Config) -> str:
        """Stable string key for a config (database + dedup)."""
        return ",".join(f"{k}={config[k]}" for k in sorted(config))

    def __repr__(self) -> str:
        ps = ", ".join(f"{p.name}[{p.cardinality}]" for p in self.params)
        return f"ParamSpace({ps}; |product|={self.cardinality})"
