"""Search-strategy interface.

A strategy proposes configs; the tuner evaluates each (run, time, hold
against the reference) and reports the measured objective back. Strategies
are budgeted (a number of evaluations), because each evaluation runs the
kernel. Lower objectives are better (seconds).
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Optional, Sequence

from ..params import Config, ParamSpace

INVALID = math.inf  # objective of a failed or incorrect variant


@dataclasses.dataclass
class Trial:
    config: Config
    objective: float          # seconds; INVALID if the variant failed
    ok: bool                  # ran and passed the correctness gate
    meta: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SearchResult:
    best: Optional[Trial]
    trials: List[Trial]
    evaluations: int

    @property
    def best_config(self) -> Config:
        if self.best is None:
            raise RuntimeError("search found no valid variant")
        return self.best.config

    @property
    def best_objective(self) -> float:
        if self.best is None:
            return INVALID
        return self.best.objective


ObjectiveFn = Callable[[Config], Trial]


class SearchAlgorithm:
    """Drive ``objective`` for at most ``budget`` evaluations.

    ``seeds`` are starting configs suggested from outside (transfer tuning:
    winners of a neighbouring shape bucket). Every strategy evaluates the
    valid seeds first.
    """

    name = "base"

    def __init__(self, budget: int = 64, seed: int = 0):
        self.budget = int(budget)
        self.seed = int(seed)

    def run(self, space: ParamSpace, objective: ObjectiveFn,
            seeds: Sequence[Config] = ()) -> SearchResult:
        raise NotImplementedError

    @staticmethod
    def _mk_result(trials: List[Trial]) -> SearchResult:
        ok = [t for t in trials if t.ok and t.objective < INVALID]
        best = min(ok, key=lambda t: t.objective) if ok else None
        return SearchResult(best=best, trials=trials, evaluations=len(trials))

    @staticmethod
    def _valid_seeds(space: ParamSpace, seeds: Sequence[Config]) -> List[Config]:
        """Valid seeds, deduplicated, in order; invalid ones are dropped."""
        out: List[Config] = []
        seen = set()
        for s in seeds:
            if not space.is_valid(s):
                continue
            k = ParamSpace.config_key(s)
            if k not in seen:
                seen.add(k)
                out.append(dict(s))
        return out


class _Memo:
    """Dedup wrapper so no strategy evaluates a config twice."""

    def __init__(self, objective: ObjectiveFn):
        self._objective = objective
        self.cache: Dict[str, Trial] = {}
        self.trials: List[Trial] = []

    def __call__(self, config: Config) -> Trial:
        key = ParamSpace.config_key(config)
        if key in self.cache:
            return self.cache[key]
        t = self._objective(config)
        self.cache[key] = t
        self.trials.append(t)
        return t

    @property
    def evaluations(self) -> int:
        return len(self.trials)


def make_rng(seed: int) -> random.Random:
    return random.Random(seed)
