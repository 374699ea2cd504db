"""Uniform random search: the no-structure baseline."""
from __future__ import annotations

from typing import Sequence

from ..params import Config, ParamSpace
from .base import ObjectiveFn, SearchAlgorithm, SearchResult, _Memo, make_rng


class RandomSearch(SearchAlgorithm):
    name = "random"

    def run(self, space: ParamSpace, objective: ObjectiveFn,
            seeds: Sequence[Config] = ()) -> SearchResult:
        rng = make_rng(self.seed)
        memo = _Memo(objective)
        for cfg in self._valid_seeds(space, seeds):
            if memo.evaluations >= self.budget:
                break
            memo(cfg)
        tries = 0
        # A few duplicates' worth of extra draws, then stop.
        while memo.evaluations < self.budget and tries < self.budget * 4:
            tries += 1
            memo(space.sample(rng))
        return self._mk_result(memo.trials)
