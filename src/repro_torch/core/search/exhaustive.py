"""Exhaustive search: ground truth for small spaces."""
from __future__ import annotations

from typing import Sequence

from ..params import Config, ParamSpace
from .base import ObjectiveFn, SearchAlgorithm, SearchResult, _Memo


class ExhaustiveSearch(SearchAlgorithm):
    name = "exhaustive"

    def run(self, space: ParamSpace, objective: ObjectiveFn,
            seeds: Sequence[Config] = ()) -> SearchResult:
        memo = _Memo(objective)
        # Seeds first: if the budget cuts the enumeration short, the
        # suggested region is still measured.
        for cfg in self._valid_seeds(space, seeds):
            if memo.evaluations >= self.budget:
                break
            memo(cfg)
        for cfg in space.enumerate():
            if memo.evaluations >= self.budget:
                break
            memo(cfg)
        return self._mk_result(memo.trials)
