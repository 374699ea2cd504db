"""Coordinate descent with random restarts.

Tile spaces are nearly separable in their block dims, so sweeping one knob
at a time converges in about the sum of the domain sizes, not their product.
"""
from __future__ import annotations

from typing import Sequence

from ..params import Config, ParamSpace
from .base import ObjectiveFn, SearchAlgorithm, SearchResult, _Memo, make_rng


class CoordinateDescent(SearchAlgorithm):
    name = "coordinate"

    def __init__(self, budget: int = 64, seed: int = 0, restarts: int = 3):
        super().__init__(budget, seed)
        self.restarts = restarts

    def run(self, space: ParamSpace, objective: ObjectiveFn,
            seeds: Sequence[Config] = ()) -> SearchResult:
        rng = make_rng(self.seed)
        memo = _Memo(objective)

        def climb(start: Config) -> None:
            current = start
            cur_obj = memo(current).objective
            improved = True
            while improved and memo.evaluations < self.budget:
                improved = False
                for p in space.params:
                    # Sweep one knob's whole domain, keep the best.
                    best_v, best_o = current[p.name], cur_obj
                    for v in p.choices:
                        if v == current[p.name]:
                            continue
                        cand = dict(current)
                        cand[p.name] = v
                        if not space.is_valid(cand):
                            continue
                        if memo.evaluations >= self.budget:
                            break
                        o = memo(cand).objective
                        if o < best_o:
                            best_v, best_o = v, o
                    if best_v != current[p.name]:
                        current = dict(current)
                        current[p.name] = best_v
                        cur_obj = best_o
                        improved = True

        # Warm start: climb from each transferred seed; a seed near the
        # optimum converges in one sweep, well under budget.
        warm = self._valid_seeds(space, seeds)
        for start in warm:
            if memo.evaluations >= self.budget:
                break
            climb(start)
        if not warm:
            for r in range(max(1, self.restarts)):
                if memo.evaluations >= self.budget:
                    break
                climb(space.default() if r == 0 else space.sample(rng))
        return self._mk_result(memo.trials)
