"""Simulated annealing over one-knob-step neighbourhoods."""
from __future__ import annotations

import math
from typing import Sequence

from ..params import Config, ParamSpace
from .base import INVALID, ObjectiveFn, SearchAlgorithm, SearchResult, _Memo, make_rng


class SimulatedAnnealing(SearchAlgorithm):
    name = "anneal"

    def __init__(self, budget: int = 64, seed: int = 0, t0: float = 1.0,
                 cooling: float = 0.92):
        super().__init__(budget, seed)
        self.t0 = t0
        self.cooling = cooling

    def run(self, space: ParamSpace, objective: ObjectiveFn,
            seeds: Sequence[Config] = ()) -> SearchResult:
        rng = make_rng(self.seed)
        memo = _Memo(objective)

        # Start from the first seed; the others are measured only while
        # budget remains.
        warm = self._valid_seeds(space, seeds)
        current = warm[0] if warm else space.sample(rng)
        cur = memo(current)
        for cfg in warm[1:]:
            if memo.evaluations >= self.budget:
                break
            memo(cfg)
        t = self.t0
        proposals = 0
        # Neighbourhoods are finite: once every neighbour is memoized the
        # evaluation count stops growing, so bound the proposals too.
        while memo.evaluations < self.budget and proposals < self.budget * 20:
            proposals += 1
            cand_cfg = space.random_neighbor(current, rng)
            if not cand_cfg:
                break
            cand = memo(cand_cfg)
            # Accept a better candidate always, a worse one with Boltzmann
            # probability on the relative difference (unit-free).
            if cand.objective < cur.objective:
                current, cur = cand_cfg, cand
            elif cur.objective < INVALID and cand.objective < INVALID:
                rel = (cand.objective - cur.objective) / max(cur.objective, 1e-12)
                if rng.random() < math.exp(-rel / max(t, 1e-6)):
                    current, cur = cand_cfg, cand
            t *= self.cooling
            if t < 1e-4:  # reheat late in the budget
                t = self.t0 / 2
                current = space.sample(rng)
                cur = memo(current)
        return self._mk_result(memo.trials)
