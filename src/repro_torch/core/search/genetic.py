"""Genetic search: tournament selection, uniform crossover, one-knob
mutation. For spaces whose knobs interact, where coordinate descent stalls."""
from __future__ import annotations

from typing import Sequence

from ..params import Config, ParamSpace
from .base import ObjectiveFn, SearchAlgorithm, SearchResult, _Memo, make_rng


class GeneticSearch(SearchAlgorithm):
    name = "genetic"

    def __init__(self, budget: int = 64, seed: int = 0, population: int = 8,
                 mutation_rate: float = 0.3, elite: int = 2):
        super().__init__(budget, seed)
        self.population = population
        self.mutation_rate = mutation_rate
        self.elite = elite

    def run(self, space: ParamSpace, objective: ObjectiveFn,
            seeds: Sequence[Config] = ()) -> SearchResult:
        rng = make_rng(self.seed)
        memo = _Memo(objective)

        # Seeds join the founding population; random immigrants fill it.
        pop = []
        for cfg in self._valid_seeds(space, seeds)[: self.population]:
            if memo.evaluations >= self.budget:
                break
            pop.append((memo(cfg).objective, cfg))
        while len(pop) < self.population:
            if memo.evaluations >= self.budget:
                break
            cfg = space.sample(rng)
            pop.append((memo(cfg).objective, cfg))

        def tournament():
            a, b = rng.choice(pop), rng.choice(pop)
            return a[1] if a[0] <= b[0] else b[1]

        proposals = 0
        # Children may all be memo hits, so bound the proposals too.
        while memo.evaluations < self.budget and pop and proposals < self.budget * 20:
            pop.sort(key=lambda t: t[0])
            next_pop = pop[: self.elite]
            while (len(next_pop) < self.population and memo.evaluations < self.budget
                   and proposals < self.budget * 20):
                proposals += 1
                child = space.crossover(tournament(), tournament(), rng)
                if rng.random() < self.mutation_rate:
                    child = space.random_neighbor(child, rng)
                next_pop.append((memo(child).objective, child))
            pop = next_pop
        return self._mk_result(memo.trials)
