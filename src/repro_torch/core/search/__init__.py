"""Budgeted search strategies over a :class:`~repro_torch.core.params.ParamSpace`.

One for one with ``repro.core.search``: the same five strategies, the same
random draws (Python's ``random.Random`` seeded alike), so with the same
seed and objective each proposes the same trials in the same order as the
JAX package's.
"""
from .base import INVALID, SearchAlgorithm, SearchResult, Trial  # noqa: F401
from .exhaustive import ExhaustiveSearch
from .random_search import RandomSearch
from .coordinate import CoordinateDescent
from .anneal import SimulatedAnnealing
from .genetic import GeneticSearch

ALGORITHMS = {
    a.name: a
    for a in (ExhaustiveSearch, RandomSearch, CoordinateDescent, SimulatedAnnealing,
              GeneticSearch)
}


def make_search(name: str, **kwargs) -> SearchAlgorithm:
    if name not in ALGORITHMS:
        raise KeyError(f"unknown search algorithm {name!r}; have {sorted(ALGORITHMS)}")
    return ALGORITHMS[name](**kwargs)
