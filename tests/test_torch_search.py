"""The port's search strategies against the JAX package's, on the CPU.

With the same space, seed, seeds and a deterministic objective, each of the
five strategies must propose the same trials in the same order and return
the same best as ``repro.core.search``: both draw from Python's
``random.Random`` through the same space helpers. Exact equality, no
tolerance: the objective is a pure function of the config.
"""
import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")

from repro.core import params as jparams  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.search.base import Trial as JTrial  # noqa: E402
from repro_torch.core import params as tparams  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.search.base import INVALID, Trial as TTrial  # noqa: E402


def _space(P):
    """bm x bn x mode with a cross-knob constraint."""
    return P.ParamSpace(
        [P.PowerOfTwoParam("bm", 8, 128), P.PowerOfTwoParam("bn", 16, 256),
         P.EnumParam("mode", ["a", "b", "c"])],
        [P.Constraint(lambda c: c["bm"] * c["bn"] <= 8192, "tile too large")],
    )


def _cost(cfg) -> float:
    """A bumpy deterministic objective with invalid configs (mode c at
    bm 32 fails, as a variant that fails the gate would)."""
    if cfg["mode"] == "c" and cfg["bm"] == 32:
        return INVALID
    return (abs(cfg["bm"] - 32) * 0.7 + abs(cfg["bn"] - 64) * 0.3
            + {"a": 5.0, "b": 1.0, "c": 3.0}[cfg["mode"]] + (cfg["bm"] * cfg["bn"]) % 7)


def _objective(Trial):
    seen = []

    def fn(cfg):
        seen.append(dict(cfg))
        o = _cost(cfg)
        return Trial(config=cfg, objective=o, ok=o < INVALID)

    return fn, seen


SEEDS = [{"bm": 64, "bn": 64, "mode": "a"}, {"bm": 128, "bn": 128, "mode": "a"},
         {"bm": 16, "bn": 32, "mode": "b"}]

CASES = [
    ("exhaustive", {"budget": 30}),
    ("random", {"budget": 12, "seed": 3}),
    ("coordinate", {"budget": 20, "seed": 1, "restarts": 3}),
    ("anneal", {"budget": 25, "seed": 5}),
    ("genetic", {"budget": 24, "seed": 7, "population": 6}),
]


@pytest.mark.parametrize("with_seeds", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_search_proposes_the_jax_trials(name, kw, with_seeds):
    seeds = SEEDS if with_seeds else ()
    j_obj, j_seen = _objective(JTrial)
    t_obj, t_seen = _objective(TTrial)
    j_res = jsearch.make_search(name, **kw).run(_space(jparams), j_obj, seeds=seeds)
    t_res = tsearch.make_search(name, **kw).run(_space(tparams), t_obj, seeds=seeds)
    assert t_seen == j_seen and t_seen
    assert [t.config for t in t_res.trials] == [t.config for t in j_res.trials]
    assert t_res.evaluations == j_res.evaluations <= kw["budget"]
    assert t_res.best_config == j_res.best_config
    assert t_res.best_objective == j_res.best_objective


def test_registry_names_match():
    assert set(tsearch.ALGORITHMS) == set(jsearch.ALGORITHMS)
    with pytest.raises(KeyError):
        tsearch.make_search("nope")


def test_space_helpers_draw_like_jax():
    js, ts = _space(jparams), _space(tparams)
    jr, tr = random.Random(11), random.Random(11)
    for _ in range(20):
        a, b = js.sample(jr), ts.sample(tr)
        assert a == b
        assert js.neighbors(a) == ts.neighbors(b)
        assert js.random_neighbor(a, jr) == ts.random_neighbor(b, tr)
        c = js.sample(jr)
        assert ts.sample(tr) == c
        assert js.crossover(a, c, jr) == ts.crossover(b, c, tr)
    assert ts["bm"].neighbors(8) == [16] and ts["bm"].neighbors(32) == [16, 64]


def test_invalid_seeds_are_dropped_and_all_invalid_means_no_best():
    space = _space(tparams)
    bad = {"bm": 128, "bn": 256, "mode": "a"}           # breaks the constraint
    fn = lambda cfg: TTrial(config=cfg, objective=INVALID, ok=False)
    res = tsearch.ExhaustiveSearch(budget=4).run(space, fn, seeds=[bad])
    assert bad not in [t.config for t in res.trials]
    assert res.best is None and res.best_objective == INVALID
    with pytest.raises(RuntimeError, match="no valid variant"):
        res.best_config
