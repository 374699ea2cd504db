"""The port's correctness gate and tuner on the CPU, beside the JAX
package's.

The gate cases are those of ``tests/test_correctness_gate.py`` and
``tests/test_tuner.py``, each run through both packages' gates on the same
numpy values, which must agree. The tuner cases run the port's autotune on
a small tunable: a variant that fails the gate or whose launch the card
refuses is pruned with its reason, any other error propagates, the heuristic
config wins when the budget does not beat it, and the record is banked
under the port's CPU platform key with the rest of the key equal to the
JAX package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import evaluate as jeval  # noqa: E402
from repro.core.tuner import _args_key as j_args_key  # noqa: E402
from repro.core.annotate import _REGISTRY as j_registry  # noqa: E402
from repro.core.annotate import tunable as j_tunable  # noqa: E402
from repro.core.params import ParamSpace as JSpace  # noqa: E402
from repro.core.params import PowerOfTwoParam as JPow  # noqa: E402
from repro_torch.core import evaluate as teval  # noqa: E402
from repro_torch.core.annotate import scoped_registry, tunable  # noqa: E402
from repro_torch.core.database import TuningDatabase, make_key  # noqa: E402
from repro_torch.core.params import EnumParam, ParamSpace, PowerOfTwoParam  # noqa: E402
from repro_torch.core.search import ExhaustiveSearch  # noqa: E402
from repro_torch.core.tuner import autotune, tune_or_lookup  # noqa: E402
from repro_torch.kernels._build import CudaError  # noqa: E402

nan, inf = np.nan, np.inf


def _both(out, ref, **kw) -> bool:
    """The port's verdict, after checking the JAX package gives the same."""
    conv = lambda t: jax.tree_util.tree_map(np.asarray, t)
    to_t = lambda t: jax.tree_util.tree_map(torch.from_numpy, conv(t))
    j = jeval.correctness_gate(conv(out), conv(ref), **kw)
    t = teval.correctness_gate(to_t(out), to_t(ref), **kw)
    assert t == j
    return t


def _a(*v):
    return np.array(v, np.float32)


@pytest.mark.parametrize("out,ref,expect", [
    (_a(1.0, nan, 3.0), _a(1.0, nan, 3.0), True),        # NaNs where the reference has them
    (_a(1.0, nan, 3.0), _a(1.0, 2.0, 3.0), False),       # NaN where the reference is finite
    (_a(2.0, nan), _a(nan, 2.0), False),                 # NaN positions must align
    (np.full(4, nan, np.float32), np.full(4, nan, np.float32), True),
    (np.zeros(4, np.float32), np.full(4, nan, np.float32), False),
    (np.zeros((0,), np.float32), np.zeros((1,), np.float32), False),
    (_a(inf, 100.0, -100.0), _a(inf, 100.0, -100.0), True),
    (_a(inf, 100.0005, -100.0), _a(inf, 100.0, -100.0), True),   # atol scales with 100
    (np.ones((4, 4), np.float32), np.ones((4, 4), np.float32) + 1e-7, True),
    (np.ones((4, 4), np.float32), np.ones((4, 4), np.float32) + 1.0, False),
    (np.ones((4, 4), np.float32), np.ones((4, 5), np.float32), False),
], ids=["nan-match", "nan-extra", "nan-misaligned", "all-nan", "all-nan-vs-zero",
        "zero-size-vs-one", "inf-match", "finite-scale", "close", "far", "shape"])
def test_gate_cases_agree_with_jax(out, ref, expect):
    assert _both(out, ref) is expect


def test_gate_tree_structure():
    x, y = np.ones((2,), np.float32), np.zeros((2,), np.float32)
    z = {"a": np.zeros((0, 8), np.float32), "b": np.ones((2,), np.float32)}
    assert _both(z, z)
    assert not _both({"a": x, "b": y}, [x, y])
    assert not _both((x, (y,)), ((x,), y))
    assert _both({"a": x, "b": y}, {"a": x, "b": y})


def test_gate_dtype_decides_before_the_upcast():
    ref = torch.ones(8)
    drift = 5e-3
    out_bf16 = (torch.ones(8) + drift).to(torch.bfloat16)
    out_f32 = torch.ones(8) + drift
    assert teval.correctness_gate(out_bf16, ref)          # the coarser dtype decides
    assert not teval.correctness_gate(out_f32, ref)
    assert teval.correctness_gate(out_f32, ref, rtol=1e-2, atol=1e-2)
    assert not teval.correctness_gate(out_bf16, ref, rtol=1e-6, atol=1e-6)
    r = torch.from_numpy(np.linspace(0.5, 2.0, 16).astype(np.float32)).to(torch.bfloat16)
    assert teval.correctness_gate(r + r * 1e-2, r)
    assert teval.tolerance_for(torch.bfloat16) == jeval.tolerance_for(jnp.bfloat16)
    assert teval.tolerance_for(torch.float32) == jeval.tolerance_for(jnp.float32)


@pytest.fixture(autouse=True)
def _own_registry():
    """The toys a test here registers leave the port's registry with the test:
    repro_torch.analysis's contracts pass reads the whole process-wide
    registry, whichever test files ran before it on the worker."""
    with scoped_registry():
        yield


def _toy(name, refuse=None, crash=None):
    """sum(x^2) in chunks; mode b is wrong (fails the gate); chunk ``refuse``
    raises a refused launch, chunk ``crash`` a fault."""
    space = ParamSpace([PowerOfTwoParam("chunk", 8, 64), EnumParam("mode", ["a", "b"])])

    def ref(x):
        return (x * x).sum()

    @tunable(name, space=space, reference=ref)
    def toy(x, *, chunk, mode):
        if chunk == refuse:
            raise CudaError(9, "toy: CUDA error 9 (invalid configuration argument)")
        if chunk == crash:
            raise CudaError(700, "toy: CUDA error 700 (an illegal memory access)")
        if mode == "b":
            return x.sum()
        pad = (-x.shape[0]) % chunk
        return (torch.nn.functional.pad(x, (0, pad)) ** 2).reshape(-1, chunk).sum(1).sum()

    return toy


def _x(n=100):
    return torch.from_numpy(np.random.RandomState(0).randn(n).astype(np.float32))


def _ev():
    return teval.WallClockEvaluator(repeats=1, warmup=0)


def test_autotune_prunes_wrong_and_refused_variants(tmp_path):
    toy = _toy("ttoy1", refuse=16)
    db = TuningDatabase(str(tmp_path / "db.json"))
    res = autotune(toy, (_x(),), search=ExhaustiveSearch(budget=100), evaluator=_ev(), db=db)
    assert res.best_config["mode"] == "a" and res.best_config["chunk"] != 16
    by = {(t.config["chunk"], t.config["mode"]): t for t in res.search.trials}
    assert all(not by[(c, "b")].ok and by[(c, "b")].meta["pruned"] == "correctness gate failed"
               for c in (8, 32, 64))
    refused = by[(16, "a")]
    assert not refused.ok and refused.meta["pruned"].startswith("refused launch (CUDA error 9)")
    assert len(TuningDatabase(str(tmp_path / "db.json"))) == 1       # persisted


def test_autotune_lets_a_fault_propagate():
    toy = _toy("ttoy2", crash=32)
    with pytest.raises(CudaError, match="illegal memory access"):
        autotune(toy, (_x(),), search=ExhaustiveSearch(budget=100), evaluator=_ev(),
                 db=TuningDatabase(None))


def test_autotune_keeps_the_heuristic_when_the_budget_does_not_beat_it():
    space = ParamSpace([PowerOfTwoParam("chunk", 8, 64)])
    ran = []

    @tunable("ttoy3", space=space, reference=lambda x: x * 2,
             heuristic=lambda x: {"chunk": 64})
    def toy(x, *, chunk):
        ran.append(chunk)
        return x * 2

    class ByConfig(teval.Evaluator):
        """Deterministic 'time': the heuristic's chunk 64 is fastest."""

        name = "by-config"

        def evaluate(self, fn, args, reference=None):
            fn(*args)
            return teval.Measurement(1.0 / ran[-1], True)

    db = TuningDatabase(None)
    res = autotune(toy, (_x(),), search=ExhaustiveSearch(budget=1), evaluator=ByConfig(),
                   db=db)
    assert res.search.evaluations == 1 and res.search.best_config == {"chunk": 8}
    assert res.best_config == {"chunk": 64} and res.default_objective == 1.0 / 64
    assert db.records()[0].config == {"chunk": 64} and db.records()[0].evaluator == "by-config"


def test_record_key_is_the_jax_key_under_the_port_platform():
    toy = _toy("ttoy4")
    db = TuningDatabase(None)
    x = _x(300)
    autotune(toy, (x,), search=ExhaustiveSearch(budget=3), evaluator=_ev(), db=db)
    (key,) = db.keys()
    assert key == make_key("ttoy4", "torch-cpu", [(300,)], "float32")

    # a fake in the JAX package's registry, removed again: the registry is
    # process-wide, and the JAX package's contract checks read all of it
    try:
        @j_tunable("ttoy4_jax", space=JSpace([JPow("chunk", 8, 64)]))
        def jtoy(x, *, chunk):
            return x

        jkey = j_args_key(jtoy, (jnp.zeros(300, jnp.float32),), "torch-cpu")
    finally:
        j_registry.pop("ttoy4_jax", None)
    assert key.split("|")[2:] == jkey.split("|")[2:]
    assert "ttoy4_jax" not in j_registry


def test_tune_or_lookup_roundtrip():
    toy = _toy("ttoy5")
    db = TuningDatabase(None)
    x = _x(64)
    res = autotune(toy, (x,), search=ExhaustiveSearch(budget=100), evaluator=_ev(), db=db)
    assert tune_or_lookup(toy, (x,), db=db) == res.best_config
    y = _x(65)                                         # another bucket: the heuristic
    assert tune_or_lookup(toy, (y,), db=db) == toy.default_config(y)
    db.put_cover("ttoy5", "torch-cpu", [{"config": {"chunk": 32, "mode": "a"},
                                         "support": [[[128]]], "share": 1.0}], save=False)
    assert tune_or_lookup(toy, (y,), db=db) == {"chunk": 32, "mode": "a"}
    assert tune_or_lookup(toy, (y,), db=db, allow_tune=True, search=ExhaustiveSearch(budget=4),
                          evaluator=_ev())["mode"] == "a"
    assert any("|128|" in k for k in db.keys())


def test_call_kwargs_reach_variant_and_reference():
    from repro_torch.kernels import fused

    rs = np.random.RandomState(0)
    x, w = (torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in ((20, 16), (16, 24)))
    b = torch.zeros(24)
    res = autotune(fused.matmul_bias_act, (x, w, b), search=ExhaustiveSearch(budget=2),
                   evaluator=_ev(), db=TuningDatabase(None), key_extra="asilu",
                   call_kwargs={"act": "silu"})
    assert res.search.best.ok
