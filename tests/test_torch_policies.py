"""The port's resolution policies, cache bounds, platform override and
``fusion_wins``, on the CPU: the cases of ``tests/test_runtime.py``
(warmup, tier accounting, the bounded cache) on the port, plus TuneNow,
CoverSet and the platform namespace, which the JAX package tests
elsewhere. Keys are checked against the JAX package's key function where
one is built by hand.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")

import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import runtime as rtmod  # noqa: E402
from repro_torch.core.database import Record, TuningDatabase, make_key  # noqa: E402
from repro_torch.core.evaluate import WallClockEvaluator  # noqa: E402
from repro_torch.core.runtime import (  # noqa: E402
    CoverSet, ExactHit, Heuristic, Reference, TuneNow, default_policy, dispatch)
from repro_torch.core.search import ExhaustiveSearch  # noqa: E402
from repro_torch.kernels.matmul import matmul as matmul_tunable  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_tunable  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402


def _rows(rt, rows):
    w = torch.ones(32)
    return rt.resolve(rmsnorm_tunable, (torch.ones(rows, 32), w))


def _mm_args():
    rs = np.random.RandomState(0)
    return (torch.from_numpy(rs.randn(64, 128).astype(np.float32)),
            torch.from_numpy(rs.randn(128, 64).astype(np.float32)))


def test_default_policy_is_the_jax_order():
    assert [p.name for p in default_policy()] == ["exact", "tune", "cover", "heuristic",
                                                  "reference"]


def test_tier_accounting_exact_cover_heuristic():
    db = TuningDatabase(None)
    db.put(Record(make_key("rmsnorm", "torch-cpu", [(64, 32), (32,)], "float32"),
                  {"block_rows": 8}, 1e-6, "wallclock", 1, 0.0))
    db.put_cover("rmsnorm", "torch-cpu",
                 [{"config": {"block_rows": 16}, "support": [[[128, 32], [32]]], "share": 1.0}])
    with repro_torch.runtime(db=db) as rt:
        assert _rows(rt, 64).tier == "exact"
        cover = _rows(rt, 256)
        assert cover.tier == "cover" and cover.config == {"block_rows": 16}
        assert rt.resolve(matmul_tunable, _mm_args()).tier == "heuristic"
    snap = rt.telemetry.snapshot()
    assert snap["tiers"] == {"exact": 1, "cover": 1, "heuristic": 1}


def test_exact_or_reference_policy():
    x, w = _mm_args()
    db = TuningDatabase(None)
    with repro_torch.runtime(db=db, policy=(ExactHit(), Reference())) as rt:
        torch.testing.assert_close(dispatch("matmul", x, w), x @ w)
        assert rt.telemetry.snapshot()["tiers"] == {"reference": 1}
        db.put(Record(make_key("matmul", "torch-cpu", [(64, 128), (128, 64)], "float32"),
                      {"bm": 64, "bn": 128, "bk": 64, "stages": 4, "splits": 1}, 1e-6, "w", 1,
                      0.0))
        rt.clear_cache()
        dispatch("matmul", x, w)
        assert rt.telemetry.snapshot()["tiers"]["exact"] == 1


def test_tune_now_tunes_only_where_allowed_and_banks_the_record():
    x, w = _mm_args()
    db = TuningDatabase(None)
    kw = {"search": ExhaustiveSearch(budget=2),
          "evaluator": WallClockEvaluator(repeats=1, warmup=0)}
    with repro_torch.runtime(db=db) as rt:
        assert rt.resolve(matmul_tunable, (x, w)).tier == "heuristic"
    assert len(db) == 0
    with repro_torch.runtime(db=db, allow_tune=True, tune_kwargs=kw) as rt:
        res = rt.resolve(matmul_tunable, (x, w))
        assert res.tier == "tune" and matmul_tunable.space.is_valid(res.config)
        assert db.lookup(res.key).config == res.config
        rt.clear_cache()
        assert rt.resolve(matmul_tunable, (x, w)).tier == "exact"
    # a per-call grant on a runtime that does not allow tuning
    db2 = TuningDatabase(None)
    with repro_torch.runtime(db=db2) as rt:
        assert rt.resolve(rmsnorm_tunable, (torch.ones(8, 32), torch.ones(32)),
                          allow_tune=True, tune_kwargs=kw).tier == "tune"
        assert not rt.allow_tune and len(db2) == 1
    assert TuneNow().name == "tune" and CoverSet().name == "cover" and Heuristic().name


def test_platform_override_namespaces_the_keys():
    x, w = _mm_args()
    db = TuningDatabase(None)
    key = make_key("matmul", "h100-sxm", [(64, 128), (128, 64)], "float32")
    db.put(Record(key, {"bm": 128, "bn": 128, "bk": 64, "stages": 3, "splits": 1}, 1e-6, "w",
                  1, 0.0))
    with repro_torch.runtime(db=db) as rt:
        assert rt.resolve(matmul_tunable, (x, w)).tier == "heuristic"     # torch-cpu key
    with repro_torch.runtime(db=db, platform="h100-sxm") as rt:
        res = rt.resolve(matmul_tunable, (x, w))
        assert res.tier == "exact" and res.key == key
        with repro_torch.runtime() as inner:                              # inherited
            assert inner.platform == "h100-sxm"
        assert "platform=h100-sxm" in repr(rt)


def test_fusion_wins_is_a_pure_exact_lookup():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 5, 16).astype(np.float32))
    w = torch.from_numpy(rs.randn(16, 24).astype(np.float32))
    b = torch.zeros(24)
    key = make_key("matmul_bias_act", "torch-cpu", [(10, 16), (16, 24), (24,)], "float32",
                   "asilu")
    db = TuningDatabase(None)
    with repro_torch.runtime(db=db) as rt:
        assert not rt.fusion_wins("matmul_bias_act", x, w, b, act="silu")
        db.put(Record(key, {"bm": 7, "bn": 32, "bk": 16}, 1e-6, "w", 1, 0.0))
        assert not rt.fusion_wins("matmul_bias_act", x, w, b, act="silu")   # invalid config
        db.put(Record(key, {"bm": 16, "bn": 64, "bk": 64, "stages": 4, "splits": 1}, 1e-7, "w",
                      1, 0.0))
        assert rt.fusion_wins("matmul_bias_act", x, w, b, act="silu")
        assert not rt.fusion_wins("matmul_bias_act", x, w, b, act="gelu")   # another key
        assert not rt.fusion_wins("no_such_tunable", x)
        assert rt.telemetry.snapshot()["calls"] == 0 and rt.cache_size == 0
    with repro_torch.runtime(db=db, mode="reference") as rt:
        assert not rt.fusion_wins("matmul_bias_act", x, w, b, act="silu")


def test_cache_lru_capacity_bounds_growth():
    with repro_torch.runtime(db=TuningDatabase(None), cache_capacity=2) as rt:
        for rows in (16, 64, 256, 1024):
            _rows(rt, rows)
        assert rt.cache_size == 2
        assert rt.telemetry.snapshot()["cache_evictions"] == 2
        _rows(rt, 1024)
        assert rt.telemetry.snapshot()["cache_hits"] == 1


def test_cache_lru_touch_on_hit():
    with repro_torch.runtime(db=TuningDatabase(None), cache_capacity=2) as rt:
        for rows in (16, 64, 16, 256, 16):
            _rows(rt, rows)
        assert rt.telemetry.snapshot()["cache_hits"] == 2


def test_cache_ttl_expires_entries(monkeypatch):
    t = {"now": 1000.0}
    monkeypatch.setattr(rtmod.time, "monotonic", lambda: t["now"])
    with repro_torch.runtime(db=TuningDatabase(None), cache_ttl=10.0) as rt:
        _rows(rt, 16)
        t["now"] += 5.0
        _rows(rt, 16)
        assert rt.telemetry.snapshot()["cache_hits"] == 1
        t["now"] += 11.0
        _rows(rt, 16)
        snap = rt.telemetry.snapshot()
        assert snap["cache_hits"] == 1 and snap["cache_evictions"] == 1


def test_cache_params_inherit():
    with repro_torch.runtime(cache_capacity=7, cache_ttl=3.0, allow_tune=True):
        inner = repro_torch.runtime()
        assert inner.cache_capacity == 7 and inner.cache_ttl == 3.0 and inner.allow_tune
        assert repro_torch.runtime(cache_capacity=9).cache_capacity == 9


def _engine(runtime=None, max_seq=32):
    cfg = get_config("qwen2_0_5b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, ServingEngine(cfg, RunConfig(remat="none", loss_chunk=16, q_chunk=16,
                                             k_chunk=16), params,
                              EngineConfig(max_batch=2, max_seq=max_seq), runtime=runtime)


def test_warmup_resolves_against_the_passed_db_without_install():
    cfg, eng = _engine()
    key = make_key("rmsnorm", "torch-cpu", [(2, cfg.d_model), (cfg.d_model,)], "float32")
    art = TuningDatabase(None)
    art.put(Record(key, {"block_rows": 8}, 1e-6, "wallclock", 1, 0.0))
    resolved = eng.warmup(db=art, install=False, max_tokens=2048)
    assert eng.runtime is None                       # nothing installed
    assert resolved[key] == {"block_rows": 8}       # the artifact was consulted
    eng.warmup(db=art)                               # install: the engine reads it now
    assert eng.runtime is not None and eng.runtime.db is art


def test_warmed_serving_engine_reports_tiers():
    rt = repro_torch.runtime(mode="reference", db=TuningDatabase(None), name="test-engine")
    cfg, eng = _engine(runtime=rt, max_seq=64)
    resolved = eng.warmup(max_tokens=2048)
    assert resolved and all(c is not None for c in resolved.values())
    assert rt.cache_size > 0
    assert eng.serving_buckets() == [(1, 16), (1, 32), (1, 64), (2, 16), (2, 32), (2, 64)]
    prompt = np.arange(1, 9, dtype=np.int32) % cfg.vocab_size
    eng.submit(Request(prompt=prompt, max_new_tokens=3))
    eng.submit(Request(prompt=prompt[:5], max_new_tokens=3))
    assert len(eng.serve()) == 2
    snap = rt.telemetry.snapshot()
    assert snap["tiers"].get("heuristic", 0) > 0        # warmup on an empty database
    assert snap["tiers"].get("reference", 0) > 0        # serving in reference mode
    assert any(k.startswith("rmsnorm|") for k in snap["by_key"])
