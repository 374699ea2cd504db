"""The port's background tuner (``repro_torch.core.bgtune``) on the CPU: the
counterparts of ``tests/test_bgtune.py``, and the port's ``drain()``
reporting a worker that dies holding a job, in a loop.

Every ``drain()`` and every wait here has a timeout of seconds.
"""
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core

import repro_torch.obs as obs  # noqa: E402
from repro_torch.core.bgtune import BackgroundTuner, background_policy  # noqa: E402
from repro_torch.core.database import Record, TuningDatabase, make_key  # noqa: E402
from repro_torch.core.evaluate import WallClockEvaluator  # noqa: E402
from repro_torch.core.platform import platform_key  # noqa: E402
from repro_torch.core.runtime import TIERS, TunedRuntime  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.testing import FaultPlan, FaultRule  # noqa: E402

CPU = torch.device("cpu")
EVAL = WallClockEvaluator(repeats=1, warmup=0)


def _mat_args(m=64):
    g = torch.Generator().manual_seed(m)
    return torch.randn(m, 128, generator=g), torch.randn(128, 64, generator=g)


def _rms_args():
    return torch.ones(64, 32), torch.ones(32)


def _traffic(rt):
    """One simulated request batch: two kernels, one bucket each."""
    x, w = _mat_args()
    a, g = _rms_args()
    return rt.dispatch("matmul", x, w), rt.dispatch("rmsnorm", a, g)


def test_the_tier_sits_between_tune_and_cover():
    assert TIERS.index("tune") + 1 == TIERS.index("bgtune") == TIERS.index("cover") - 1


def test_cold_db_converges_to_exact_without_inline_tuning(tmp_path):
    db = TuningDatabase(None)
    delta_path = str(tmp_path / "bgtune_delta.json")
    tuner = BackgroundTuner(budget=3, evaluator=EVAL, export_path=delta_path, backoff_s=0.01)
    col = obs.collect(name="bgtune-e2e")
    try:
        with col, TunedRuntime(db=db, mode="kernel", policy=background_policy(tuner)) as rt:
            # cold: both buckets answer at once at tier "bgtune", uncached
            _traffic(rt)
            t = rt.telemetry.snapshot()["tiers"]
            assert t.get("bgtune") == 2 and "tune" not in t
            assert tuner.drain(timeout=30), f"tuner did not drain: {tuner!r}"
            assert tuner.promotions == 2 and tuner.failures == 0
            # the hot swap: the same traffic now resolves ExactHit (a miss:
            # bgtune resolutions were never cached)...
            out_m, _ = _traffic(rt)
            assert rt.telemetry.snapshot()["tiers"].get("exact") == 2
            # ...and the round after that from the resolution cache
            _traffic(rt)
            snap = rt.telemetry.snapshot()
            assert snap["cache_hits"] == 2
            assert "tune" not in snap["tiers"], "tuning ran on the request path"
            x, w = _mat_args()
            torch.testing.assert_close(out_m, ref.matmul(x, w), rtol=1e-4, atol=1e-4)
    finally:
        tuner.stop()
    promoted = tuner.promoted
    assert len(promoted) == 2
    for rec in promoted:
        assert db.lookup(rec.key) is not None and rec.meta["source"] == "bgtune"
        assert rec.key.split("|")[1] == platform_key(CPU)
    # the delta export: exactly the promoted records, loadable as it is
    delta = TuningDatabase(delta_path)
    assert sorted(delta.keys()) == sorted(r.key for r in promoted)
    snap = col.snapshot()
    assert "bgtune.promotions" in snap["counters"]
    assert "bgtune.queue_depth" in snap["gauges"]
    assert "bgtune.promote_latency_s" in snap["histograms"]
    prom_path = str(tmp_path / "bgtune.prom")
    col.write_prom(prom_path)
    with open(prom_path) as f:
        text = f.read()
    for name in ("bgtune_promotions", "bgtune_queue_depth", "bgtune_promote_latency_s"):
        assert name in text, f"{name} missing from the Prometheus export"


def test_the_worker_measures_the_calls_keyword_arguments():
    """A fused-activation bucket is tuned with its activation: the job's
    reference and variants run ``act="gelu"`` (read back from the key
    extra), so a promoted record measures what the live call runs."""
    db = TuningDatabase(None)
    tuner = BackgroundTuner(budget=2, evaluator=EVAL, backoff_s=0.01)
    x, w, b = torch.randn(16, 32), torch.randn(32, 64), torch.randn(64)
    try:
        with TunedRuntime(db=db, mode="kernel", policy=background_policy(tuner)) as rt:
            assert rt.resolve("matmul_bias_act", (x, w, b), key_extra="agelu").tier == "bgtune"
            assert tuner.drain(timeout=30) and tuner.promotions == 1
            assert rt.resolve("matmul_bias_act", (x, w, b), key_extra="agelu").tier == "exact"
    finally:
        tuner.stop()
    assert tuner.promoted[0].key.endswith("|agelu")


def test_resolve_never_blocks_on_a_busy_worker_and_parks_failures():
    """While the worker retries with backoff, resolves of the pending bucket
    stay at lookup speed; a job that spends its attempts parks the bucket on
    the heuristic config, with no new job."""
    db = TuningDatabase(None)
    tuner = BackgroundTuner(max_attempts=3, backoff_s=0.2, evaluator=EVAL)
    plan = FaultPlan([FaultRule(site="bgtune.worker:matmul", kind="error")])
    plan.install()
    col = obs.collect(name="bgtune-park")
    try:
        with col, TunedRuntime(db=db, mode="kernel", policy=background_policy(tuner)) as rt:
            x, w = _mat_args()
            assert rt.resolve("matmul", (x, w)).tier == "bgtune"
            lat = []
            for _ in range(50):
                t0 = time.perf_counter()
                res = rt.resolve("matmul", (x, w))
                lat.append(time.perf_counter() - t0)
                assert res.tier == "bgtune" and res.cache is False
            assert max(lat) < 0.05, f"resolve blocked: max {max(lat):.3f}s"
            assert tuner.drain(timeout=10)
            assert tuner.failures == 1 and tuner.promotions == 0
            assert plan.count("bgtune.worker:matmul", kind="error") == 3
            assert rt.resolve("matmul", (x, w)).tier == "bgtune"
            assert tuner.snapshot()["inflight"] == 0
            assert tuner.accepting
        warns = [e for e in col.events("warning") if e["name"] == "bgtune.job_failed"]
        assert len(warns) == 1 and "InjectedFault" in warns[0]["error"]
    finally:
        plan.uninstall()
        tuner.stop()


def test_worker_crash_demotes_to_heuristic_serving():
    db = TuningDatabase(None)
    tuner = BackgroundTuner(evaluator=EVAL)
    # InjectedWorkerCrash is a BaseException: it escapes the per-job
    # retries and kills the worker thread
    plan = FaultPlan([FaultRule(site="bgtune.worker:*", kind="crash")])
    plan.install()
    col = obs.collect(name="bgtune-crash")
    try:
        with col, TunedRuntime(db=db, mode="kernel", policy=background_policy(tuner)) as rt:
            x, w = _mat_args()
            assert rt.resolve("matmul", (x, w)).tier == "bgtune"
            assert not tuner.drain(timeout=10), "drain must report the death"
            assert not tuner.accepting
            assert "InjectedWorkerCrash" in tuner.snapshot()["death"]
            # a new bucket passes the dead tier to the heuristic, and caches
            a, g = _rms_args()
            assert rt.resolve("rmsnorm", (a, g)).tier == "heuristic"
            assert rt.resolve("rmsnorm", (a, g)).tier == "heuristic"
            assert rt.telemetry.snapshot()["cache_hits"] == 1
        assert any(e["name"] == "bgtune.worker_dead" for e in col.events("warning"))
    finally:
        plan.uninstall()
        tuner.stop()


def test_drain_reports_a_worker_that_dies_holding_its_only_job():
    """The reference's race: its worker records the death before its
    in-flight count falls, and its drain() tests for idle first, so a
    worker that dies on its last job can read as drained. The port's
    drain() reads both together: False in every run, whether it starts
    polling before, during or after the death."""
    plan = FaultPlan([FaultRule(site="bgtune.worker:*", kind="crash")])
    plan.install()
    try:
        for i in range(200):
            tuner = BackgroundTuner(evaluator=EVAL)
            with TunedRuntime(db=TuningDatabase(None), mode="kernel",
                              policy=background_policy(tuner)) as rt:
                assert rt.resolve("rmsnorm", _rms_args()).tier == "bgtune"
                if i % 3:
                    time.sleep(0.0005 * (i % 3))
                assert tuner.drain(timeout=5) is False, f"run {i}: a dead worker drained"
                assert not tuner.accepting
            tuner.stop()
    finally:
        plan.uninstall()


def test_full_queue_sheds_then_reoffers():
    db = TuningDatabase(None)
    # the worker busy on its first job (3 failing attempts, 0.25 s backoff)
    # with one queue slot behind it
    tuner = BackgroundTuner(max_queue=1, max_attempts=3, backoff_s=0.25, evaluator=EVAL)
    plan = FaultPlan([FaultRule(site="bgtune.worker:*", kind="error")])
    plan.install()
    col = obs.collect(name="bgtune-shed")
    try:
        with col, TunedRuntime(db=db, mode="kernel", policy=background_policy(tuner)) as rt:
            assert rt.resolve("matmul", _mat_args()).tier == "bgtune"
            deadline = time.monotonic() + 5
            while tuner.snapshot()["queue_depth"] > 0:      # the worker took it
                assert time.monotonic() < deadline
                time.sleep(0.005)
            assert rt.resolve("rmsnorm", _rms_args()).tier == "bgtune"      # queued
            # a third bucket: the queue is full, shed, still answered
            res = rt.resolve("matmul", _mat_args(m=256))
            assert res.tier == "bgtune" and res.cache is False
            assert tuner.shed == 1
            assert tuner.drain(timeout=10)
            # the shed key was released: resolving offers it again
            assert rt.resolve("matmul", _mat_args(m=256)).tier == "bgtune"
            assert tuner.snapshot()["inflight"] == 1
            assert tuner.drain(timeout=10)
        assert "bgtune.shed" in col.snapshot()["counters"]
    finally:
        plan.uninstall()
        tuner.stop()


def test_torn_db_file_degrades_to_cold_start(tmp_path):
    path = str(tmp_path / "torn.json")
    with open(path, "w") as f:
        f.write('{"records": {"k": ')      # a torn, half-written file
    db = TuningDatabase(path)
    key = make_key("matmul", platform_key(CPU), [(64, 128), (128, 64)], "float32")
    assert db.lookup(key) is None
    db.put(Record(key, {"bm": 64, "bn": 64, "bk": 128}, 1e-6, "wallclock", 1, 0.0))
    with open(path) as f:
        json.load(f)
    assert TuningDatabase(path).lookup(key) is not None
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_injected_torn_read_matches_real_corruption(tmp_path):
    path = str(tmp_path / "good.json")
    key = make_key("matmul", platform_key(CPU), [(64, 128), (128, 64)], "float32")
    TuningDatabase(path).put(Record(key, {"bm": 64, "bn": 64, "bk": 128}, 1e-6, "wallclock",
                                    1, 0.0))
    with FaultPlan([FaultRule(site=f"db.load:{path}", kind="torn")]) as plan:
        assert TuningDatabase(path).lookup(key) is None
        assert plan.count(kind="torn") == 1
    assert TuningDatabase(path).lookup(key) is not None      # the file was never harmed
