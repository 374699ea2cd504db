"""The port's observability plane (``repro_torch.obs``): the counterparts of
``tests/test_obs.py`` but the drift detector (``tests/test_torch_drift.py``),
and its parity with the JAX
package's ``repro.obs``: the same samples give the same histogram rows, and
the same snapshot renders and diffs to the same text."""
import json
import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core

import repro.obs as jobs  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs.metrics import Histogram as JHistogram  # noqa: E402
from repro_torch.obs import export  # noqa: E402
from repro_torch.obs.collect import ObsCollector, current_collector  # noqa: E402
from repro_torch.obs.metrics import Counter, Gauge, Histogram, percentile_row, tags_key  # noqa: E402
from repro_torch.obs.trace import current_span, span, span_tree  # noqa: E402


# ---------------------------------------------------------------------------
# metric primitives, against the JAX package's
# ---------------------------------------------------------------------------

_SAMPLES = {
    "lognormal": lambda rs: rs.lognormal(mean=-7.0, sigma=1.0, size=5000),
    "uniform_ms": lambda rs: rs.rand(700) * 1e-3,
    "with_zero_and_negative": lambda rs: np.concatenate([[0.0, -1.0], rs.rand(50)]),
    "one": lambda rs: np.array([3e-3]),
}


@pytest.mark.parametrize("name", list(_SAMPLES))
def test_histogram_rows_equal_jax(name):
    samples = _SAMPLES[name](np.random.RandomState(0))
    h, jh = Histogram(), JHistogram()
    for v in samples:
        h.observe(v)
        jh.observe(v)
    assert h.snapshot() == jh.snapshot()
    for q in (0.1, 0.5, 0.9, 0.95, 0.99):
        assert h.quantile(q) == jh.quantile(q)
    if name == "lognormal":
        for q in (0.50, 0.95, 0.99):
            exact = float(np.quantile(samples, q))
            assert abs(h.quantile(q) - exact) / exact < 0.12     # 4 buckets an octave
        assert math.isclose(h.sum, float(samples.sum()), rel_tol=1e-9)
    if name == "one":
        assert h.snapshot()["p50"] == h.snapshot()["p99"] == 3e-3
    if name == "with_zero_and_negative":
        assert h.min == -1.0 and h.quantile(0.01) == 0.0


def test_histogram_merge_equals_union_and_jax():
    rs = np.random.RandomState(1)
    xs, ys = rs.rand(200) * 1e-3, rs.rand(300) * 1e-2
    a, b, u = Histogram(), Histogram(), Histogram()
    ja, jb = JHistogram(), JHistogram()
    for v in xs:
        a.observe(v)
        ja.observe(v)
        u.observe(v)
    for v in ys:
        b.observe(v)
        jb.observe(v)
        u.observe(v)
    a.merge(b)
    ja.merge(jb)
    assert a.snapshot() == ja.snapshot()
    sa, su = a.snapshot(), u.snapshot()
    for field in ("count", "min", "max", "p50", "p95", "p99"):
        assert sa[field] == su[field], field
    assert math.isclose(sa["sum"], su["sum"])
    assert Histogram().snapshot()["count"] == 0 and Histogram().quantile(0.5) == 0.0


def test_counter_gauge_and_tags_key():
    c, g = Counter(), Gauge()
    c.add()
    c.add(2.5)
    g.set(4)
    g.set(7)
    assert c.snapshot() == {"value": 3.5}
    assert g.snapshot() == {"value": 7.0, "updates": 2}
    assert tags_key({"b": 2, "a": "x"}) == (("a", "x"), ("b", "2"))


# ---------------------------------------------------------------------------
# collector: scoping, sampling, warnings, events
# ---------------------------------------------------------------------------

def test_default_collector_disabled_and_scopes_nest():
    assert not current_collector().enabled
    obs.counter("t.never")
    with obs.collect(name="outer") as outer:
        with obs.collect(name="inner") as inner:
            assert current_collector() is inner
            obs.counter("c")
        assert current_collector() is outer
        obs.counter("c")
    assert "t.never" not in outer.snapshot()["counters"]
    assert inner.snapshot()["counters"]["c"][0]["value"] == 1
    assert outer.snapshot()["counters"]["c"][0]["value"] == 1


def test_thread_isolation():
    seen = {}

    def worker():
        seen["col"] = current_collector()

    with obs.collect(name="main-scope"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert not seen["col"].enabled and seen["col"].name == "default"


def test_tagged_rows_are_separate():
    with obs.collect(name="t") as col:
        col.counter("calls", kernel="matmul", tier="exact")
        col.counter("calls", kernel="matmul", tier="exact")
        col.counter("calls", kernel="rmsnorm", tier="cover")
    rows = col.snapshot()["counters"]["calls"]
    by_tags = {tuple(sorted(r["tags"].items())): r["value"] for r in rows}
    assert by_tags[(("kernel", "matmul"), ("tier", "exact"))] == 2
    assert by_tags[(("kernel", "rmsnorm"), ("tier", "cover"))] == 1


@pytest.mark.parametrize("rate, hits", [(0.25, 25), (1.0, 100), (0.0, 0)])
def test_sampling_deterministic_one_in_n(rate, hits):
    col = ObsCollector(name="s", sample_rate=rate)
    assert sum(col.sample() for _ in range(100)) == hits


def test_warn_once_dedup_and_fires_when_disabled():
    col = ObsCollector(name="w", enabled=False)
    assert col.warn_once("hazard", key="k1", detail="d") is True
    assert col.warn_once("hazard", key="k1") is False
    assert col.warn_once("hazard", key="k2") is True
    warnings = col.events(kind="warning")
    assert len(warnings) == 2
    assert warnings[0]["key"] == "k1" and warnings[0]["detail"] == "d"
    assert len(col.snapshot()["warnings"]) == 2


def test_event_ring_buffer_bounded_and_kinds_checked():
    col = ObsCollector(name="rb", max_events=16)
    for i in range(100):
        col.event("e", i=i)
    assert [e["i"] for e in col.events()] == list(range(84, 100))
    with pytest.raises(ValueError):
        ObsCollector(name="x").event("e", kind="bogus")


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_disabled_yields_none():
    with span("s") as sp:
        assert sp is None
    assert current_span() is None


def test_span_tree_and_histogram():
    with obs.collect(name="t") as col:
        with span("outer", step=3) as sp:
            assert current_span() is sp
            with span("inner") as child:
                assert child.parent_id == sp.span_id
            sp.set(extra="field")
        assert current_span() is None
    snap = col.snapshot()
    assert snap["histograms"]["span.outer"][0]["tags"] == {}
    assert snap["histograms"]["span.inner"][0]["count"] == 1
    spans = {e["name"]: e for e in col.events(kind="span")}
    assert spans["outer"]["step"] == 3 and spans["outer"]["extra"] == "field"
    tree = span_tree(col.events())
    assert [e["name"] for e in tree[None]] == ["outer"]
    assert [e["name"] for e in tree[spans["outer"]["span_id"]]] == ["inner"]


def test_profiler_annotations_name_the_ranges():
    """``profiler_annotations`` (the JAX package's ``xla_annotations``) wraps
    each span in ``torch.profiler.record_function``: the span is a named
    range in a profiler window."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.collect(name="t", profiler_annotations=True) as col:
            with span("annotated"):
                torch.ones(4).sum()
    assert col.snapshot()["histograms"]["span.annotated"][0]["count"] == 1
    assert "annotated" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# export: snapshot round trip, jsonl, prom, rendering and diffs against JAX's
# ---------------------------------------------------------------------------

def _sample(mod, scale=1.0):
    with mod.collect(name="exp") as col:
        col.counter("reqs", 3, route="a")
        col.gauge("depth", 7)
        for v in (1e-3, 2e-3, 4e-3):
            col.observe("lat_s", v * scale)
        col.event("boot", phase="init")
        col.warn_once("hazard", key="k", detail="d")
    return col


def _stable(snap):
    """A snapshot without its clock readings."""
    out = json.loads(json.dumps(snap))
    out["meta"] = {k: v for k, v in out["meta"].items() if k not in ("created", "exported")}
    for e in out["events"] + out["warnings"]:
        e.pop("ts")
    return out


def test_snapshot_renders_and_diffs_as_jax():
    a, b = _sample(obs).snapshot(), _sample(obs, 10.0).snapshot()
    ja, jb = _sample(jobs).snapshot(), _sample(jobs, 10.0).snapshot()
    assert _stable(a) == _stable(ja)
    assert export.format_snapshot(a, max_events=5) == jexport.format_snapshot(ja, max_events=5)
    assert export.diff_snapshots(a, b) == jexport.diff_snapshots(ja, jb)
    assert export.format_diff(export.diff_snapshots(a, b)) == jexport.format_diff(
        jexport.diff_snapshots(ja, jb))
    row = export.diff_snapshots(a, b)["histograms"]["lat_s"][0]
    assert row["p50"]["ratio"] > 5
    assert "(no differences)" in export.format_diff(export.diff_snapshots(a, a))


def test_snapshot_file_round_trips(tmp_path):
    p = str(tmp_path / "m.json")
    col = _sample(obs)
    col.write(p)
    snap = export.load_snapshot(p)
    assert snap == json.loads(json.dumps(col.snapshot())) | {"meta": snap["meta"]}
    assert snap["counters"]["reqs"][0] == {"tags": {"route": "a"}, "value": 3}
    with pytest.raises(SystemExit):
        export.load_snapshot(str(tmp_path / "missing.json"))


def test_jsonl_and_prom_as_jax(tmp_path):
    p = str(tmp_path / "events.jsonl")
    export.write_jsonl(_sample(obs).events(), p)
    export.write_jsonl([{"kind": "event", "name": "later"}], p)
    evs = export.read_jsonl(p)
    assert evs[-1]["name"] == "later" and any(e["name"] == "boot" for e in evs)
    prom, jprom = str(tmp_path / "m.prom"), str(tmp_path / "j.prom")
    _sample(obs).write_prom(prom)
    _sample(jobs).write_prom(jprom)
    text = open(prom).read()
    assert text == open(jprom).read()
    assert 'repro_reqs{route="a"} 3' in text and 'repro_lat_s_count 3' in text


def test_percentile_row_lookup():
    snap = _sample(obs).snapshot()
    assert percentile_row(snap, "lat_s")["count"] == 3
    assert percentile_row(snap, "nope") is None
    assert percentile_row(snap, "reqs") is None
    assert percentile_row(snap, "lat_s", tags={"missing": "t"}) is None


def test_cli_report_and_diff(tmp_path, capsys):
    from repro_torch.obs.cli import main

    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    _sample(obs).write(a)
    _sample(obs, 10.0).write(b)
    assert main(["report", "--metrics", a, "--events", "5"]) == 0
    out = capsys.readouterr().out
    assert "obs snapshot [exp]" in out and "lat_s" in out and "WARNING hazard" in out
    assert main(["diff", a, b]) == 0
    assert "lat_s" in capsys.readouterr().out
    assert main(["report"]) == 2
    assert main(["report", "--drift"]) == 2          # the drift report needs its database
    assert "--drift needs --db" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the hot paths: dispatch, the engine
# ---------------------------------------------------------------------------

def test_runtime_resolve_records_metrics():
    from repro_torch.core.runtime import TunedRuntime

    rt = TunedRuntime(mode="kernel", name="obs-test")
    x, w = torch.zeros(32, 16), torch.zeros(16, 8)
    with obs.collect(name="t") as col:
        rt.resolve("matmul", (x, w))
        rt.resolve("matmul", (x, w))                  # cache hit
    snap = col.snapshot()
    assert {r["tags"]["cached"] for r in snap["histograms"]["dispatch.resolve_s"]} == {
        "hit", "miss"}
    calls = snap["counters"]["dispatch.calls"]
    assert all(r["tags"]["kernel"] == "matmul" for r in calls)
    assert sum(r["value"] for r in calls) == 2


@pytest.mark.parametrize("mode", ["reference", "kernel"])
def test_dispatch_runs_inside_span(mode):
    rt = repro_torch.runtime(mode=mode, name="obs-test")
    x, w = torch.ones(8, 4), torch.ones(4, 4)
    with obs.collect(name="t") as col, rt:
        with span("outer") as outer:
            repro_torch.dispatch("matmul", x, w)
    spans = [e for e in col.events(kind="span") if e["name"] == "dispatch"]
    assert len(spans) == 1
    assert spans[0]["kernel"] == "matmul" and spans[0]["phase"] == "fwd"
    assert spans[0]["parent_id"] == outer.span_id


def test_serving_engine_records_latency_histograms():
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    cfg = get_config("qwen2_0_5b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    engine = ServingEngine(cfg, RunConfig(q_chunk=32, k_chunk=64), params,
                           EngineConfig(max_batch=2, max_seq=64, max_queue=3),
                           runtime=repro_torch.runtime())
    rs = np.random.RandomState(0)
    with obs.collect(name="serve-test") as col:
        for i in range(4):
            engine.submit(Request(prompt=rs.randint(0, cfg.vocab_size, 8).astype(np.int32),
                                  max_new_tokens=4, seed=i))
        done = engine.serve()
    assert len(done) == 3
    snap = col.snapshot()
    adm = percentile_row(snap, "serve.admission_s")
    tok = percentile_row(snap, "serve.per_token_s")
    lat = percentile_row(snap, "serve.latency_s")
    assert adm["count"] == 3 and lat["count"] == 3 and tok["count"] == 3
    assert 0 < lat["p50"] <= lat["p99"]
    assert snap["counters"]["serve.requests"][0]["value"] == 3
    assert snap["counters"]["serve.tokens"][0]["value"] == sum(len(r.output) for r in done)
    assert snap["counters"]["serve.shed"][0]["tags"] == {"reason": "queue_full"}
    assert snap["histograms"]["span.serve.admit"][0]["count"] == 3
    assert snap["histograms"]["span.serve.admit.prefill"][0]["count"] == 3
    assert {"serve.queue_depth", "serve.slots_active", "serve.tokens_per_s"} <= set(
        snap["gauges"])
    # every dispatch of a prefill runs inside its admission's spans
    ev = col.events(kind="span")
    prefill_ids = {e["span_id"] for e in ev if e["name"] == "serve.admit.prefill"}
    assert any(e["name"] == "dispatch" and e["parent_id"] in prefill_ids for e in ev)


def test_trainer_records_its_step():
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.transformer import RunConfig
    from repro_torch.train import Trainer

    cfg = get_config("qwen2_0_5b").reduced()
    tr = Trainer(cfg, RunConfig(remat="none", loss_chunk=16, q_chunk=16, k_chunk=16),
                 DataConfig(batch_size=2, seq_len=16), device="cpu",
                 runtime=repro_torch.runtime())
    with obs.collect(name="train-test") as col:
        tr.run_one_step()
    snap = col.snapshot()
    assert snap["histograms"]["train.step_s"][0]["count"] == 1
    assert snap["counters"]["train.tokens"][0]["value"] == 2 * 16
    assert "train.tokens_per_s" in snap["gauges"]
    assert {"span.train.data", "span.train.step"} <= set(snap["histograms"])
    phases = {r["tags"]["phase"] for r in snap["counters"]["dispatch.calls"]}
    assert {"fwd", "bwd"} <= phases
