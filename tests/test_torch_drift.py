"""The port's drift detector (``repro_torch.obs.drift``), the CLIs that
print it (``python -m repro_torch.obs report --drift``, ``python -m
repro_torch.campaign drift``) and ``runtime.entry_point``. No wall-clock
ratio is gated: the replays here run an evaluator that returns fixed
seconds, so a loaded host cannot flake them."""
import json
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.database import Record, TuningDatabase, make_key, split_key  # noqa: E402
from repro_torch.core.evaluate import Evaluator, Measurement  # noqa: E402
from repro_torch.core.platform import H100_SXM, TORCH_CPU  # noqa: E402
from repro_torch.obs import drift  # noqa: E402
from repro_torch.tools.analytic import site_roofline_seconds  # noqa: E402

MM = make_key("matmul", "torch-cpu", ((64, 32), (32, 48)), "float32")
RN = make_key("rmsnorm", "torch-cpu", ((64, 32), (32,)), "float32")
MBA = make_key("matmul_bias_act", "torch-cpu", ((16, 32), (32, 64), (64,)), "float32", "asilu")
XB = make_key("softmax_xent_bwd", "torch-cpu", ((16,), (16, 64), (16,), (16,)), "float32")


def _db(tmp_path=None, extra=()):
    db = TuningDatabase(None if tmp_path is None else str(tmp_path / "db.json"))
    gemm = {"bm": 16, "bn": 64, "bk": 64, "stages": 2, "splits": 1}
    for key, cfg, obj in ((MM, gemm, 1e-4), (RN, {"block_rows": 4}, 2e-5),
                          (MBA, gemm, 5e-5), (XB, {"block_rows": 4, "block_v": 256}, 3e-5),
                          *extra):
        db.put(Record(key=key, config=cfg, objective=obj, evaluator="wallclock",
                      evaluations=4, timestamp=0.0), save=False)
    db.save()
    return db


class Fixed(Evaluator):
    """Each replay's 'time' from a table by call: the variant still runs
    (its output is returned), the seconds do not depend on the host."""

    name = "fixed"

    def __init__(self, seconds, seen=None):
        self.seconds = list(seconds)
        self.seen = seen if seen is not None else []
        self.calls = []

    def evaluate(self, fn, args, reference=None):
        out = fn(*args)
        self.seen.append(out)
        self.calls.append([(tuple(a.shape), a.dtype) for a in args])
        return Measurement(self.seconds.pop(0), True)


def test_detect_drift_flags_exactly_the_slowed_site():
    db = _db()
    live = {MM: 1.1e-4, RN: 2e-5 * 3.0, MBA: 5e-5, XB: 2.9e-5}
    entries = drift.detect_drift(db, live, threshold=1.5, profile=H100_SXM)
    assert [e.key for e in entries if e.regressed] == [RN]
    assert entries[0].key == RN and entries[0].slowdown == pytest.approx(3.0)
    assert [e.slowdown for e in entries] == sorted((e.slowdown for e in entries), reverse=True)
    e = {x.key: x for x in entries}[MM]
    shapes = split_key(MM)[2]                          # the key's shape buckets
    roof = site_roofline_seconds("matmul", shapes, "float32", H100_SXM)
    assert e.roofline_s == roof and e.pct_of_roofline == pytest.approx(100 * roof / 1.1e-4)
    assert e.pct_of_tuned_best == pytest.approx(100 / 1.1)
    # without a profile, each record's platform prices its roofline
    e2 = {x.key: x for x in drift.detect_drift(db, live)}[MM]
    assert e2.roofline_s == site_roofline_seconds("matmul", shapes, "float32", TORCH_CPU)


def test_missing_live_timings_are_left_out_and_a_failed_replay_is_infinite():
    db = _db()
    entries = drift.detect_drift(db, {MM: math.inf, RN: 2e-5}, profile=H100_SXM)
    assert [e.key for e in entries] == [MM, RN]
    assert entries[0].regressed and math.isinf(entries[0].slowdown)
    assert entries[0].pct_of_roofline == 0.0 or entries[0].pct_of_roofline < 1e-9
    assert drift.detect_drift(db, {}) == []
    assert drift.detect_drift(db, {MM: 1e-4}, platform="h100-sxm") == []


def test_format_drift_ranks_and_names_the_retune_queue():
    db = _db()
    entries = drift.detect_drift(db, {MM: 1e-4, RN: 8e-5}, profile=H100_SXM)
    text = drift.format_drift(entries)
    lines = text.splitlines()
    assert lines[0] == "campaign drift report (2 sites, regression threshold 1.50x)"
    assert RN in lines[2] and "REGRESSED" in lines[2] and "4.00x" in lines[2]
    assert f"campaign re-tune candidate: {RN}" in text and MM not in text.split("queue")[1]
    ok = drift.format_drift(drift.detect_drift(db, {MM: 1e-4}))
    assert "all sites within threshold" in ok
    assert drift.format_drift([]).startswith("drift: no measured sites")


def test_measure_sites_replays_each_record_with_its_call_kwargs():
    """The replay draws the campaign's tensors for each key and runs its
    stored config with the key extra's keyword arguments: the fused record
    runs silu, so its output equals the plain version's with silu."""
    from repro_torch.campaign import runner
    from repro_torch.kernels import ref

    db = _db()
    seen = []
    live = drift.measure_sites(db, evaluator=Fixed([1e-4, 2e-5, 5e-5, 3e-5], seen),
                               device="cpu", keys=[MBA])
    assert list(live) == [MBA] and live[MBA] == 1e-4
    job = type("J", (), {"kernel": "matmul_bias_act", "key_extra": "asilu",
                         "arg_shapes": ((16, 32), (32, 64), (64,)),
                         "arg_dtypes": ("float32",) * 3})()
    x, w, b = runner.materialize_args(job, seed=0)
    torch.testing.assert_close(seen[0], ref.matmul_bias_act(x, w, b, "silu"))


def test_measure_sites_marks_a_failed_replay_infinite():
    bad = make_key("matmul", "torch-cpu", ((8, 16), (16, 8)), "float32")
    db = _db(extra=((bad, {"bm": 3}, 1e-5),))            # no longer a config of the space
    live = drift.measure_sites(db, evaluator=Fixed([1.0] * 5), device="cpu")
    # the cross entropy's backward mixes float dtypes: no manifest, no replay
    assert math.isinf(live[bad]) and set(live) == {MM, RN, MBA, bad}
    assert drift.unreplayable(db) == [XB]
    entry = {e.key: e for e in drift.detect_drift(db, live)}[bad]
    assert entry.regressed


def test_replay_runs_the_manifests_call(tmp_path):
    """A record whose call mixes float dtypes (bf16 operands, the fp32
    inverse rms: its key reads float32) replays the manifest job's call,
    each argument's shape (12 rows, where the key keeps the bucket) and
    dtype, and its roofline is priced on that call at bf16; with no
    manifest it is left out, never replayed on the all-fp32 kernel."""
    from repro_torch.campaign.planner import TuningJob
    from repro_torch.campaign.scheduler import CampaignManifest

    shapes = ((12, 32), (12, 32), (32,), (12,))
    dtypes = ("bfloat16",) * 3 + ("float32",)
    job = TuningJob("rmsnorm_bwd", shapes, dtypes)
    key = job.db_key("torch-cpu")
    assert split_key(key)[3] == "float32" and split_key(key)[2] != shapes
    db = _db(tmp_path, extra=((key, {"block_rows": 4}, 4e-5),))
    mpath = str(tmp_path / "campaign.json")
    CampaignManifest(mpath, "torch-cpu", [job]).save()
    assert sorted(drift.unreplayable(db)) == sorted([key, XB])
    assert drift.unreplayable(db, mpath) == [XB]
    assert drift.measure_sites(db, evaluator=Fixed([]), device="cpu", keys=[key]) == {}
    ev = Fixed([8e-5])
    live = drift.measure_sites(db, evaluator=ev, device="cpu", keys=[key], manifest=mpath)
    assert live == {key: 8e-5}
    assert ev.calls == [list(zip(shapes, [torch.bfloat16] * 3 + [torch.float32]))]
    (e,) = drift.detect_drift(db, live, profile=H100_SXM, manifest=mpath)
    assert e.roofline_s == site_roofline_seconds("rmsnorm_bwd", shapes, "bfloat16", H100_SXM)
    assert e.slowdown == pytest.approx(2.0)
    (e32,) = drift.detect_drift(db, live, profile=H100_SXM)
    assert e32.roofline_s == site_roofline_seconds("rmsnorm_bwd", split_key(key)[2],
                                                   "float32", H100_SXM)
    entries = drift.drift_report(db, evaluator=Fixed([8e-5] * 4), device="cpu",
                                 profile=H100_SXM, manifest=mpath)
    assert {x.key for x in entries} == {MM, RN, MBA, key}
    assert {x.key: x for x in entries}[key].roofline_s == e.roofline_s


def test_replay_draws_a_batch_on_threads_before_timing_it(monkeypatch):
    """The host draws equal materialize_args' tensors, in the database's
    order, and no draw runs beside a timing: each batch is drawn whole,
    then timed."""
    from repro_torch.campaign import runner
    from repro_torch.kernels import ref

    rows = (8, 16, 32, 128, 256, 512)
    extra = tuple((make_key("rmsnorm", "torch-cpu", ((r, 32), (32,)), "float32"),
                   {"block_rows": 4}, 1e-5) for r in rows)
    db = _db(extra=extra)
    keys = [k for k, _, _ in extra]
    events = []
    real = runner.host_args
    monkeypatch.setattr(runner, "host_args",
                        lambda job, seed=0: events.append("draw") or real(job, seed))
    monkeypatch.setattr(drift, "_BATCH_ELEMENTS", 32 * (8 + 16 + 32) + 3 * 32)

    class Logged(Fixed):
        def evaluate(self, fn, args, reference=None):
            events.append("time")
            return super().evaluate(fn, args, reference)

    seen = []
    ev = Logged([1e-5] * len(keys), seen)
    live = drift.measure_sites(db, evaluator=ev, device="cpu", keys=keys, seed=5)
    assert list(live) == keys
    # batches of 3, 1, 1, 1 jobs by their elements
    assert "".join(e[0] for e in events) == "dddttt" + "dt" * 3
    for k, out, call in zip(keys, seen, ev.calls):
        job = type("J", (), {"kernel": "rmsnorm", "key_extra": "",
                             "arg_shapes": split_key(k)[2], "arg_dtypes": ("float32",) * 2})()
        x, w = runner.materialize_args(job, seed=5)
        assert call == [(tuple(x.shape), x.dtype), (tuple(w.shape), w.dtype)]
        torch.testing.assert_close(out[0], ref.rmsnorm(x, w))  # (y, inverse rms)


def test_obs_report_drift_with_live_timings(tmp_path, capsys):
    from repro_torch.obs.cli import main

    _db(tmp_path)
    live = tmp_path / "live.json"
    live.write_text(json.dumps({MM: 1e-4, RN: 1e-4}))
    out_json = tmp_path / "drift.json"
    rc = main(["report", "--drift", "--db", str(tmp_path / "db.json"), "--live", str(live),
               "--json-out", str(out_json)])
    out = capsys.readouterr().out
    assert rc == 0 and "campaign drift report (2 sites" in out and "REGRESSED" in out
    blob = json.loads(out_json.read_text())
    assert blob["threshold"] == 1.5 and [e["key"] for e in blob["entries"]] == [RN, MM]
    assert main(["report", "--drift", "--db", str(tmp_path / "db.json"), "--live", str(live),
                 "--fail-on-drift"]) == 1


def test_campaign_drift_replays_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``campaign drift --device cpu``: each record replayed through the
    evaluator (fixed seconds here), attributed and ranked; --fail-on-drift
    exits 1 on the one slowed site."""
    from repro_torch.campaign.cli import main
    from repro_torch.core import evaluate

    _db(tmp_path)
    # by key order: MBA, MM, RN (XB, a mixed-dtype call, needs the
    # manifest); rmsnorm's replay reads 5x its record
    monkeypatch.setattr(evaluate, "WallClockEvaluator", lambda **kw: Fixed([5e-5, 1e-4, 1e-4]))
    db_path = str(tmp_path / "db.json")
    rc = main(["drift", "--device", "cpu", "--db", db_path, "--json-out",
               str(tmp_path / "d.json")])
    out = capsys.readouterr().out
    assert rc == 0 and "campaign drift report (3 sites" in out
    assert "1 record(s) left out" in out and XB in out.split("left out")[1]
    entries = json.loads((tmp_path / "d.json").read_text())
    assert [e["key"] for e in entries if e["regressed"]] == [RN]
    monkeypatch.setattr(evaluate, "WallClockEvaluator", lambda **kw: Fixed([5e-5, 1e-4, 1e-4]))
    assert main(["drift", "--device", "cpu", "--db", db_path, "--fail-on-drift"]) == 1
    capsys.readouterr()
    # with the manifest the cross entropy's backward replays too
    from repro_torch.campaign.planner import TuningJob
    from repro_torch.campaign.scheduler import CampaignManifest

    xjob = TuningJob("softmax_xent_bwd", split_key(XB)[2],
                     ("float32", "float32", "int32", "float32"))
    assert xjob.db_key("torch-cpu") == XB
    mpath = str(tmp_path / "campaign.json")
    CampaignManifest(mpath, "torch-cpu", [xjob]).save()
    monkeypatch.setattr(evaluate, "WallClockEvaluator",
                        lambda **kw: Fixed([5e-5, 1e-4, 2e-5, 3e-5]))
    assert main(["drift", "--device", "cpu", "--db", db_path, "--manifest", mpath]) == 0
    out = capsys.readouterr().out
    assert "campaign drift report (4 sites" in out and "left out" not in out


def test_campaign_drift_needs_a_card_unless_told_the_cpu(tmp_path):
    from repro_torch.campaign.cli import main

    _db(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["drift", "--db", str(tmp_path / "db.json")])


def test_entry_point_dispatches_through_the_active_runtime():
    from repro_torch.core import entry_point
    from repro_torch.core.runtime import runtime
    from repro_torch.kernels import ref

    rmsnorm = entry_point("rmsnorm")
    assert rmsnorm.__name__ == "rmsnorm" and "rmsnorm" in rmsnorm.__doc__
    x = torch.randn(8, 32, generator=torch.Generator().manual_seed(0))
    w = torch.ones(32)
    with runtime(mode="kernel", db=TuningDatabase(None), name="a") as a:
        y = rmsnorm(x, w)
    with runtime(mode="reference", name="b") as b:
        yr = rmsnorm(x, w)
    assert a.telemetry.snapshot()["calls"] == 1 and b.telemetry.snapshot()["calls"] == 1
    torch.testing.assert_close(y, ref.rmsnorm(x, w))
    torch.testing.assert_close(yr, ref.rmsnorm(x, w))
    cfg = {"block_rows": 2}
    with runtime(mode="kernel", db=TuningDatabase(None), name="c") as c:
        rmsnorm(x, w, config=cfg)
    assert c.telemetry.snapshot()["tiers"] == {"override": 1}
