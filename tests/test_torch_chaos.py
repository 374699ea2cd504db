"""The port's fault plane end to end: seeded fault plans against the real
serving, dispatch, database and campaign paths, the counterparts of
``tests/test_chaos.py`` (the parts this slice ports) and of
``tests/test_serving_throughput.py``'s lock-step baseline.

* A guarded kernel-mode engine with every serving tunable faulted serves
  the tokens of the port's reference-mode engine, which are the JAX
  reference engine's, exactly.
* An unguarded engine degrades on the fault and completes every request
  with those tokens; re-armed, it serves the fault-free kernel tokens.
* Eager dispatch consults the health book at every call: a quarantined
  bucket serves the reference (or the heuristic) until its backoff lapses,
  then re-probes and heals.
* ``KernelUnavailable`` (a library that does not load, a tensor on a device
  with no kernel) and ``CudaError`` (a refused launch) raise through the
  guard and the engine; a real error of the heuristic config raises too:
  the plain path answers only injected faults and failed probes.
* A decode step faulted part way, at its second recurrent layer or at its
  unembed, leaves the pool's recurrent states as they were, so the
  degraded retry steps each state once (Mamba and xLSTM).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed.sharding import Layout  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402

import repro_torch  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.database import Record, TuningDatabase  # noqa: E402
from repro_torch.core.runtime import HealthBook, TunedRuntime  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.obs.export import format_snapshot  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig, LockStepEngine, Request, ServingEngine)
from repro_torch.testing import FaultPlan, FaultRule  # noqa: E402

RUN = RunConfig(remat="none", loss_chunk=16, q_chunk=16, k_chunk=16)
JRUN = JRun(remat="none", loss_chunk=16, q_chunk=16, k_chunk=16)
MAX_SEQ = 64
# (prompt_len, max_new, prompt_seed): tests/test_chaos.py's mixed batch
SCHEDULE = ((3, 6, 0), (9, 5, 1), (12, 4, 2))
# every tunable the reduced qwen2 serving path dispatches in kernel mode
SERVING_TUNABLES = ("matmul", "rmsnorm", "flash_attention")


def _prompt(vocab, length, seed):
    rs = np.random.RandomState(10_000 + 17 * length + seed)
    return rs.randint(0, vocab, length).astype(np.int32)


def _serve(eng, vocab, R=Request):
    for length, max_new, seed in SCHEDULE:
        assert eng.submit(R(prompt=_prompt(vocab, length, seed), max_new_tokens=max_new))
    done = eng.serve()
    assert len(done) == len(SCHEDULE), "a request was lost to a fault"
    return [r.output.tolist() for r in done]


@pytest.fixture(scope="module")
def served():
    """The reduced qwen2 with JAX's parameters; JAX's reference engine's
    tokens, the port's reference engine's and a fault-free guarded kernel
    engine's."""
    jcfg, cfg = j_get_config("qwen2_0_5b").reduced(), get_config("qwen2_0_5b").reduced()
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    j_eng = jeng.ServingEngine(jcfg, JRUN, params, make_host_mesh(), Layout(),
                               jeng.EngineConfig(max_batch=3, max_seq=MAX_SEQ),
                               runtime=repro.runtime(mode="reference"))
    j_ref = _serve(j_eng, cfg.vocab_size, jeng.Request)
    ref = _serve(_engine(cfg, tparams, TunedRuntime(mode="reference")), cfg.vocab_size)
    kern = _serve(_engine(cfg, tparams, TunedRuntime(mode="kernel")), cfg.vocab_size)
    return cfg, tparams, j_ref, ref, kern


def _engine(cfg, tparams, rt, max_batch=3):
    return ServingEngine(cfg, RUN, tparams, EngineConfig(max_batch=max_batch, max_seq=MAX_SEQ),
                         runtime=rt)


def test_reference_tokens_equal_jax(served):
    _, _, j_ref, ref, _ = served
    assert ref == j_ref


def test_guarded_engine_with_faulted_kernels_matches_reference(served, tmp_path):
    cfg, tparams, j_ref, ref, _ = served
    rt = TunedRuntime(db=TuningDatabase(None), mode="kernel", guard=True, name="chaos-kern")
    plan = FaultPlan([FaultRule(site=f"dispatch.kernel:{k}") for k in SERVING_TUNABLES],
                     seed=1, name="serving-chaos")
    col = obs.collect(name="chaos-serve")
    with col, plan:
        out = _serve(_engine(cfg, tparams, rt), cfg.vocab_size)
    assert out == ref == j_ref
    assert {s.split(":")[1] for s, _, _ in plan.fired} == set(SERVING_TUNABLES)
    assert rt.telemetry.tiers.get("reference", 0) >= len(SERVING_TUNABLES)
    health = rt.health.snapshot()
    assert len(health) >= len(SERVING_TUNABLES)
    assert {h["level"] for h in health.values()} == {"kernel"}
    warns = [e for e in col.events("warning") if e["name"] == "dispatch.quarantine"]
    assert warns and all("InjectedFault" in e["error"] for e in warns)
    snap = col.snapshot()
    assert "dispatch.quarantine" in snap["counters"]
    assert "dispatch.quarantine" in format_snapshot(snap)
    prom = str(tmp_path / "chaos.prom")
    col.write_prom(prom)
    assert "dispatch_quarantine" in open(prom).read()
    # the scoped collector took the warnings, not the process default
    keys = {w["key"] for w in warns}
    assert not [e for e in obs.current_collector().events("warning") if e["key"] in keys]


def test_unguarded_fault_degrades_engine_not_requests(served):
    cfg, tparams, j_ref, ref, kern = served
    rt = TunedRuntime(db=TuningDatabase(None), mode="kernel", guard=False,
                      name="chaos-unguarded")
    eng = _engine(cfg, tparams, rt)
    plan = FaultPlan([FaultRule(site="dispatch.kernel:*")], name="unguarded")
    col = obs.collect(name="chaos-degrade")
    with col, plan:
        out = _serve(eng, cfg.vocab_size)
    assert out == ref == j_ref
    assert eng.degraded and eng.stats["degraded_calls"] > 0
    assert len(plan.fired) == 1                 # the first dispatch; then no kernel ran
    assert any(e["name"] == "serve.degraded" for e in col.events("warning"))
    assert len(rt.health) == 0                  # unguarded: no health book entries
    eng.reset_degraded()
    assert not eng.degraded
    calls = eng.stats["degraded_calls"]
    assert _serve(eng, cfg.vocab_size) == kern   # re-armed: the kernel path again
    assert eng.stats["degraded_calls"] == calls


def test_reset_degraded_is_sticky_until_called(served):
    cfg, tparams, _, ref, _ = served
    eng = _engine(cfg, tparams, TunedRuntime(mode="kernel", guard=False))
    with FaultPlan([FaultRule(site="dispatch.kernel:rmsnorm", times=1)]):
        _serve(eng, cfg.vocab_size)
    calls = eng.stats["degraded_calls"]
    assert _serve(eng, cfg.vocab_size) == ref    # no plan: still degraded
    assert eng.stats["degraded_calls"] > calls


# ---------------------------------------------------------------------------
# the health book under eager dispatch
# ---------------------------------------------------------------------------

def _matmul_args(m=8, k=64, n=64, seed=0):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(m, k).astype(np.float32)),
            torch.from_numpy(rs.randn(k, n).astype(np.float32)))


def test_quarantine_lapses_and_reprobes():
    """Not JAX's "baked at trace time": each call consults the health book,
    so a kernel-level quarantine serves the reference only until its
    backoff lapses; the probe then runs the kernel and heals the bucket."""
    x, w = _matmul_args()
    rt = TunedRuntime(mode="kernel", name="reprobe")
    rt.health = HealthBook(base_s=3600.0)
    with rt, FaultPlan([FaultRule(site="dispatch.kernel:matmul", times=1)]) as plan:
        y0 = repro_torch.dispatch("matmul", x, w)
        y1 = repro_torch.dispatch("matmul", x, w)
        key = rt.key_for(repro_torch.core.get_tunable("matmul"), (x, w))
        assert rt.health.snapshot()[key]["level"] == "kernel"
        rt.health._entries[key].until = 0.0          # the backoff lapses
        y2 = repro_torch.dispatch("matmul", x, w)
        y3 = repro_torch.dispatch("matmul", x, w)
    assert len(plan.fired) == 1 and len(rt.health) == 0
    by_key = rt.telemetry.by_key[key]
    # faulted call + blocked call on the reference; probe + cached call on the kernel
    assert by_key == {"heuristic": 3, "reference": 2}
    for y in (y0, y1, y2, y3):
        torch.testing.assert_close(y, x @ w)


def test_record_fault_serves_the_heuristic():
    """A stored record that faults quarantines its bucket at level record:
    the heuristic config serves it, every other bucket is untouched."""
    x, w = _matmul_args()
    x2, w2 = _matmul_args(16, 64, 32, seed=1)
    db = TuningDatabase(None)
    rt = TunedRuntime(db=db, mode="kernel", name="record-fault")
    rt.health = HealthBook(base_s=3600.0)
    mm = repro_torch.core.get_tunable("matmul")
    key = rt.key_for(mm, (x, w))
    heur = mm.default_config(x, w)
    other = next(c for c in mm.space.enumerate()
                 if c != heur and mm.why_illegal(c, x, w) is None)
    db.put(Record(key=key, config=other, objective=1e-6, evaluator="wallclock",
                  evaluations=1, timestamp=0.0), save=False)
    with rt, FaultPlan([FaultRule(site="dispatch.kernel:matmul", when={"tier": "exact"},
                                  times=1)]) as plan:
        ys = [repro_torch.dispatch("matmul", x, w) for _ in range(3)]
        repro_torch.dispatch("matmul", x2, w2)
    assert plan.fired == [("dispatch.kernel:matmul", "error", 0)]
    assert rt.health.snapshot()[key]["level"] == "record"
    assert rt.telemetry.by_key[key] == {"exact": 1, "heuristic": 3}
    assert set(rt.telemetry.by_key[rt.key_for(mm, (x2, w2))]) == {"heuristic"}
    for y in ys:
        torch.testing.assert_close(y, x @ w)


def test_quarantined_attention_site_computes_what_reference_mode_does():
    """A quarantined flash bucket runs the attention site's own plain path
    (``dispatch(..., reference=)``), not ``ref.attention``: in bf16 the two
    differ in the last place, and a faulted engine must give the reference
    engine's tokens bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention as at

    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 200, 16, generator=g).bfloat16()
    k, v = (torch.randn(1, 2, 200, 16, generator=g).bfloat16() for _ in range(2))
    kw = dict(causal=True, window=0, use_kernel=True, q_chunk=64, k_chunk=64)
    with TunedRuntime(mode="reference"):
        want = at._attend(q, k, v, **kw)
    with TunedRuntime(mode="kernel") as rt, FaultPlan(
            [FaultRule(site="dispatch.kernel:flash_attention")]) as plan:
        got = [at._attend(q, k, v, **kw) for _ in range(2)]    # faulted, then blocked
    assert len(plan.fired) == 1 and rt.telemetry.tiers == {"heuristic": 1, "reference": 2}
    assert all(torch.equal(y, want) for y in got)
    assert not torch.equal(ref.attention(q, k, v, causal=True), want)


def test_nonfinite_probe_quarantines():
    x = torch.randn(8, 64)
    wt = torch.randn(64)
    rt = TunedRuntime(mode="kernel", guard_nonfinite=True, name="nan-probe")
    with obs.collect(name="nan") as col, rt, FaultPlan(
            [FaultRule(site="dispatch.kernel:rmsnorm", kind="nan", times=1)]) as plan:
        ys = [repro_torch.dispatch("rmsnorm", x, wt) for _ in range(2)]
    assert plan.count(kind="nan") == 1
    assert {h["level"] for h in rt.health.snapshot().values()} == {"kernel"}
    assert all(bool(torch.isfinite(y).all()) for y in ys)
    (warn,) = [e for e in col.events("warning") if e["name"] == "dispatch.quarantine"]
    assert "DispatchFault" in warn["error"]


# ---------------------------------------------------------------------------
# what the guard never absorbs
# ---------------------------------------------------------------------------

@pytest.fixture
def unloadable(monkeypatch, tmp_path):
    """Every CUDA library present on disk but failing to load."""
    lib = tmp_path / "libx.so"
    lib.write_bytes(b"not an ELF")
    monkeypatch.setattr(_build, "lib_path", lambda name: lib)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_entries", {})


def test_unloadable_library_raises_through_the_guard(unloadable):
    from repro_torch.core import DispatchSpec, ParamSpace, PowerOfTwoParam, Tunable
    from repro_torch.kernels import ref

    # a variant that always takes the CUDA route, as a CUDA tensor would
    probe = Tunable("unloadable_probe",
                    lambda x, w, *, block_rows: rn.rmsnorm_cuda(x, w, block_rows=block_rows),
                    ParamSpace([PowerOfTwoParam("block_rows", 1, 8)]),
                    reference=ref.rmsnorm, dispatch=DispatchSpec(reference=ref.rmsnorm))
    rt = TunedRuntime(mode="kernel", name="unloadable")
    with obs.collect(name="u") as col, rt:
        with pytest.raises(_build.KernelUnavailable, match="did not load"):
            repro_torch.dispatch(probe, torch.randn(4, 16), torch.ones(16))
    assert len(rt.health) == 0 and "reference" not in rt.telemetry.tiers
    assert not col.events("warning")


@pytest.mark.parametrize("tunable, shapes", [
    ("rmsnorm", [(8, 16), (16,)]),
    ("matmul", [(8, 16), (16, 32)]),
    ("flash_attention", [(1, 4, 16, 16), (1, 2, 16, 16), (1, 2, 16, 16)]),
])
def test_meta_tensor_raises_through_the_guard(tunable, shapes):
    """A tensor on a device with no kernel: "no kernel for device meta",
    never the plain path in its place."""
    rt = TunedRuntime(mode="kernel", platform="h100-sxm", name="meta")
    args = [torch.empty(*s, device="meta") for s in shapes]
    with rt:
        with pytest.raises(_build.KernelUnavailable, match="no kernel for device meta"):
            repro_torch.dispatch(tunable, *args)
    assert len(rt.health) == 0 and set(rt.telemetry.tiers) == {"heuristic"}


def _raising(exc):
    def fn(*a, **k):
        raise exc
    return fn


REFUSED = _build.CudaError(7, "rmsnorm: CUDA error 7 (too many resources requested for launch)")


@pytest.mark.parametrize("exc", [REFUSED, ValueError("rmsnorm: x must be contiguous")],
                         ids=["refused-launch", "wrapper-error"])
def test_real_kernel_error_is_never_served_by_the_reference(exc, monkeypatch):
    """A launch the card refused, or a wrapper's own error, from the
    heuristic config raises out of a guarded dispatch: the health book
    takes no entry and the plain path never runs in the kernel's place."""
    monkeypatch.setattr(repro_torch.core.get_tunable("rmsnorm"), "fn", _raising(exc))
    rt = TunedRuntime(mode="kernel", name="real-error")
    with obs.collect(name="real") as col, rt:
        with pytest.raises(type(exc), match="rmsnorm"):
            repro_torch.dispatch("rmsnorm", torch.randn(8, 16), torch.ones(16))
    assert len(rt.health) == 0 and set(rt.telemetry.tiers) == {"heuristic"}
    assert not col.events("warning")


def test_record_real_error_gives_way_to_the_heuristic_kernel(monkeypatch):
    """A stored record's config that raises a real error (not a refused
    launch) gives way to the heuristic kernel, never to the plain path."""
    x, w = _matmul_args()
    db = TuningDatabase(None)
    rt = TunedRuntime(db=db, mode="kernel", name="record-real")
    mm = repro_torch.core.get_tunable("matmul")
    key = rt.key_for(mm, (x, w))
    heur = mm.default_config(x, w)
    other = next(c for c in mm.space.enumerate()
                 if c != heur and mm.why_illegal(c, x, w) is None)
    db.put(Record(key=key, config=other, objective=1e-6, evaluator="wallclock",
                  evaluations=1, timestamp=0.0), save=False)
    orig = mm.fn

    def fails_off_heuristic(*a, **cfg):
        if {k: cfg[k] for k in heur} != heur:
            raise ValueError("matmul: this tile does not divide the operands")
        return orig(*a, **cfg)

    monkeypatch.setattr(mm, "fn", fails_off_heuristic)
    with rt:
        y = repro_torch.dispatch("matmul", x, w)
    assert rt.health.snapshot()[key]["level"] == "record"
    assert rt.telemetry.by_key[key] == {"exact": 1, "heuristic": 1}
    torch.testing.assert_close(y, x @ w)
    # the record raises, then the heuristic: the error, not the plain path
    monkeypatch.setattr(mm, "fn", _raising(ValueError("matmul: every tile fails")))
    rt.health = HealthBook()
    with rt, pytest.raises(ValueError, match="every tile fails"):
        repro_torch.dispatch("matmul", x, w)
    assert "reference" not in rt.telemetry.tiers


def _unloadable_rmsnorm(monkeypatch):
    """rmsnorm's variant takes the CUDA route, as a CUDA tensor would."""
    monkeypatch.setattr(repro_torch.core.get_tunable("rmsnorm"), "fn",
                        lambda x, w, *, block_rows, eps=1e-6:
                        rn.rmsnorm_cuda(x, w, block_rows=block_rows, eps=eps))


@pytest.mark.parametrize("cause", ["unloadable-library", "meta-tensors", "refused-launch"])
def test_engine_raises_what_no_guard_absorbs(cause, request, monkeypatch):
    """No kernel for this host, or a refused launch, raises out of
    ``serve()`` through both the guard and the engine: the engine is not
    degraded and serves nothing on the plain path."""
    cfg = get_config("qwen2_0_5b").reduced()
    device, platform, exc, match = "cpu", None, _build.KernelUnavailable, "did not load"
    if cause == "unloadable-library":
        request.getfixturevalue("unloadable")
        _unloadable_rmsnorm(monkeypatch)
    elif cause == "meta-tensors":
        device, platform, match = "meta", "h100-sxm", "no kernel for device meta"
    else:
        monkeypatch.setattr(repro_torch.core.get_tunable("rmsnorm"), "fn", _raising(REFUSED))
        exc, match = _build.CudaError, "too many resources"
    params = (lm.abstract_params(cfg) if device == "meta" else
              lm.init_params(cfg, seed=0, device=device))
    rt = TunedRuntime(mode="kernel", platform=platform, name=f"engine-{cause}")
    eng = ServingEngine(cfg, RUN, params, EngineConfig(max_batch=2, max_seq=MAX_SEQ),
                        runtime=rt)
    eng.submit(Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=2))
    with obs.collect(name=cause) as col:
        with pytest.raises(exc, match=match):
            eng.serve()
    assert not eng.degraded and eng.stats["degraded_calls"] == 0
    assert len(rt.health) == 0 and "reference" not in rt.telemetry.tiers
    assert not col.events("warning")


def test_serve_launcher_exits_nonzero_when_degraded(monkeypatch, capsys):
    from repro_torch.launch import serve as serve_launcher

    orig, calls = lm.decode_step, []

    def faults_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("a fault outside any dispatch site")
        return orig(*a, **k)

    monkeypatch.setattr(lm, "decode_step", faults_once)
    with pytest.raises(SystemExit) as ex:
        serve_launcher.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
                             "--requests", "2", "--new-tokens", "3"])
    assert ex.value.code == 1
    assert "DEGRADED" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the database and the campaign
# ---------------------------------------------------------------------------

def test_torn_db_load_starts_empty(tmp_path):
    path = str(tmp_path / "db.json")
    db = TuningDatabase(path)
    db.put(Record(key="matmul|torch-cpu|8x64/64x64|float32", config={"bm": 16},
                  objective=1.0, evaluator="wallclock", evaluations=1, timestamp=0.0))
    assert len(TuningDatabase(path)) == 1
    with FaultPlan([FaultRule(site="db.load:*", kind="torn")]) as plan:
        assert len(TuningDatabase(path)) == 0
    assert plan.fired == [(f"db.load:{path}", "torn", 0)]
    assert len(TuningDatabase(path)) == 1


def test_campaign_job_fault_is_retried_then_banked(tmp_path):
    from repro_torch.campaign import planner, runner, scheduler
    from repro_torch.core.evaluate import WallClockEvaluator
    from repro_torch.core.platform import TORCH_CPU

    cfg = get_config("qwen2_0_5b").reduced()
    jobs = [j for j in planner.plan_serving_jobs(cfg, 2, 32) if j.kernel == "rmsnorm"][:1]
    m = scheduler.build_manifest(jobs, 4, path=str(tmp_path / "c.json"), profile=TORCH_CPU,
                                 min_budget=2, max_budget=2)
    db = TuningDatabase(None)
    with obs.collect(name="camp") as col, FaultPlan(
            [FaultRule(site="campaign.job:*", times=1)]) as plan:
        s = runner.run_campaign(m, db, evaluator=WallClockEvaluator(repeats=1, warmup=0),
                                max_attempts=2, device="cpu")
    assert plan.fired == [("campaign.job:rmsnorm", "error", 0)]
    (job,) = m.jobs
    assert s["done"] == 1 and job.status == "done" and job.attempts == 2
    assert db.lookup(job.db_key("torch-cpu")) is not None
    snap = col.snapshot()
    assert snap["counters"]["campaign.jobs"][0] == {"tags": {"status": "done"}, "value": 1}
    assert snap["histograms"]["campaign.job_s"][0]["tags"] == {"kernel": "rmsnorm"}
    assert snap["histograms"]["span.campaign.job"][0]["count"] == 1


# ---------------------------------------------------------------------------
# the recurrent retry
# ---------------------------------------------------------------------------

def _pool(cfg, params, lengths, seed=0):
    """A decode pool whose slots hold prefilled prompts (nonzero states)."""
    pool = lm.init_cache(cfg, len(lengths), MAX_SEQ, "cpu")
    rs = np.random.RandomState(seed)
    with torch.inference_mode(), repro_torch.runtime(mode="reference"):
        for slot, n in enumerate(lengths):
            toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (1, n)).astype(np.int64))
            _, cache = lm.prefill(params, {"tokens": toks}, cfg, RUN, cache_len=MAX_SEQ)
            lm.insert_cache(pool, cache, slot)
    return pool


def _clone(pool):
    return tuple({name: {kk: t.clone() for kk, t in leaves.items()}
                  for name, leaves in seg.items()} for seg in pool)


def _recurrent_leaves(cfg, pool):
    out = {}
    for si, seg in enumerate(cfg.segments()):
        for i, spec in enumerate(seg.pattern):
            if spec.mixer != "attn":
                for kk, t in pool[si][f"l{i}"].items():
                    out[(si, i, kk)] = t
    return out


def _dispatches_before(where, cfg, params, pool, tokens, pos, monkeypatch):
    """How many dispatch sites a decode step passes before the one to fault:
    the first of its second recurrent layer, or its last (the unembed, after
    every layer has run)."""
    rule = FaultRule(site="dispatch.kernel:*", p=0.0)        # counts, never fires
    seen_at = []
    orig = tf.layer_apply

    def counting(block, x, spec, *a, **k):
        if spec.mixer != "attn":
            seen_at.append(rule.seen)
        return orig(block, x, spec, *a, **k)

    monkeypatch.setattr(tf, "layer_apply", counting)
    with torch.inference_mode(), FaultPlan([rule]), TunedRuntime(mode="kernel", guard=False):
        lm.decode_step(params, tokens, _clone(pool), pos, cfg, RUN)
    monkeypatch.setattr(tf, "layer_apply", orig)
    assert len(seen_at) >= 2 and rule.seen > seen_at[-1]
    return seen_at[1] if where == "second-recurrent-layer" else rule.seen - 1


@pytest.mark.parametrize("where", ["second-recurrent-layer", "unembed"])
@pytest.mark.parametrize("arch", ["jamba_1_5_large", "xlstm_1_3b"])
def test_degraded_decode_steps_each_state_once(arch, where, monkeypatch):
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    pool = _pool(cfg, params, [5, 7])
    tokens = torch.tensor([[3], [11]])
    pos = torch.tensor([5, 7])
    after = _dispatches_before(where, cfg, params, pool, tokens, pos, monkeypatch)

    want_pool = _clone(pool)
    with torch.inference_mode(), TunedRuntime(mode="reference"):
        want_logits, _ = lm.decode_step(params, tokens, want_pool, pos, cfg, RUN)

    eng = ServingEngine(cfg, RUN, params, EngineConfig(max_batch=2, max_seq=MAX_SEQ),
                        runtime=TunedRuntime(mode="kernel", guard=False))
    eng._caches = pool
    with obs.collect(name="retry") as col, FaultPlan(
            [FaultRule(site="dispatch.kernel:*", after=after, times=1)]) as plan:
        logits = eng._run_decode(tokens, pos)
    assert len(plan.fired) == 1 and eng.degraded and eng.stats["degraded_calls"] == 1
    assert [e["key"] for e in col.events("warning")] == ["decode"]
    np.testing.assert_allclose(logits, want_logits.float().numpy(), atol=1e-5, rtol=0)
    got, want = _recurrent_leaves(cfg, eng._caches), _recurrent_leaves(cfg, want_pool)
    assert len(got) >= 2
    for k in got:
        np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(),
                                   atol=1e-5, rtol=0, err_msg=str(k))


# ---------------------------------------------------------------------------
# the lock-step baseline
# ---------------------------------------------------------------------------

def _uniform(vocab, n, max_new):
    rs = np.random.RandomState(4)
    return [(rs.randint(0, vocab, 9).astype(np.int32), max_new) for _ in range(n)]


@pytest.mark.parametrize("spec", [((6, 4), 4), ((24, 4, 4, 4, 4, 4), 2)],
                         ids=["uniform", "skewed"])
def test_lock_step_engine_equals_jax(served, spec):
    cfg, tparams, _, _, _ = served
    max_news, batch = spec
    jcfg = j_get_config("qwen2_0_5b").reduced()
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, cfg.vocab_size, 9).astype(np.int32) for _ in max_news
               ] if len(max_news) > 2 else [
        rs.randint(0, cfg.vocab_size, 9).astype(np.int32) for _ in range(max_news[1])]
    news = list(max_news) if len(max_news) > 2 else [max_news[0]] * max_news[1]
    j_lock = jeng.LockStepEngine(jcfg, JRUN, params, make_host_mesh(), Layout(),
                                 jeng.EngineConfig(max_batch=batch, max_seq=MAX_SEQ))
    lock = LockStepEngine(cfg, RUN, tparams, EngineConfig(max_batch=batch, max_seq=MAX_SEQ))
    cont = _engine(cfg, tparams, TunedRuntime(mode="reference"), max_batch=batch)
    for eng, R in ((j_lock, jeng.Request), (lock, Request), (cont, Request)):
        for p, n in zip(prompts, news):
            eng.submit(R(prompt=p, max_new_tokens=n))
    with TunedRuntime(mode="reference"):
        done = lock.serve()
    j_done, c_done = j_lock.serve(), cont.serve()
    assert [r.output.tolist() for r in done] == [r.output.tolist() for r in j_done]
    assert [r.output.tolist() for r in done] == [r.output.tolist() for r in c_done]
    assert lock.stats == j_lock.stats
    if len(max_news) == 2:                       # uniform: one step more than the pool
        assert (cont.stats["decode_steps"], lock.stats["decode_steps"]) == (5, 6)
    else:                                        # skewed: the pool saves steps
        assert (cont.stats["decode_steps"], lock.stats["decode_steps"]) == (23, 32)
