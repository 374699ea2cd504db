"""The port's campaign against the JAX package's, on the CPU.

* Planner parity: ``plan_serving_jobs`` and the one-device
  ``plan_training_jobs`` (and the shape-level ``plan_train_jobs``) for the
  reduced and the full-width ``qwen2_0_5b``, Mixtral-8x7B and xLSTM-1.3B
  give the JAX planner's jobs -- kernel, shapes, dtypes, key extra, weight
  and scenarios -- over the kernels the port registers.
* Dedupe, priorities (on one hardware profile) and budget allocation equal
  the JAX scheduler's; transfer seeds and cover sets equal its transfer
  layer's.
* ``materialize_args`` gives the JAX runner's tensors: primals bit for bit
  (bf16 included; the selective scan's dt and A drawn in their ranges),
  residuals within f32 tolerance (1e-5 relative: the same fp32 reductions
  in another order).
* The manifest resumes, and the CLI plans, runs, reports and exports.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.campaign import planner as jplanner  # noqa: E402
from repro.campaign import runner as jrunner  # noqa: E402
from repro.campaign import scheduler as jsched  # noqa: E402
from repro.campaign import transfer as jtransfer  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.core.database import Record as JRecord  # noqa: E402
from repro.core.database import TuningDatabase as JDB  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro_torch.campaign import cli, planner, runner, scheduler, transfer  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core.database import Record, TuningDatabase  # noqa: E402
from repro_torch.core.evaluate import WallClockEvaluator  # noqa: E402
from repro_torch.core.platform import H100_SXM, TORCH_CPU  # noqa: E402
from repro_torch.core.search import RandomSearch  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.tools import analytic  # noqa: E402

KERNELS = planner.DEFAULT_KERNELS
FIELDS = ("kernel", "arg_shapes", "arg_dtypes", "key_extra", "weight", "scenarios")


def _rows(jobs):
    return [tuple(getattr(j, f) for f in FIELDS) for j in jobs]


def _windowed(jobs, window):
    """JAX's jobs with serving's prefill flash jobs keyed at ``window``: the
    port plans them at each window of the layer pattern, where the JAX
    planner plans ``cTruew0`` alone."""
    return [dataclasses.replace(j, key_extra=f"cTruew{window}")
            if j.kernel == "flash_attention" and any("serve_prefill" in x for x in j.scenarios)
            else j for j in jobs]


def _cfgs(reduced):
    j, t = jconfigs.get_config("qwen2_0_5b"), get_config("qwen2_0_5b")
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def _shape(reduced):
    s = SHAPES["train_smoke" if reduced else "train_2k"]
    return s, jconfigs.ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("max_tokens", [4096, 8192])
def test_training_plan_equals_jax(reduced, max_tokens):
    jcfg, tcfg = _cfgs(reduced)
    tshape, jshape = _shape(reduced)
    chunk = 32 if reduced else 512
    t = planner.plan_training_jobs(tcfg, tshape, run=RunConfig(remat="none", loss_chunk=chunk),
                                   max_tokens=max_tokens)
    j = jplanner.plan_training_jobs(jcfg, jshape, run=JRun(remat="none", loss_chunk=chunk,
                                                           microbatches=1),
                                    kernels=KERNELS, max_tokens=max_tokens)
    assert _rows(t) == _rows(j) and t
    assert all(s.endswith("@dp1") for job in t for s in job.scenarios)
    if not reduced and max_tokens == 8192:
        mba = [x for x in t if x.kernel == "matmul_bias_act"]
        assert [(x.arg_shapes, x.key_extra) for x in mba] == [
            (((8192, 896), (896, 4864), (4864,)), "asilu")]


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_shape_level_plan_equals_jax(reduced):
    jcfg, tcfg = _cfgs(reduced)
    tshape, jshape = _shape(reduced)
    t = planner.plan_train_jobs(tcfg, tshape, max_tokens=8192)
    j = jplanner.plan_train_jobs(jcfg, jshape, kernels=KERNELS, max_tokens=8192)
    assert _rows(t) == _rows(j) and t


@pytest.mark.parametrize("reduced,serving", [(True, (2, 32)), (True, (8, 128)),
                                             (False, (8, 2048))],
                         ids=["reduced-2x32", "reduced-8x128", "full-8x2048"])
@pytest.mark.parametrize("max_tokens", [4096, 8192])
def test_serving_plan_equals_jax(reduced, serving, max_tokens):
    jcfg, tcfg = _cfgs(reduced)
    t = planner.plan_serving_jobs(tcfg, *serving, max_tokens=max_tokens)
    j = jplanner.plan_serving_jobs(jcfg, *serving, kernels=KERNELS, max_tokens=max_tokens)
    assert _rows(t) == _rows(j) and t
    assert planner.serving_buckets(*serving) == jplanner.serving_buckets(*serving)


def _full_plan():
    jcfg, tcfg = _cfgs(False)
    tshape, jshape = _shape(False)
    t = (planner.plan_training_jobs(tcfg, tshape, run=RunConfig(loss_chunk=512))
         + planner.plan_serving_jobs(tcfg, 8, 2048))
    j = (jplanner.plan_training_jobs(jcfg, jshape, run=JRun(remat="none", loss_chunk=512,
                                                            microbatches=1),
                                     kernels=KERNELS, max_tokens=8192)
         + jplanner.plan_serving_jobs(jcfg, 8, 2048, kernels=KERNELS, max_tokens=8192))
    return t, j


def test_full_width_plan_has_one_job_per_fused_site():
    t, _ = _full_plan()
    d = scheduler.dedupe_jobs(t, "h100-sxm")
    assert len(d) == 81
    # every default kernel but the selective scan's four and the expert gemm, which
    # qwen2_0_5b has no site for; attn_chunks at the 8 prefill buckets (the decode
    # lookup, 8 x 2048 rows, is over max_tokens)
    assert {j.kernel for j in d} == set(KERNELS) - {"ssm_scan", "ssm_update", "ssm_scan_bwd",
                                                    "ssm_update_bwd", "expert_gemm"}
    assert sum(j.kernel == "attn_chunks" for j in d) == 8
    (rmm,) = [j for j in d if j.kernel == "rmsnorm_matmul"]
    assert rmm.arg_shapes == ((8, 896), (896,), (896, 151936))


def test_dedupe_priorities_and_budgets_equal_jax():
    t, j = _full_plan()
    td, jd = scheduler.dedupe_jobs(t, "h100-sxm"), jsched.dedupe_jobs(j, "h100-sxm")
    assert _rows(td) == _rows(jd)
    # the JAX scheduler reads only the profile's two peaks: give both the H100's
    tp, jp = scheduler.prioritize_jobs(td, H100_SXM), jsched.prioritize_jobs(jd, H100_SXM)
    assert _rows(tp) == _rows(jp)
    np.testing.assert_allclose([x.priority for x in tp], [x.priority for x in jp], rtol=1e-12)
    for total, lo, hi in ((200, 2, 8), (100, 2, 8), (1000, 6, 128)):
        tb = scheduler.allocate_budget([dataclasses.replace(x) for x in tp], total, lo, hi)
        jb = jsched.allocate_budget([dataclasses.replace(x) for x in jp], total, lo, hi)
        assert [x.budget for x in tb] == [x.budget for x in jb]


@pytest.mark.parametrize("arch", ["jamba_1_5_large", "mixtral_8x7b"])
def test_hybrid_and_moe_priorities_equal_jax(arch):
    """The scheduler prices the selective scan's, its backward's, the update's
    and the expert gemm's sites as the JAX package's analytic model does
    (serving's prefill flash jobs keyed at the arch's window)."""
    jcfg, tcfg = jconfigs.get_config(arch), get_config(arch)
    tshape, jshape = _shape(False)
    t = (planner.plan_training_jobs(tcfg, tshape, run=RunConfig(loss_chunk=512))
         + planner.plan_serving_jobs(tcfg, 8, 2048))
    j = (jplanner.plan_training_jobs(jcfg, jshape, run=JRun(remat="none", loss_chunk=512,
                                                            microbatches=1),
                                     kernels=KERNELS, max_tokens=8192)
         + jplanner.plan_serving_jobs(jcfg, 8, 2048, kernels=KERNELS, max_tokens=8192))
    j = _windowed(j, tcfg.window)
    td, jd = scheduler.dedupe_jobs(t, "h100-sxm"), jsched.dedupe_jobs(j, "h100-sxm")
    tp = scheduler.prioritize_jobs(td, H100_SXM)
    # The port prices a float32 gemm site (gemm.cuh's simt route) at the card's
    # fp32 peak, where JAX prices every site at the bf16 peak: those jobs are
    # held against JAX's priority with the fp32 peak in the bf16 peak's place.
    jp = {tuple(getattr(x, f) for f in FIELDS): x.priority
          for x in jsched.prioritize_jobs(jd, H100_SXM)}
    jf = {tuple(getattr(x, f) for f in FIELDS): x.priority for x in jsched.prioritize_jobs(
        jd, dataclasses.replace(H100_SXM, peak_flops_bf16=H100_SXM.peak_flops_fp32))}
    jrows = _rows(jsched.prioritize_jobs(jd, H100_SXM))
    simt = [x.kernel in analytic.SIMT_GEMMS and x.arg_dtypes[0] == "float32" for x in tp]
    want = {r: (jf if s else jp)[r] for r, s in zip(_rows(tp), simt)}
    assert sorted(_rows(tp)) == sorted(jrows)
    np.testing.assert_allclose([x.priority for x in tp], [want[r] for r in _rows(tp)],
                               rtol=1e-12)
    if any(simt):
        # JAX's rows in the order of the expected priorities, with
        # prioritize_jobs' own tie-break (kernel, shapes, key extra)
        assert _rows(tp) == sorted(jrows, key=lambda r: (-want[r], r[0], r[1], r[3]))
    else:
        assert _rows(tp) == jrows
    assert {"expert_gemm"} <= {x.kernel for x in tp}
    assert any(simt) == (arch == "jamba_1_5_large")


def test_transfer_equals_jax():
    recs = [("matmul|torch-cpu|64x128/128x64|float32", {"bm": 16, "bn": 32, "bk": 16}, 2.0),
            ("matmul|torch-cpu|256x128/128x64|float32", {"bm": 64, "bn": 64, "bk": 64}, 1.0),
            ("matmul|torch-cpu|256x128/128x64|bfloat16", {"bm": 32, "bn": 64, "bk": 64}, 1.0),
            ("matmul|h100-sxm|128x128/128x64|float32", {"bm": 128, "bn": 64, "bk": 32}, 1.0),
            ("rmsnorm|torch-cpu|64x128/128|float32", {"block_rows": 4}, 1.0)]
    tdb, jdb = TuningDatabase(None), JDB(None)
    for k, c, o in recs:
        tdb.put(Record(k, c, o, "w", 1, 0.0), save=False)
        jdb.put(JRecord(k, c, o, "w", 1, 0.0), save=False)
    args = (((128, 128), (128, 64)), "float32")
    assert (transfer.warm_start_configs(tdb, "matmul", "torch-cpu", *args, k=5)
            == jtransfer.warm_start_configs(jdb, "matmul", "torch-cpu", *args, k=5))
    assert transfer.cluster_winners(tdb.records()) == jtransfer.cluster_winners(jdb.records())
    assert (transfer.compute_covers(tdb, "torch-cpu", save=False)
            == jtransfer.compute_covers(jdb, "torch-cpu", save=False))


def _job(kernel, shapes, dtypes, extra=""):
    return planner.TuningJob(kernel, tuple(map(tuple, shapes)), tuple(dtypes), extra)


MATERIALIZE = [
    _job("matmul", [(33, 64), (64, 40)], ["bfloat16"] * 2),
    _job("matmul", [(8, 16), (16, 24)], ["float32"] * 2),
    _job("softmax_xent", [(6, 300), (6,)], ["bfloat16", "int32"]),
    _job("softmax_xent_bwd", [(6,), (6, 300), (6,), (6,)],
         ["float32", "bfloat16", "int32", "float32"]),
    _job("rmsnorm_bwd", [(9, 48), (9, 48), (48,), (9,)], ["bfloat16"] * 3 + ["float32"]),
    _job("flash_attention_bwd", [(1, 4, 24, 16), (1, 4, 24, 16), (1, 2, 24, 16),
                                 (1, 2, 24, 16), (1, 4, 24, 16), (1, 4, 24)],
         ["float32"] * 5 + ["float32"], "cTruew0"),
    _job("matmul_bias_act", [(12, 32), (32, 48), (48,)], ["bfloat16"] * 3, "asilu"),
    _job("attn_chunks", [(1, 4, 24, 16), (1, 2, 24, 16), (1, 2, 24, 16)], ["bfloat16"] * 3),
    # the selective scan's jobs draw dt > 0 and A < 0 at their own indices
    _job("ssm_scan", [(1, 64, 32), (1, 64, 32), (1, 64, 16), (1, 64, 16), (32, 16),
                      (1, 32, 16)], ["bfloat16"] + ["float32"] * 5),
    _job("ssm_update", [(3, 32), (3, 32), (3, 16), (3, 16), (32, 16), (3, 32, 16)],
         ["float32"] * 6),
    _job("ssm_scan_bwd", [(1, 64, 32), (1, 32, 16), (1, 64, 32), (1, 64, 32), (1, 64, 16),
                          (1, 64, 16), (32, 16), (1, 32, 16)],
         ["float32", "float32", "bfloat16"] + ["float32"] * 5),
    _job("ssm_update_bwd", [(3, 32), (3, 32, 16), (3, 32), (3, 32), (3, 16), (3, 16),
                            (32, 16), (3, 32, 16)], ["float32"] * 8),
]
RESIDUAL = {"rmsnorm_bwd": (3,), "softmax_xent_bwd": (3,), "flash_attention_bwd": (4, 5)}


@pytest.mark.parametrize("job", MATERIALIZE, ids=lambda j: f"{j.kernel}-{j.arg_dtypes[0]}")
def test_materialize_args_equal_jax(job):
    t = runner.materialize_args(job, seed=3)
    j = jrunner.materialize_args(job, seed=3)
    assert len(t) == len(j)
    for i, (a, b) in enumerate(zip(t, j)):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == str(b.dtype) and tuple(a.shape) == b.shape
        if i in RESIDUAL.get(job.kernel, ()):
            np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32), rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
        elif a.dtype == torch.bfloat16:
            assert np.array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            assert np.array_equal(a.numpy(), b)


def test_bf16_draws_round_like_jax_at_ties():
    """A float64 draw that sits just above a bf16 tie: JAX narrows to
    float32 first (the tie) and rounds it to even; the port matches it."""
    t = np.array([1 + 2 ** -8 + 2 ** -30, -(1 + 2 ** -8 + 2 ** -30), 3 + 3 * 2 ** -7 + 2 ** -29,
                  0.1, -7.3e-5])
    a = runner._float_tensor(t, "bfloat16", "cpu")
    b = np.asarray(jnp.asarray(t, jnp.bfloat16))
    assert np.array_equal(a.view(torch.int16).numpy(), b.view(np.int16))


def test_call_kwargs_from_key_extra():
    assert runner.call_kwargs(_job("matmul_bias_act", [], [], "agelu")) == {"act": "gelu"}
    assert runner.call_kwargs(_job("flash_attention", [], [], "cTruew24")) == {
        "causal": True, "window": 24}
    assert runner.call_kwargs(_job("matmul", [], [])) == {}


def _small_manifest(tmp_path, budget=60):
    cfg = get_config("qwen2_0_5b").reduced()
    jobs = planner.plan_serving_jobs(cfg, 2, 32)
    return scheduler.build_manifest(jobs, budget, path=str(tmp_path / "c.json"),
                                    profile=TORCH_CPU, min_budget=2, max_budget=3)


def test_manifest_resumes_and_poisons(tmp_path):
    m = _small_manifest(tmp_path)
    n = len(m.jobs)
    db = TuningDatabase(str(tmp_path / "db.json"))
    ev = WallClockEvaluator(repeats=1, warmup=0)
    s1 = runner.run_campaign(m, db, evaluator=ev, max_jobs=3, device="cpu")
    assert s1["done"] == 3 and s1["pending"] == n - 3
    loaded = scheduler.CampaignManifest.load(str(tmp_path / "c.json"))
    assert loaded.counts()["done"] == 3
    before = {j.db_key("torch-cpu"): j.evaluations for j in loaded.jobs if j.status == "done"}

    class Broken(RandomSearch):
        def run(self, *a, **k):
            raise ValueError("no search for attention today")

    def factory(job):
        return (Broken if job.kernel == "flash_attention" else RandomSearch)(budget=job.budget)

    s2 = runner.run_campaign(loaded, db, evaluator=ev, search_factory=factory, device="cpu")
    assert s2["pending"] == 0 and s2["poisoned"] == sum(j.kernel == "flash_attention"
                                                        for j in loaded.jobs)
    assert s2["done"] + s2["poisoned"] == n
    for j in loaded.jobs:
        if j.db_key("torch-cpu") in before:
            assert j.evaluations == before[j.db_key("torch-cpu")]    # not re-run
        if j.status == "poisoned":
            assert "no search for attention" in j.error
        else:
            assert db.lookup(j.db_key("torch-cpu")) is not None
    again = runner.run_campaign(scheduler.CampaignManifest.load(str(tmp_path / "c.json")), db,
                                evaluator=ev, device="cpu")
    assert again["poisoned"] == s2["poisoned"]               # a resume skips poisoned jobs
    assert loaded.meta["telemetry"]["calls"] >= 0


def test_interrupt_keeps_the_job_in_flight_pending(tmp_path):
    m = _small_manifest(tmp_path)
    calls = []

    def factory(job):
        calls.append(job.kernel)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return RandomSearch(budget=job.budget)

    with pytest.raises(KeyboardInterrupt):
        runner.run_campaign(m, TuningDatabase(None), evaluator=WallClockEvaluator(1, 0),
                            search_factory=factory, device="cpu")
    loaded = scheduler.CampaignManifest.load(str(tmp_path / "c.json"))
    assert loaded.counts()["done"] == 1 and "interrupted" in loaded.meta
    second = loaded.pending()[0]
    assert second.status == "pending" and second.attempts == 1


def test_cli_plans_runs_reports_and_exports(tmp_path, capsys):
    c, db, out = (str(tmp_path / n) for n in ("c.json", "db.json", "cpu.db.json"))
    assert cli.main(["plan", "--device", "cpu", "--reduced", "--train-shapes", "train_smoke",
                     "--serving", "2x32", "--budget", "120", "--min-budget", "2",
                     "--out", c]) == 0
    text = capsys.readouterr().out
    assert "unique keys on torch-cpu" in text and "matmul_bias_act" in text
    m = scheduler.CampaignManifest.load(c)
    assert m.platform == "torch-cpu" and all(j.budget >= 2 for j in m.jobs)
    assert cli.main(["run", "--device", "cpu", "--manifest", c, "--db", db, "--repeats", "1",
                     "--max-jobs", "4"]) == 0
    assert json.loads(capsys.readouterr().out)["done"] == 4
    assert cli.main(["status", "--manifest", c]) == 0
    status = capsys.readouterr().out
    assert '"done": 4' in status and "[    done]" in status and "[ pending]" in status
    assert cli.main(["export", "--device", "cpu", "--db", db, "--out", out]) == 0
    assert "exported 4 records" in capsys.readouterr().out
    assert len(TuningDatabase(out)) == 4


def test_cli_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["plan", "--reduced", "--out", str(tmp_path / "c.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_campaign(_small_manifest(tmp_path), TuningDatabase(None))


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("max_tokens", [4096, 8192])
def test_mixtral_plans_equal_jax(reduced, max_tokens):
    """Training (with the expert gemms' transposed gradients), shape-level
    and serving plans of Mixtral-8x7B equal the JAX planner's, serving's
    prefill flash jobs keyed at Mixtral's window."""
    jcfg, tcfg = jconfigs.get_config("mixtral_8x7b"), get_config("mixtral_8x7b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    tshape, jshape = _shape(reduced)
    chunk = 32 if reduced else 512
    serving = (2, 32) if reduced else (8, 8192)
    t = (planner.plan_training_jobs(tcfg, tshape, run=RunConfig(loss_chunk=chunk),
                                    max_tokens=max_tokens)
         + planner.plan_train_jobs(tcfg, tshape, max_tokens=max_tokens)
         + planner.plan_serving_jobs(tcfg, *serving, max_tokens=max_tokens))
    j = (jplanner.plan_training_jobs(jcfg, jshape, run=JRun(remat="none", loss_chunk=chunk,
                                                            microbatches=1),
                                     kernels=KERNELS, max_tokens=max_tokens)
         + jplanner.plan_train_jobs(jcfg, jshape, kernels=KERNELS, max_tokens=max_tokens)
         + jplanner.plan_serving_jobs(jcfg, *serving, kernels=KERNELS, max_tokens=max_tokens))
    assert _rows(t) == _rows(_windowed(j, tcfg.window))
    egemm = [x.arg_shapes for x in t if x.kernel == "expert_gemm"]
    if not reduced:
        # the step's 8192 tokens: capacity 2560, forward and both gradients
        assert egemm[:3] == [((8, 2560, 4096), (8, 4096, 14336)),
                             ((8, 2560, 14336), (8, 14336, 4096)),
                             ((8, 4096, 2560), (8, 2560, 14336))]
        assert ((8, 640, 4096), (8, 4096, 14336)) in egemm          # prefill bucket 2048
        assert ((8, 2, 14336), (8, 14336, 4096)) in egemm           # the 8-slot pool


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("max_tokens", [4096, 8192])
def test_xlstm_plans_equal_jax(reduced, max_tokens):
    """Training (every mLSTM and sLSTM gemm with its two transposed-operand
    gradients, the mLSTM's out_proj in fp32), shape-level and serving plans
    of xLSTM-1.3B equal the JAX planner's: all matmul and norm jobs, no
    attention site."""
    jcfg, tcfg = jconfigs.get_config("xlstm_1_3b"), get_config("xlstm_1_3b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    tshape, jshape = _shape(reduced)
    chunk = 32 if reduced else 512
    serving = (2, 32) if reduced else (8, 2048)
    t = (planner.plan_training_jobs(tcfg, tshape, run=RunConfig(loss_chunk=chunk),
                                    max_tokens=max_tokens)
         + planner.plan_train_jobs(tcfg, tshape, max_tokens=max_tokens)
         + planner.plan_serving_jobs(tcfg, *serving, max_tokens=max_tokens))
    j = (jplanner.plan_training_jobs(jcfg, jshape, run=JRun(remat="none", loss_chunk=chunk,
                                                            microbatches=1),
                                     kernels=KERNELS, max_tokens=max_tokens)
         + jplanner.plan_train_jobs(jcfg, jshape, kernels=KERNELS, max_tokens=max_tokens)
         + jplanner.plan_serving_jobs(jcfg, *serving, kernels=KERNELS, max_tokens=max_tokens))
    assert _rows(t) == _rows(j) and t
    assert {x.kernel for x in t} == {"matmul", "rmsnorm", "rmsnorm_bwd", "softmax_xent",
                                     "softmax_xent_bwd", "rmsnorm_matmul"}
    if not reduced and max_tokens == 8192:
        T = 8192
        step = [x for x in t if x.kernel == "matmul" and x.scenarios[0].endswith("@dp1")]
        weight = lambda shapes, dt="bfloat16": sum(x.weight for x in step if x.arg_shapes ==
                                                   shapes and x.arg_dtypes[0] == dt)
        # the sLSTM's MLP at n = 2752 (up_g and up_u forward, down's dL/dx)
        # and k = 2752 (down forward, up_g and up_u's dL/dx), and the
        # mLSTM's fp32 out_proj
        assert weight(((T, 2048), (2048, 2752))) == 48 + 24
        assert weight(((T, 2752), (2752, 2048))) == 24 + 48
        assert weight(((T, 4096), (4096, 2048)), "float32") == 24
        decode = [x for x in t if x.scenarios[0].endswith("serve_decode_b8s16")]
        assert ((8, 2048), (2048, 2752)) in [x.arg_shapes for x in decode]
