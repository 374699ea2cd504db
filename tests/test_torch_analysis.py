"""The port's static analysis (``repro_torch.analysis``): the torch lint and
its pragma grammar, the contracts over the port's registry, the database
and manifest audit against the JAX package's on the same raw JSON, and the
CLIs (``python -m repro_torch.analysis check``, ``campaign check`` and
``campaign status``'s pruned counts). Nothing is built or launched."""
import collections
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.analysis import Report, run_checks  # noqa: E402
from repro_torch.analysis.lint import default_models_dir, lint_paths, lint_source  # noqa: E402
from repro_torch.core.database import make_key  # noqa: E402

# ---------------------------------------------------------------------------
# Pass 1: the lint in torch idioms (tests/test_analysis.py's cases)
# ---------------------------------------------------------------------------

RAW = """
import torch

def f(x, w):
    return torch.einsum("ij,jk->ik", x, w)
"""

RAW_ALLOWED_SAME_LINE = """
import torch

def f(x, w):
    return torch.einsum("ij,jk->ik", x, w)  # repro: allow-raw(tiny gate matmul)
"""

RAW_ALLOWED_STATEMENT = """
import torch
import torch.nn.functional as F

# repro: allow-raw(whole function is the tunable reference body)
def f(x, w, b):
    y = x @ w
    z = F.softmax(F.linear(y, w, b), dim=-1)
    return torch.bmm(z[None], w[None])
"""

CLEAN = """
import torch
from repro_torch.core.runtime import dispatch

def f(x, w):
    return dispatch("matmul", x, w) + torch.sum(x) + x.mean()
"""

EVERY_CATEGORY = """
import torch
import torch.nn.functional as F
from torch import nn

def f(x, w, b):
    a = torch.matmul(x, w)
    c = torch.mm(x, w)
    d = torch.bmm(x, w)
    e = torch.tensordot(x, w, dims=1)
    g = F.linear(x, w, b)
    h = nn.functional.linear(x, w)
    i = torch.nn.functional.softmax(x, dim=-1)
    j = torch.softmax(x, dim=-1)
    return x @ w
"""


def _lint_str(src):
    report = Report()
    lint_source(src, "synthetic.py", report)
    return report


def test_lint_flags_raw_einsum_and_gate_bites():
    report = _lint_str(RAW)
    assert len(report.errors()) == 1
    assert "einsum" in report.errors()[0].message
    assert report.exit_code() == 1


def test_lint_flags_every_torch_category():
    report = _lint_str(EVERY_CATEGORY)
    labels = sorted(f.message.split(" not routed")[0] for f in report.errors())
    assert labels == sorted([
        "raw matmul (torch.matmul)", "raw mm (torch.mm)", "raw bmm (torch.bmm)",
        "raw tensordot (torch.tensordot)", "raw linear (F.linear)",
        "raw linear (nn.functional.linear)", "raw softmax (torch.nn.functional.softmax)",
        "raw softmax (torch.softmax)", "raw @ matmul operator"])


def test_lint_same_line_pragma_downgrades_to_info():
    report = _lint_str(RAW_ALLOWED_SAME_LINE)
    assert report.errors() == []
    infos = report.by_severity("info")
    assert len(infos) == 1 and "tiny gate matmul" in infos[0].message
    assert report.exit_code(strict=True) == 0


def test_lint_statement_pragma_covers_whole_def():
    """One own-line pragma above a def covers every raw site inside it: the
    @, the linear, the softmax and the bmm."""
    report = _lint_str(RAW_ALLOWED_STATEMENT)
    assert report.errors() == []
    assert len(report.by_severity("info")) == 4


def test_lint_pragma_does_not_leak_past_the_statement():
    src = RAW_ALLOWED_SAME_LINE + "\n\ndef g(a, b):\n    return a @ b\n"
    report = _lint_str(src)
    assert len(report.errors()) == 1


def test_lint_clean_file_has_no_findings():
    assert _lint_str(CLEAN).findings == []


def test_lint_directory_walk_and_seeded_violation(tmp_path):
    (tmp_path / "bad.py").write_text(RAW)
    (tmp_path / "good.py").write_text(CLEAN)
    report = run_checks(models_dir=str(tmp_path), passes=["lint"])
    assert report.exit_code() == 1
    assert report.stats["lint_files"] == 2
    (tmp_path / "bad.py").write_text(RAW_ALLOWED_SAME_LINE)
    report = run_checks(models_dir=str(tmp_path), passes=["lint"])
    assert report.exit_code(strict=True) == 0


def test_port_models_lint_clean_strict():
    """Every raw site of the port's models carries a pragma with its reason:
    the JAX models' sites that the port keeps, and the sLSTM's bmm."""
    report = lint_paths([default_models_dir()])
    assert report.errors() == [] and report.exit_code(strict=True) == 0
    assert default_models_dir().endswith("repro_torch/models")
    allowed = report.by_severity("info")
    assert report.stats["lint_allowed"] == len(allowed) == 17
    by_file = collections.Counter(f.location.rsplit("/", 1)[1].split(":")[0] for f in allowed)
    assert by_file == {"attention.py": 5, "moe.py": 3, "ssm.py": 9}
    assert any("torch.bmm" in f.message and "token loop" in f.message for f in allowed)


# ---------------------------------------------------------------------------
# Pass 3: contracts over the port's registry
# ---------------------------------------------------------------------------


def test_contracts_clean_and_bwd_plans_checked():
    from repro_torch.analysis.contracts import check_contracts

    report = check_contracts()
    assert report.errors() == [] and report.warnings() == []
    # matmul, rmsnorm, softmax_xent, flash_attention, matmul_bias_act,
    # rmsnorm_matmul, ssm_scan, ssm_update, expert_gemm
    assert report.stats["contracts"]["dispatch_vjp"] == 9


def test_contracts_flag_missing_reference_oracle():
    from repro_torch.analysis.contracts import check_contracts
    from repro_torch.core.annotate import scoped_registry, tunable
    from repro_torch.core.params import ParamSpace, PowerOfTwoParam

    with scoped_registry():
        tunable("zz_fake_no_oracle", ParamSpace([PowerOfTwoParam("a", 8, 16)]))(
            lambda x, *, a: x)
        locs = [f.location for f in check_contracts().errors()]
    assert "zz_fake_no_oracle" in locs
    assert "zz_fake_no_oracle" not in [f.location for f in check_contracts().errors()]


def test_contracts_check_the_backward_targets():
    """A plan that dispatches neither its _bwd sibling nor its forward, or a
    target that is not registered, is an error."""
    from repro_torch.analysis.contracts import check_contracts
    from repro_torch.core.annotate import DispatchSpec, scoped_registry, tunable
    from repro_torch.core.params import ParamSpace, PowerOfTwoParam

    def stray_bwd(ct, x, **kw):
        from repro_torch.core.runtime import dispatch

        return dispatch("zz_not_registered", ct, x)

    space = ParamSpace([PowerOfTwoParam("a", 8, 16)])
    with scoped_registry():
        tunable("zz_stray", space, reference=lambda x: x,
                dispatch=DispatchSpec(vjp="dispatch", bwd=stray_bwd))(lambda x, *, a: x)
        errs = [f.message for f in check_contracts().errors() if f.location == "zz_stray"]
    assert any("neither zz_stray_bwd nor the forward" in m for m in errs)
    assert any("unregistered tunable 'zz_not_registered'" in m for m in errs)


def test_contracts_hold_bwd_via_to_the_plan():
    """The fused tunables declare the sites their plans decompose onto, as
    the JAX package's do; a declared site the plan never dispatches is an
    error."""
    from repro.kernels import fused as jfused  # noqa: F401  (JAX's declarations)
    from repro.core.annotate import get_tunable as jget
    from repro_torch.analysis.contracts import check_contracts
    from repro_torch.core.annotate import DispatchSpec, get_tunable, scoped_registry, tunable
    from repro_torch.core.params import ParamSpace, PowerOfTwoParam

    for name in ("matmul_bias_act", "rmsnorm_matmul"):
        assert get_tunable(name).dispatch.bwd_via == jget(name).dispatch.bwd_via
    assert get_tunable("rmsnorm_matmul").dispatch.bwd_via == ("rmsnorm", "matmul",
                                                              "rmsnorm_bwd")

    def plan(ct, x, **kw):
        from repro_torch.core.runtime import dispatch

        return dispatch("matmul", ct, x)

    with scoped_registry():
        tunable("zz_via", ParamSpace([PowerOfTwoParam("a", 8, 16)]), reference=lambda x: x,
                dispatch=DispatchSpec(vjp="dispatch", bwd=plan,
                                      bwd_via=("matmul", "rmsnorm")))(lambda x, *, a: x)
        errs = [f.message for f in check_contracts().errors() if f.location == "zz_via"]
    assert len(errs) == 1 and "['rmsnorm']" in errs[0] and "drifted" in errs[0]


# ---------------------------------------------------------------------------
# db / manifest checks against the JAX package's, on the same raw JSON
# ---------------------------------------------------------------------------


def _write_db(path, records, schema=2):
    path.write_text(json.dumps({"schema": schema, "records": records}))


def _pairs(report):
    return sorted((f.pass_name, f.severity) for f in report.findings)


def _manifests(tmp_path, capacity=1024, scenarios=("mixtral/train_4k@dp16",)):
    """The same expert_gemm manifest written by each package (its platform
    the package's own)."""
    from repro.campaign.planner import TuningJob as JJob
    from repro.campaign.scheduler import CampaignManifest as JManifest
    from repro_torch.campaign.planner import TuningJob
    from repro_torch.campaign.scheduler import CampaignManifest

    out = []
    for job_cls, man_cls, plat, tag in ((JJob, JManifest, "tpu-v5e", "jax"),
                                        (TuningJob, CampaignManifest, "h100-sxm", "torch")):
        job = job_cls(kernel="expert_gemm", arg_shapes=((4, capacity, 512), (4, 512, 256)),
                      arg_dtypes=("float32", "float32"), scenarios=scenarios)
        path = str(tmp_path / f"manifest-{tag}.json")
        man_cls(path=path, platform=plat, jobs=[job]).save()
        out.append(path)
    return out


def _both(tmp_path, records, manifest=False, schema=2):
    """check_db of each package over the same records, the platform field of
    the keys rewritten to each package's profile."""
    from repro.analysis.db_check import check_db as jcheck
    from repro_torch.analysis.db_check import check_db

    jdb, tdb = tmp_path / "db-jax.json", tmp_path / "db-torch.json"
    _write_db(jdb, {k.replace("PLAT", "tpu-v5e"): v for k, v in records.items()}, schema)
    _write_db(tdb, {k.replace("PLAT", "h100-sxm"): v for k, v in records.items()}, schema)
    jm, tm = _manifests(tmp_path) if manifest else (None, None)
    return jcheck(str(jdb), manifest_path=jm), check_db(str(tdb), manifest_path=tm)


FAULTS = {
    "stale int key": {
        make_key("softmax_xent", "PLAT", ((2048, 65536), (2048,)), "int32"): {"objective": 1.0},
        make_key("softmax_xent", "PLAT", ((2048, 65536), (2048,)), "bfloat16"):
            {"objective": 1.0}},
    "invalid config": {
        make_key("matmul", "PLAT", ((512, 512), (512, 512)), "float32"):
            {"objective": 1.0, "config": {"bogus_knob": 3}}},
    "pre-residual bwd": {
        make_key("flash_attention_bwd", "PLAT", ((2, 4, 128, 16),) * 2 + ((2, 2, 128, 16),) * 2,
                 "float32", "cTruew0"): {"objective": 1.0},
        make_key("flash_attention_bwd", "PLAT", ((2, 4, 128, 16),) * 2 + ((2, 2, 128, 16),) * 2
                 + ((2, 4, 128, 16), (2, 4, 128)), "float32", "cTruew0"): {"objective": 1.0},
        make_key("rmsnorm_bwd", "PLAT", ((64, 256), (64, 256), (256,)), "float32"):
            {"objective": 1.0}},
    "capacity drift and missing bwd roster": {
        make_key("expert_gemm", "PLAT", ((4, 2048, 512), (4, 512, 256)), "float32"):
            {"objective": 1.0},
        make_key("expert_gemm", "PLAT", ((4, 1024, 512), (4, 512, 256)), "float32"):
            {"objective": 1.0}},
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_db_check_finds_what_jax_finds(tmp_path, fault):
    j, t = _both(tmp_path, FAULTS[fault], manifest=fault.startswith("capacity"))
    assert _pairs(t) == _pairs(j)
    assert t.errors() or t.warnings()
    tkeys = sorted(f.location.replace("h100-sxm", "P") for f in t.findings if f.severity != "info")
    jkeys = sorted(f.location.replace("tpu-v5e", "P") for f in j.findings if f.severity != "info")
    assert [k.split("/manifest-")[0] for k in tkeys] == [k.split("/manifest-")[0] for k in jkeys]


def test_db_check_flags_unknown_platform_and_schema(tmp_path):
    from repro_torch.analysis.db_check import check_db

    key = make_key("matmul", "rocm-mi300", ((512, 512), (512, 512)), "float32")
    db = tmp_path / "db.json"
    _write_db(db, {key: {"objective": 1.0}}, schema=1)
    msgs = " | ".join(f.message for f in check_db(str(db)).warnings())
    assert "schema 1" in msgs and "rocm-mi300" in msgs
    # the JAX package's own platform keys are foreign to the port
    _write_db(db, {key.replace("rocm-mi300", "tpu-v5e"): {"objective": 1.0}})
    assert any("tpu-v5e" in f.message for f in check_db(str(db)).warnings())


def test_db_check_flags_a_config_the_card_cannot_launch_there(tmp_path):
    """A flash backward record whose tiles fit at d = 128 (the space's
    nominal head dim) but not at its key's d = 256: a warning, where JAX's
    audit has no such check."""
    from repro_torch.analysis.db_check import check_db

    q, kv = (2, 8, 2048, 256), (2, 1, 2048, 256)
    key = make_key("flash_attention_bwd", "h100-sxm", (q, q, kv, kv, q, q[:3]), "bfloat16",
                   "cTruew0")
    db = tmp_path / "db.json"
    _write_db(db, {key: {"objective": 1.0, "config": {"block_q": 128, "block_k": 64}}})
    (w,) = check_db(str(db)).warnings()
    assert "cannot launch on h100-sxm" in w.message and "smem" in w.message
    _write_db(db, {key: {"objective": 1.0, "config": {"block_q": 64, "block_k": 64}}})
    assert check_db(str(db)).warnings() == []
    # the campaign's key reads float32 (the fp32 lse): the bf16 call it stands
    # for is judged with the manifest's dtypes, and not at all without them
    from repro_torch.campaign.planner import TuningJob
    from repro_torch.campaign.scheduler import CampaignManifest

    job = TuningJob("flash_attention_bwd", (q, q, kv, kv, q, q[:3]), ("bfloat16",) * 5
                    + ("float32",), key_extra="cTruew0")
    key32 = job.db_key("h100-sxm")
    assert key32 == key.replace("|bfloat16|", "|float32|")
    _write_db(db, {key32: {"objective": 1.0, "config": {"block_q": 128, "block_k": 64}}})
    assert check_db(str(db)).warnings() == []
    mpath = str(tmp_path / "campaign.json")
    CampaignManifest(mpath, "h100-sxm", [job]).save()
    (w,) = check_db(str(db), mpath).warnings()
    assert "cannot launch on h100-sxm" in w.message and "smem" in w.message


def test_db_check_capacity_drift_lands_in_the_event_buffer(tmp_path):
    from repro_torch import obs

    recs = FAULTS["capacity drift and missing bwd roster"]
    with obs.collect() as col:
        _, t = _both(tmp_path, recs, manifest=True)
    drifted = [k.replace("PLAT", "h100-sxm") for k in recs if "2048" in k][0]
    assert [f.location for f in t.warnings()] == [drifted]
    assert any("backward roster" in f.message for f in t.errors())
    assert any(e.get("name") == "analysis.expert_gemm_capacity" for e in col.events())


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------


def test_analysis_cli_strict_clean_on_the_port(capsys):
    from repro_torch.analysis.cli import main

    rc = main(["check", "--strict", "--passes", "lint,contracts"])
    assert rc == 0 and "0 error(s), 0 warning(s)" in capsys.readouterr().out


def test_analysis_cli_fails_on_seeded_violation(tmp_path, capsys):
    from repro_torch.analysis.cli import main

    (tmp_path / "bad.py").write_text(RAW)
    assert main(["check", "--strict", "--models-dir", str(tmp_path), "--passes", "lint"]) == 1
    out = capsys.readouterr().out
    assert "bad.py:5" in out and "not routed through a registry tunable" in out


def test_analysis_cli_json_output(tmp_path, capsys):
    from repro_torch.analysis.cli import main

    (tmp_path / "bad.py").write_text(RAW)
    rc = main(["check", "--models-dir", str(tmp_path), "--passes", "lint", "--json"])
    assert rc == 1
    blob = json.loads(capsys.readouterr().out)
    assert blob["counts"]["error"] == 1 and blob["findings"][0]["pass_name"] == "lint"


def test_analysis_cli_rejects_an_unknown_pass(capsys):
    from repro_torch.analysis.cli import main

    assert main(["check", "--passes", "lint,typo"]) == 2
    assert "typo" in capsys.readouterr().err


def test_campaign_check_cli(tmp_path, capsys):
    from repro_torch.campaign.cli import main as campaign_main

    stale = make_key("softmax_xent", "h100-sxm", ((2048, 65536), (2048,)), "int32")
    db = tmp_path / "db.json"
    _write_db(db, {stale: {"objective": 1.0}})
    _, manifest = _manifests(tmp_path, scenarios=("mixtral/train_4k",))
    rc = campaign_main(["check", "--db", str(db), "--manifest", manifest])
    assert rc == 1 and "stale integer-dtype key" in capsys.readouterr().out
    clean = tmp_path / "clean.json"
    _write_db(clean, {})
    assert campaign_main(["check", "--db", str(clean), "--manifest", manifest,
                          "--strict"]) == 0


def test_campaign_status_prints_pruned_counts(tmp_path, capsys):
    from repro_torch.campaign.cli import main as campaign_main
    from repro_torch.campaign.planner import TuningJob
    from repro_torch.campaign.scheduler import build_manifest
    from repro_torch.core.platform import H100_SXM

    job = TuningJob(kernel="ssm_scan",
                    arg_shapes=((2, 64, 256), (2, 64, 256), (2, 64, 16), (2, 64, 16),
                                (256, 16), (2, 256, 16)),
                    arg_dtypes=("bfloat16",) + ("float32",) * 5, scenarios=("jamba/train_2k",))
    path = str(tmp_path / "m.json")
    m = build_manifest([job], 24, path=path, profile=H100_SXM)
    assert m.meta["legality"] == {"ssm_scan": {"total": 270, "legal": 170, "pruned": 100,
                                               "pruned_smem": 75, "pruned_threads": 25}}
    assert campaign_main(["status", "--manifest", path]) == 0
    out = capsys.readouterr().out
    assert '"configs_pruned": 100' in out
    assert ("legality: ssm_scan: pruned 100 of 270 configs (170 legal; smem 75, threads 25) "
            "on h100-sxm") in out


def test_campaign_run_refuses_a_manifest_with_no_backward_roster(tmp_path, capsys):
    from repro_torch.campaign.cli import main as campaign_main

    _, manifest = _manifests(tmp_path)          # @dp training scenarios, no *_bwd job
    assert campaign_main(["run", "--device", "cpu", "--manifest", manifest,
                          "--db", str(tmp_path / "db.json")]) == 2
    assert "--allow-missing-bwd" in capsys.readouterr().err


def test_report_exit_code_strictness():
    r = Report()
    r.add("db", "warn", "k", "drift")
    assert r.exit_code() == 0 and r.exit_code(strict=True) == 1
    r.add("lint", "error", "f.py:1", "raw")
    assert r.exit_code() == 1
    with pytest.raises(ValueError):
        r.add("lint", "fatal", "x", "y")
