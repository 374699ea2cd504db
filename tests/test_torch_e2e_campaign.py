"""End to end on the CPU: a campaign-tuned database serves every dispatch of
the port's training step and serving engine at the exact tier.

The port of ``tests/test_train_e2e_campaign.py`` on one device (the reduced
configs, the kernels' plain versions), training reduced qwen2_0_5b, Jamba
with its experts (``ssm_scan_bwd`` and ``expert_gemm`` in the backward
plane), Mixtral (``expert_gemm``), Gemma3-27B (local layers on a window,
GeGLU), PaliGemma-3B (heads of 256 on one kv head, the vision prefix
and its loss mask) and xLSTM-1.3B (no attention: matmul and the norm and
loss kernels), serving qwen2_0_5b, Gemma3-27B (its windowed flash keys at
prefill, ring caches that wrap) and xLSTM-1.3B (exact-length prefills, the
mixers' decode gemms on 2-D keys in the pool):

  1. plan: the train step's dispatch sites, forward and backward
     (``plan_training_jobs``), and the serving engine's buckets;
  2. run: tune every job (a tiny budget: any banked record exact-hits);
  3. export the one-platform database;
  4. a Trainer takes two steps and a ServingEngine, warmed on the database,
     serves a few staggered requests.

Every fwd and bwd dispatch must resolve at the exact tier (no TuneNow,
CoverSet, Heuristic or Reference resolution), the fused sites must dispatch
``matmul_bias_act`` (the SwiGLU gate, training) and ``rmsnorm_matmul``
(the decode final norm -> unembed), and every dispatched key must be one the
campaign planned.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core

from repro_torch.campaign import planner, runner, scheduler  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core.database import TuningDatabase  # noqa: E402
from repro_torch.core.evaluate import WallClockEvaluator  # noqa: E402
from repro_torch.core.platform import TORCH_CPU  # noqa: E402
from repro_torch.core.runtime import runtime  # noqa: E402
from repro_torch.core.search import RandomSearch  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

MAX_BATCH, MAX_SEQ = 4, 64
# The archs whose training step a campaign tunes, and the kernels each step's
# backward plane must dispatch besides the dense ones (matmul gradients reuse
# matmul, expert_gemm's reuse expert_gemm).
TRAIN_ARCHS = {"qwen2_0_5b": set(), "jamba_1_5_large": {"ssm_scan_bwd", "expert_gemm"},
               "mixtral_8x7b": {"expert_gemm"}, "gemma3_27b": set(),
               "paligemma_3b": {"flash_attention_bwd"}, "xlstm_1_3b": set()}
# The archs whose serving buckets the campaign tunes too.
SERVE_ARCHS = ("qwen2_0_5b", "gemma3_27b", "xlstm_1_3b")
ATTENTION = {"flash_attention", "flash_attention_bwd"}
_CAMPAIGNS = {}


def _campaign(arch, tmp_path_factory):
    """Plan, tune and export one arch's training step (and, for the
    SERVE_ARCHS, the serving buckets), once a module."""
    if arch not in _CAMPAIGNS:
        tmp = tmp_path_factory.mktemp(f"e2e-{arch}")
        cfg = get_config(arch).reduced()
        shape = SHAPES["train_smoke"]
        run = planner.default_run(cfg, shape)
        jobs = planner.plan_training_jobs(cfg, shape, run=run)
        if arch in SERVE_ARCHS:
            jobs += planner.plan_serving_jobs(cfg, MAX_BATCH, MAX_SEQ)
        manifest = scheduler.build_manifest(jobs, total_budget=3 * len(jobs),
                                            path=str(tmp / "campaign.json"), profile=TORCH_CPU,
                                            min_budget=2, max_budget=3)
        db = TuningDatabase(str(tmp / "tuning.json"))
        summary = runner.run_campaign(manifest, db, evaluator=WallClockEvaluator(1, 0),
                                      search_factory=lambda j: RandomSearch(budget=2),
                                      device="cpu")
        exported = runner.export_campaign_db(db, str(tmp / "torch-cpu.db.json"), "torch-cpu")
        planned = {j.db_key("torch-cpu") for j in manifest.jobs}
        _CAMPAIGNS[arch] = (cfg, shape, run, summary, TuningDatabase(exported.path), planned)
    return _CAMPAIGNS[arch]


@pytest.fixture(scope="module", params=sorted(TRAIN_ARCHS))
def campaign(request, tmp_path_factory):
    return request.param, _campaign(request.param, tmp_path_factory)


@pytest.fixture(scope="module", params=SERVE_ARCHS)
def serve_campaign(request, tmp_path_factory):
    return _campaign(request.param, tmp_path_factory)


def _only_exact(snap, phases):
    offending = {k: t for k, t in snap["by_key"].items() if set(t) - {"exact"}}
    assert not offending, f"non-exact resolutions: {offending}"
    assert set(snap["phases"]) == set(phases)
    for phase in phases:
        assert set(snap["phases"][phase]) == {"exact"}, (phase, snap["phases"][phase])


def test_campaign_banks_every_job(campaign):
    _, (_, _, _, summary, db, planned) = campaign
    assert summary["poisoned"] == 0 and summary["done"] == summary["jobs"] == len(planned)
    assert set(db.keys()) == planned


def test_tuned_training_is_all_exact_hits(campaign):
    arch, (cfg, shape, run, _, db, planned) = campaign
    rt = runtime(db=db, name="train-e2e")
    trainer = Trainer(cfg, run, DataConfig(seed=0, batch_size=shape.global_batch,
                                           seq_len=shape.seq_len),
                      adamw.AdamWConfig(total_steps=2), TrainerConfig(total_steps=2),
                      runtime=rt, device="cpu")
    losses = [m["loss"] for m in trainer.train()]
    assert np.isfinite(losses).all()
    snap = rt.telemetry.snapshot()
    _only_exact(snap, ("fwd", "bwd"))
    assert set(snap["by_key"]) <= planned
    kernels = {k.split("|")[0] for k in snap["by_key"]}
    has_attn = any(s.mixer == "attn" for seg in cfg.segments() for s in seg.pattern)
    assert {"matmul", "rmsnorm", "rmsnorm_bwd", "softmax_xent", "softmax_xent_bwd"} <= kernels
    assert kernels & ATTENTION == (ATTENTION if has_attn else set())
    fwd = {k.split("|")[0] for k in snap["by_key_phase"]["fwd"]}
    bwd = {k.split("|")[0] for k in snap["by_key_phase"]["bwd"]}
    assert TRAIN_ARCHS[arch] <= bwd and "matmul" in bwd
    # the fused SwiGLU gate (its backward plan: matmul) wherever a dense FFN is planned
    assert ("matmul_bias_act" in fwd) == any(k.startswith("matmul_bias_act|") for k in planned)
    assert snap["cache_hits"] > 0                         # the second step hit the cache


def test_warmed_engine_serves_at_the_exact_tier(serve_campaign):
    cfg, _, _, _, db, planned = serve_campaign
    params = lm.init_params(cfg, seed=0, device="cpu")
    engine = ServingEngine(cfg, RunConfig(), params,
                           EngineConfig(max_batch=MAX_BATCH, max_seq=MAX_SEQ))
    resolved = engine.warmup(db=db)
    assert engine.runtime is not None and engine.runtime.db is db
    assert set(resolved) <= planned and all(c is not None for c in resolved.values())
    rs = np.random.RandomState(0)
    specs = [s for seg in cfg.segments() for s in seg.pattern]
    attn = [s for s in specs if s.mixer == "attn"]
    # a recurrent arch prefills at the exact prompt length, and a prefill of
    # at most 8 tokens keys its own row count, which no plan's buckets
    # (16 up, in JAX's planner as in the port's) hold: its prompts are longer
    lengths = (5, 30, 12, 50, 3) if len(attn) == len(specs) else (13, 30, 12, 50, 9)
    for i, n in enumerate(lengths):
        engine.submit(Request(prompt=rs.randint(0, cfg.vocab_size, n).astype(np.int32),
                              max_new_tokens=6, temperature=0.0 if i % 2 else 0.7, seed=i,
                              arrival_time=float(2 * i)))
    done = engine.serve()
    assert [len(r.output) for r in done] == [6] * 5
    snap = engine.runtime.telemetry.snapshot()
    _only_exact(snap, ("fwd",))
    assert set(snap["by_key"]) <= planned
    kernels = {k.split("|")[0] for k in snap["by_key"]}
    assert {"rmsnorm_matmul", "matmul", "rmsnorm"} <= kernels
    assert ("flash_attention" in kernels) == bool(attn)
    # every window of the layer pattern dispatched its own flash key
    windows = {spec.window for spec in attn}
    flash = {k.rsplit("|", 1)[1] for k in snap["by_key"] if k.startswith("flash_attention|")}
    assert flash == {f"cTruew{w}" for w in windows}
