"""Launch models (``repro_torch.core.gridmodel``) and the legality they
decide: each check category on hand-built models, the shipped spaces on
both H100 profiles, the legal sets pinned from before the models held the
limits (the spaces' constraints and the flash ``legal`` hooks gave exactly
these), the tuner's static pre-pass and the manifest's legality stamp.
Nothing is built or launched."""
import hashlib
import itertools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import kernels  # noqa: E402,F401
from repro_torch.analysis.legality import PHASE_SHAPES  # noqa: E402
from repro_torch.core import gridmodel as gm  # noqa: E402
from repro_torch.core.annotate import get_tunable  # noqa: E402
from repro_torch.core.params import ParamSpace  # noqa: E402
from repro_torch.core.platform import H100_PCIE, H100_SXM, TORCH_CPU  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import fused as fu  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

# ---------------------------------------------------------------------------
# each check category on hand-built models
# ---------------------------------------------------------------------------


def _model(grid=(4, 2), tile=(32, 64), dims=(128, 128), index=lambda i, j: (i, j),
           reduce=(), axes=("m", "n"), **kw):
    out = gm.OutputModel("c", dims, tile, index, reduce=reduce)
    cuda = tuple(grid) + (1,) * (3 - len(grid))
    return gm.LaunchModel("toy", route="tc", grid=grid, axes=axes, cuda_grid=cuda,
                          outputs=(out,), **{"threads": 128, **kw})


def _cats(model, profile=H100_SXM):
    return [c for c, _ in gm.check_model(model, profile)]


def test_a_clean_model_passes_every_check():
    assert _cats(_model()) == []


def test_race_two_blocks_one_tile_without_a_declared_reduction():
    # the n axis does not move the tile: its two blocks write the same one
    racy = _model(index=lambda i, j: (i, 0), tile=(32, 128))
    (cat,) = _cats(racy)
    assert cat == "race"
    assert "'n'" in gm.check_races(racy)


def test_split_k_partials_are_a_declared_reduction_not_a_race():
    split = _model(grid=(4, 2, 8), axes=("m", "n", "split"), reduce=("split",),
                   index=lambda i, j, s: (i, j))
    assert _cats(split) == []
    undeclared = _model(grid=(4, 2, 8), axes=("m", "n", "split"),
                        index=lambda i, j, s: (i, j))
    assert _cats(undeclared) == ["race"]


def test_race_where_two_axes_move_one_dim():
    # blocks (i, j) write tile i + j: the exact enumeration finds (0, 1) and (1, 0)
    model = _model(dims=(160, 64), tile=(32, 64), index=lambda i, j: (i + j, 0))
    assert _cats(model) == ["race"]


def test_coverage_a_floor_div_grid_leaves_the_ragged_edge_unwritten():
    """130 rows in 32-row tiles need ceil(130 / 32) = 5 blocks; a grid of
    130 // 32 = 4 leaves rows 128 and 129 unwritten."""
    assert _cats(_model(grid=(130 // 32, 2), dims=(130, 128))) == ["coverage"]
    assert _cats(_model(grid=(-(-130 // 32), 2), dims=(130, 128))) == []
    past = _model(grid=(6, 2), dims=(130, 128))               # a block past the end
    assert _cats(past) == ["coverage"]
    assert "past" in gm.check_coverage(past)


def test_smem_over_the_profiles_opt_in_limit():
    assert _cats(_model(smem=H100_SXM.smem_per_block)) == []
    assert _cats(_model(smem=H100_SXM.smem_per_block + 1)) == ["smem"]
    assert gm.check_smem(_model(smem=300_000), TORCH_CPU)   # the CPU profile prunes alike


def test_threads_block_size_accumulators_and_grid_yz():
    assert _cats(_model(threads=1025)) == ["threads"]
    assert _cats(_model(threads=289, max_threads=288)) == ["threads"]
    assert _cats(_model(threads=32, min_threads=64)) == ["threads"]
    assert _cats(_model(acc_regs=129, max_acc_regs=128)) == ["threads"]
    tall = _model(grid=(1, 70000), dims=(32, 70000 * 64))
    assert _cats(tall) == ["threads"] and "65535" in gm.check_threads(tall, H100_SXM)


@pytest.mark.parametrize("mma,ok", [(("wgmma", 64, 256, 64), True),
                                    (("wgmma", 128, 8, 16), True),
                                    (("wgmma", 32, 64, 64), False),     # under one m64
                                    (("wgmma", 64, 264, 64), False),    # past n = 256
                                    (("wgmma", 64, 60, 64), False),
                                    (("wgmma", 64, 64, 8), False),
                                    (("wmma", 16, 64, 16), True),
                                    (("wmma", 8, 64, 16), False)])
def test_tile_below_the_tensor_core_minimum(mma, ok):
    assert _cats(_model(mma=mma)) == ([] if ok else ["tile"])


def test_first_verdict_is_the_most_severe():
    model = _model(grid=(130 // 32, 2), dims=(130, 128), smem=10**6, threads=2048)
    assert _cats(model) == ["coverage", "smem", "threads"]


# ---------------------------------------------------------------------------
# the shipped launch models
# ---------------------------------------------------------------------------

SPACES = {"matmul": mm.MATMUL_SPACE, "rmsnorm": kernels.rmsnorm.RMSNORM_SPACE,
          "softmax_xent": kernels.xent.XENT_SPACE, "flash_attention": fa.ATTENTION_SPACE,
          "flash_attention_bwd": fa.ATTENTION_BWD_SPACE,
          "ssm_scan": kernels.ssm_scan.SSM_SCAN_SPACE,
          "ssm_update": kernels.ssm_scan.SSM_UPDATE_SPACE,
          "expert_gemm": kernels.moe_gemm.EXPERT_GEMM_SPACE}


def test_every_kernel_has_a_launch_model():
    assert sorted(gm.registered_models()) == sorted(kernels.KERNEL_SOURCES)


@pytest.mark.parametrize("profile", [H100_SXM, H100_PCIE])
@pytest.mark.parametrize("kernel", sorted(kernels.KERNEL_SOURCES))
def test_every_space_keeps_a_legal_config_with_no_error(kernel, profile):
    r = gm.space_report(kernel, profile)
    assert r["legal"] > 0 and r["total"] == r["legal"] + r["illegal"]
    assert not set(r["by_category"]) & {"race", "coverage", "build"}
    for label, shapes, dtypes in PHASE_SHAPES[kernel]:
        r = gm.space_report(kernel, profile, shapes, dtypes)
        assert r["legal"] > 0, label
        assert not set(r["by_category"]) & {"race", "coverage", "build"}, label


def test_split_k_gemm_declares_its_reduction_and_sums_in_a_second_kernel():
    cfg = {"bm": 128, "bn": 256, "bk": 64, "stages": 3, "splits": 2}
    part, total = gm.build_models("matmul", cfg, ((2048, 151936), (151936, 896)))
    assert (part.kernel, total.kernel) == ("gemm_tc", "gemm_splitk_sum")
    assert part.grid == (16, 4, 1, 2) and part.outputs[0].reduce == ("split",)
    assert part.cuda_grid == (4, 16, 2)                    # the fewer tiles run fastest
    assert part.workspace == 4 * 2 * 2048 * 896
    assert gm.check_model(part, H100_SXM) == [] and gm.check_model(total, H100_SXM) == []
    assert len(gm.build_models("matmul", dict(cfg, splits=1),
                               ((2048, 151936), (151936, 896)))) == 1


def test_the_routes_and_their_kernels():
    cfg = {"bm": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1}
    build = lambda c, s, d="bfloat16": gm.build_models("matmul", c, s, d)[0]
    assert build(cfg, ((8, 896), (896, 151936))).kernel == "gemm_decode"
    assert build(dict(cfg, bm=64), ((8, 896), (896, 151936))).kernel == "gemm_tc"
    wmma = build(cfg, ((1000, 896), (896, 4860)))          # n % 8: TMA cannot address w
    assert (wmma.kernel, wmma.route, wmma.mma[0]) == ("gemm_wmma", "wmma", "wmma")
    assert build(cfg, ((8, 4096), (4096, 2048)), "float32").kernel == "gemm_simt_rows"
    tile = build(cfg, ((2048, 4096), (4096, 2048)), "float32")
    assert (tile.kernel, tile.smem, tile.threads) == ("gemm_simt", mm.SIMT_SMEM, 256)


def test_flash_backward_sees_both_passes_and_the_d256_halves():
    q, kv = (2, 8, 2048, 256), (2, 1, 2048, 256)
    shapes = (q, q, kv, kv, q, q[:3])
    dtypes = ("bfloat16",) * 5 + ("float32",)
    dq, dkv = gm.build_models("flash_attention_bwd", {"block_q": 64, "block_k": 64}, shapes,
                              dtypes)
    assert (dq.kernel, dkv.kernel) == ("flash_bwd_dq_tc", "flash_bwd_dkv_tc")
    assert dkv.cuda_grid == (32, 2, 2) and dkv.outputs[0].tile == (1, 64, 128)
    assert dq.smem == fa.bwd_dq_smem_bytes({"block_q": 64}, 256)
    assert dkv.smem == fa.bwd_dkv_smem_bytes({"block_k": 64}, 256)
    # 128 x 64 fits the dk/dv pass at d = 256 but not the dq pass
    v = gm.config_verdicts("flash_attention_bwd", {"block_q": 128, "block_k": 64}, H100_SXM,
                           shapes, dtypes)
    assert [c for c, _ in v] == ["smem"] and "flash_bwd_dq_tc" in v[0][1]
    f32 = gm.build_models("flash_attention_bwd", {"block_q": 128, "block_k": 128}, shapes,
                          "float32")
    assert [m.kernel for m in f32] == ["flash_bwd_dq_simt", "flash_bwd_dkv_simt"]
    assert f32[0].smem == fa.simt_bwd_dq_smem_bytes(fa.simt_tiles(256), 256)


def test_rmsnorm_matmul_adds_its_prologue_to_the_ring():
    cfg = {"bm": 128, "bn": 256, "bk": 64, "stages": 4, "splits": 1}
    (m,) = gm.build_models("rmsnorm_matmul", cfg, ((2048, 896), (896,), (896, 151936)))
    assert m.smem == fu.prologue_smem_bytes(cfg) == mm.smem_bytes(cfg) + 128 + 4 * 64 * 2
    dec = dict(cfg, bm=16, bn=128, bk=128, stages=6)
    (d,) = gm.build_models("rmsnorm_matmul", dec, ((8, 896), (896,), (896, 151936)))
    assert d.kernel == "gemm_decode_norm" and d.smem == fu.prologue_smem_bytes(dec)
    assert d.outputs[0].index_map is None                 # walks column tiles
    (loop,) = gm.build_models("rmsnorm_matmul", cfg, ((8, 896), (896,), (896, 151936)),
                              "float32")
    assert loop.kernel == "rmm_simt"
    assert loop.smem == fu.rmm_loop_smem_bytes(mm.wmma_tiles(8), 4)


def test_rmsnorm_bwd_dw_partials_are_a_declared_reduction():
    rows, dw = gm.build_models("rmsnorm_bwd", {"block_rows": 4})
    assert rows.outputs[1].reduce == ("cta",) and rows.outputs[0].index_map is None
    assert dw.kernel == "rmsnorm_bwd_dw" and gm.check_model(dw, H100_SXM) == []


# ---------------------------------------------------------------------------
# the legal sets before the launch models held the limits, pinned: each
# (total configs of the knob product, illegal, sha256 of the sorted illegal
# config keys), from the space constraints and the flash `legal` hooks of the
# tree the models were added to
# ---------------------------------------------------------------------------

EMPTY = "e3b0c44298fc1c14"
PINNED_NOMINAL = {
    "matmul": (450, 105, "0ff7dbcf8a29aa9f"),
    "expert_gemm": (450, 105, "07412e2b5eeaf299"),
    "rmsnorm": (6, 0, EMPTY),
    "softmax_xent": (20, 0, EMPTY),
    "flash_attention": (8, 0, EMPTY),
    "flash_attention_bwd": (4, 0, EMPTY),
    "ssm_scan": (270, 100, "f1e6618e5e9d431b"),
    "ssm_update": (96, 24, "840f9ff51a77991d"),
}
PINNED_FLASH_D256 = {
    "flash_attention": ["block_k=128,block_q=128,stages=2", "block_k=128,block_q=128,stages=3",
                        "block_k=128,block_q=64,stages=2", "block_k=128,block_q=64,stages=3",
                        "block_k=64,block_q=128,stages=3"],
    "flash_attention_bwd": ["block_k=128,block_q=128", "block_k=128,block_q=64",
                            "block_k=64,block_q=128"],
}


def _raw(space):
    for combo in itertools.product(*(p.choices for p in space.params)):
        yield dict(zip(space.names, combo))


def _pin(bad):
    return hashlib.sha256("\n".join(sorted(bad)).encode()).hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(SPACES))
def test_nominal_legal_sets_equal_the_pinned(name):
    space = SPACES[name]
    bad = [ParamSpace.config_key(c) for c in _raw(space) if not space.is_valid(c)]
    assert (sum(1 for _ in _raw(space)), len(bad), _pin(bad)) == PINNED_NOMINAL[name]
    # the launch models' verdicts at the nominal shapes prune the same set
    kernels_of = getattr(space, "_grid_kernels")
    model_bad = {ParamSpace.config_key(c) for c in _raw(space)
                 if any(gm.config_verdict(k, c, H100_SXM) for k in kernels_of)}
    assert model_bad == set(bad)
    assert [ParamSpace.config_key(c) for c in space.legal_configs("h100-sxm")] == \
        [ParamSpace.config_key(c) for c in _raw(space) if ParamSpace.config_key(c) not in bad]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _phase_cases():
    for kernel, cases in sorted(PHASE_SHAPES.items()):
        for label, shapes, dtypes in cases:
            yield pytest.param(kernel, shapes, dtypes, id=f"{kernel}-{label}")
    for d in fa.HEAD_DIMS:
        for dt in ("bfloat16", "float32"):
            q, kv = (2, 8, 2048, d), (2, 1, 2048, d)
            yield pytest.param("flash_attention", (q, kv, kv), (dt,) * 3, id=f"fwd-d{d}-{dt}")
            yield pytest.param("flash_attention_bwd", (q, q, kv, kv, q, q[:3]),
                               (dt,) * 5 + ("float32",), id=f"bwd-d{d}-{dt}")


@pytest.mark.parametrize("kernel,shapes,dtypes", list(_phase_cases()))
def test_phase_shape_legal_sets_equal_the_pinned(kernel, shapes, dtypes):
    """At each main path's shapes the tunable refuses what it refused before
    (the space's limits; the flash tiles past 227 KB at d = 256 in bf16),
    and what the tuner's pre-pass prunes at those shapes lies inside that
    set: with the space's own refusals it is that set. (The space holds its
    limits at the widest nominal case, xc in fp32 for the scan, so a bf16
    call's pre-pass refuses fewer; fp32 gemms run their own tiles.)"""
    t = get_tunable(kernel)
    args = [_meta(s, d) for s, d in zip(shapes, dtypes)]
    bad = sorted(ParamSpace.config_key(c) for c in _raw(t.space) if t.why_illegal(c, *args))
    want = PINNED_NOMINAL.get(kernel, PINNED_NOMINAL["matmul"])
    if kernel in PINNED_FLASH_D256 and shapes[0][-1] == 256 and dtypes[0] == "bfloat16":
        assert bad == PINNED_FLASH_D256[kernel]
    elif kernel in ("matmul_bias_act", "rmsnorm_matmul"):
        assert (len(bad), _pin(bad)) == PINNED_NOMINAL["matmul"][1:]
    elif kernel == "rmsnorm_bwd":
        assert bad == []
    elif kernel == "softmax_xent_bwd":
        assert bad == []
    else:
        assert (len(bad), _pin(bad)) == want[1:]
    pre = set(gm.space_illegal(kernel, H100_SXM, shapes, dtypes))
    invalid = {ParamSpace.config_key(c) for c in _raw(t.space) if not t.space.is_valid(c)}
    assert pre <= set(bad) and pre | invalid == set(bad)


def test_launch_limit_memoises_each_config_and_refuses_a_kernel_with_no_model(monkeypatch):
    """A space constraint over the launch models answers each config once
    (``space.is_valid`` runs on the dispatch path) and re-asks after a
    registration; a kernel with no model raises instead of passing all."""
    calls = []
    real = gm.config_verdicts
    monkeypatch.setattr(gm, "config_verdicts", lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    limit = gm.LaunchLimit(mm.GEMM_TUNABLES, ("smem",))
    cfg = {"bm": 128, "bn": 256, "bk": 128, "stages": 6, "splits": 1}
    assert limit(cfg) is False and len(calls) >= 1
    n = len(calls)
    assert limit(dict(cfg)) is False and len(calls) == n
    assert limit(dict(reversed(list(cfg.items())))) is False
    entry = gm.registered_models()["matmul"]
    gm.register_launch_model("matmul", entry.build, entry.space, entry.nominal, entry.dtypes)
    assert limit(cfg) is False and len(calls) > n
    with pytest.raises(KeyError, match="no launch model registered"):
        gm.LaunchLimit("no_such_kernel", ("smem",))(cfg)


# ---------------------------------------------------------------------------
# consumers: ParamSpace.legal_configs, the tuner's pre-pass, the manifest
# ---------------------------------------------------------------------------


def test_legal_configs_per_platform_and_shape():
    space = fa.ATTENTION_SPACE
    assert len(space.legal_configs("h100-sxm")) == len(space.legal_configs(H100_PCIE)) == 8
    q, kv = (2, 8, 2048, 256), (2, 1, 2048, 256)
    at256 = space.legal_configs("h100-sxm", (q, kv, kv), "bfloat16")
    assert [ParamSpace.config_key(c) for c in at256] == [
        "block_k=64,block_q=64,stages=2", "block_k=64,block_q=64,stages=3",
        "block_k=64,block_q=128,stages=2"]
    with pytest.raises(KeyError, match="unknown platform"):
        space.legal_configs("tpu-v5e")


def test_the_tuner_prepass_prunes_before_any_trial_and_counts():
    """A toy whose launch model races at chunk 64 and needs too much shared
    memory at chunk 32: the pre-pass prunes both, led by their category,
    neither runs, and the record counts them."""
    from repro_torch.core.annotate import scoped_registry, tunable
    from repro_torch.core.database import TuningDatabase
    from repro_torch.core.evaluate import WallClockEvaluator
    from repro_torch.core.params import PowerOfTwoParam
    from repro_torch.core.search import ExhaustiveSearch
    from repro_torch.core.tuner import autotune

    space = ParamSpace([PowerOfTwoParam("chunk", 8, 64)])
    ran = []

    def build(cfg, shapes, dtypes, **_):
        n, c = shapes[0][0], cfg["chunk"]
        return _model(grid=(-(-n // c), 1), dims=(n, 1), tile=(c, 1),
                      index=(lambda i, j: (0, 0)) if c == 64 else (lambda i, j: (i, 0)),
                      smem=300_000 if c == 32 else 0)

    with scoped_registry():
        @tunable("zz_toy_prepass", space=space, reference=lambda x: x * 2)
        def toy(x, *, chunk):
            ran.append(chunk)
            return x * 2

        gm.register_launch_model("zz_toy_prepass", build, space=space, nominal=((256,),),
                                 dtypes="float32")
        try:
            db = TuningDatabase(None)
            res = autotune(toy, (torch.ones(256),), search=ExhaustiveSearch(budget=10),
                           evaluator=WallClockEvaluator(1, 0), db=db)
        finally:
            gm._MODELS.pop("zz_toy_prepass")
    pruned = {t.config["chunk"]: t.meta["pruned"] for t in res.search.trials
              if "pruned" in t.meta}
    assert sorted(pruned) == [32, 64]
    assert pruned[64].startswith("race: ") and pruned[32].startswith("smem: ")
    assert 32 not in ran and 64 not in ran
    assert db.records()[0].meta["static_pruned"] == 2


def test_the_campaign_manifest_carries_the_legality_stamp(tmp_path):
    from repro_torch.campaign import planner, scheduler
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.transformer import RunConfig

    cfg = get_config("qwen2_0_5b")
    jobs = (planner.plan_training_jobs(cfg, SHAPES["train_2k"], run=RunConfig(loss_chunk=512))
            + planner.plan_serving_jobs(cfg, max_batch=8, max_seq=2048))
    m = scheduler.build_manifest(jobs, 200, path=str(tmp_path / "c.json"), profile=H100_SXM)
    stamp = scheduler.CampaignManifest.load(str(tmp_path / "c.json")).meta["legality"]
    assert stamp["matmul"] == {"total": 450, "legal": 345, "pruned": 105, "pruned_smem": 105}
    assert stamp["flash_attention"]["pruned"] == 0
    assert "attn_chunks" not in stamp                    # torch code: no launch model
    assert m.summary()["configs_pruned"] == 3 * 105
    assert m.meta["bwd_roster"] is True
    assert not scheduler.manifest_missing_bwd(m)
