"""The port's cost models against the JAX package's: ``tools/analytic.py``'s
step FLOPs, step memory traffic and per-site roofline for every arch and
every shape of the JAX package's ``SHAPES``, at the same peaks (a JAX
``HardwareProfile`` built here with the port's H100 numbers); the port's
own deviations (fp32 gemms at the fp32 peak, ``roofline_fraction`` on the
profile given); and ``core.evaluate.roofline_from_launch``, the config's
price, never below the analytic site bound. Nothing is timed."""
import functools
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs import base as jbase  # noqa: E402
from repro.core.platform import HardwareProfile as JProfile  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.tools import analytic as janalytic  # noqa: E402
from repro_torch import kernels  # noqa: E402,F401
from repro_torch.campaign import planner, scheduler  # noqa: E402
from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_config  # noqa: E402
from repro_torch.core import gridmodel as gm  # noqa: E402
from repro_torch.core.evaluate import (CostModelEvaluator, RooflineTerms,  # noqa: E402
                                       price_launches, roofline_from_launch)
from repro_torch.core.params import ParamSpace  # noqa: E402
from repro_torch.core.platform import H100_PCIE, H100_SXM  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.tools import analytic  # noqa: E402

REL = 1e-12


def _jprofile(p, peak=None):
    """A JAX profile with the port's numbers (its bf16 peak replaced by
    ``peak`` where given)."""
    return JProfile(name=p.name, peak_flops_bf16=peak or p.peak_flops_bf16,
                    hbm_bandwidth=p.hbm_bandwidth, ici_bandwidth=1.0, hbm_bytes=p.hbm_bytes,
                    vmem_bytes=p.smem_per_block)


@functools.lru_cache(maxsize=None)
def _counts(name):
    """(params, active params) of an arch, by the port (its count equals the
    JAX package's: tests/test_torch_arch_smoke.py)."""
    cfg = get_config(name)
    return analytic.param_count(cfg), analytic.active_param_count(cfg)


@pytest.fixture
def same_counts(monkeypatch):
    """Both packages' step models read the one count, so the step tests hold
    the arithmetic, not JAX's abstract init (seconds an arch)."""
    monkeypatch.setattr(jlm, "param_count", lambda cfg: _counts(cfg.name)[0])
    monkeypatch.setattr(jlm, "active_param_count", lambda cfg: _counts(cfg.name)[1])


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "arctic_480b"])
def test_active_param_count_equals_jax(arch):
    assert analytic.active_param_count(get_config(arch)) == \
        jlm.active_param_count(jbase.get_config(arch))
    assert analytic.active_param_count(get_config("qwen2_0_5b")) == \
        lm.param_count(get_config("qwen2_0_5b"))


def _shapes():
    for name, s in sorted(jbase.SHAPES.items()):
        yield pytest.param(s, ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind), id=name)


@pytest.mark.parametrize("jshape,shape", list(_shapes()))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_step_flops_and_bytes_equal_jax(same_counts, arch, jshape, shape):
    cfg, jcfg = get_config(arch), jbase.get_config(arch)
    for remat in ("none", "full"):
        t, j = analytic.step_flops(cfg, shape, remat), janalytic.step_flops(jcfg, jshape, remat)
        assert t.keys() == j.keys()
        for k in t:
            assert t[k] == pytest.approx(j[k], rel=REL)
    for chips, model_par, fsdp in ((1, 1, False), (16, 16, True)):
        t = analytic.step_hbm_bytes(cfg, shape, chips, model_par, fsdp, "none")
        j = janalytic.step_hbm_bytes(jcfg, jshape, chips, model_par, fsdp, "none")
        assert t.keys() == j.keys()
        for k in t:
            assert t[k] == pytest.approx(j[k], rel=REL), k
    tr = analytic.analytic_roofline(cfg, shape, profile=H100_PCIE)
    jr = janalytic.analytic_roofline(jcfg, jshape, 1, {}, model_par=1, remat="none",
                                     profile=_jprofile(H100_PCIE))
    for k in ("compute_s", "memory_s", "flops_per_chip", "hbm_bytes_per_chip", "model_flops"):
        assert getattr(tr, k) == pytest.approx(getattr(jr, k), rel=REL)
    assert tr.collective_s == 0.0 and tr.dominant == jr.dominant


@functools.lru_cache(maxsize=None)
def _jobs(arch):
    cfg = get_config(arch)
    jobs = (planner.plan_training_jobs(cfg, analytic_shape("train_2k"),
                                       run=RunConfig(loss_chunk=512))
            + planner.plan_serving_jobs(cfg, 8, 2048))
    return scheduler.dedupe_jobs(jobs, "h100-sxm")


def analytic_shape(name):
    from repro_torch.configs import SHAPES

    return SHAPES[name]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_site_roofline_equals_jax_at_the_same_peaks(arch):
    """Every site each arch's plan keys, on the port's two card profiles; a
    float32 gemm (the simt route) is held against JAX given the fp32 peak in
    its bf16 peak's place, JAX pricing every site at the bf16 peak."""
    n_simt = 0
    for profile in (H100_SXM, H100_PCIE):
        bf16, f32 = _jprofile(profile), _jprofile(profile, profile.peak_flops_fp32)
        for job in _jobs(arch):
            dtype = job.arg_dtypes[0]
            simt = job.kernel in analytic.SIMT_GEMMS and dtype == "float32"
            n_simt += simt
            t = analytic.site_roofline_seconds(job.kernel, job.arg_shapes, dtype, profile)
            j = janalytic.site_roofline_seconds(job.kernel, job.arg_shapes, dtype,
                                                f32 if simt else bf16)
            assert t == pytest.approx(j, rel=REL), job.kernel
    assert (n_simt > 0) == (arch in ("jamba_1_5_large", "xlstm_1_3b"))


def test_the_scheduler_prices_with_the_one_site_model():
    assert scheduler.site_roofline_seconds is analytic.site_roofline_seconds
    assert not hasattr(scheduler, "_DTYPE_BYTES")
    job = _jobs("qwen2_0_5b")[0]
    assert scheduler.job_roofline_seconds(job, H100_SXM) == analytic.site_roofline_seconds(
        job.kernel, job.arg_shapes, job.arg_dtypes[0], H100_SXM)


def test_roofline_fraction_uses_the_profile_given():
    """JAX's divides by TPU v5e's peak whatever profile it was given; the
    port's by the given profile's."""
    cfg, shape = get_config("qwen2_0_5b"), ShapeSpec("decode", 2048, 8, "decode")
    sxm = analytic.analytic_roofline(cfg, shape, profile=H100_SXM)
    pcie = analytic.analytic_roofline(cfg, shape, profile=H100_PCIE)
    for r, p in ((sxm, H100_SXM), (pcie, H100_PCIE)):
        ideal = r.model_flops / r.chips / p.peak_flops_bf16
        assert r.roofline_fraction == pytest.approx(min(1.0, ideal / r.step_time_s), rel=REL)
    assert 0 < sxm.roofline_fraction < 1 and pcie.roofline_fraction != sxm.roofline_fraction
    assert sxm.roofline_fraction != pytest.approx(
        min(1.0, sxm.model_flops / 197e12 / sxm.step_time_s))      # TPU v5e's bf16 peak
    # several cards: collective bytes are priced (a kind with no ring factor moves once)
    multi = analytic.analytic_roofline(cfg, shape, chips=4, collective_bytes_by_kind={"x": 1.0})
    assert multi.collective_bytes_per_chip == 1.0
    assert multi.collective_s == pytest.approx(1.0 / H100_SXM.interconnect_bandwidth, rel=REL)


def test_fp32_gemm_sites_run_at_the_fp32_peak():
    sh = ((2048, 16384), (16384, 8192))
    f32 = analytic.site_roofline_seconds("matmul", sh, "float32", H100_SXM)
    bf16 = analytic.site_roofline_seconds("matmul", sh, "bfloat16", H100_SXM)
    assert f32 == pytest.approx(2 * 2048 * 16384 * 8192 / H100_SXM.peak_flops_fp32, rel=REL)
    assert bf16 == pytest.approx(2 * 2048 * 16384 * 8192 / H100_SXM.peak_flops_bf16, rel=REL)


def test_scenario_seconds_weight_the_heavier_arch():
    secs = scheduler.analytic_scenario_seconds(["qwen2_0_5b", "gemma3_27b"], ("train_2k",))
    assert secs["gemma3-27b/train_2k"] > 10 * secs["qwen2-0.5b/train_2k"]


# ---------------------------------------------------------------------------
# the launch-model price of one call
# ---------------------------------------------------------------------------


def _site_args(kernel):
    """(shapes, dtypes) of one main-path call per kernel."""
    from repro_torch.analysis.legality import PHASE_SHAPES

    _, shapes, dtypes = PHASE_SHAPES[kernel][0]
    return shapes, dtypes


def _calls():
    from repro_torch.analysis.legality import PHASE_SHAPES

    for kernel, cases in sorted(PHASE_SHAPES.items()):
        for label, shapes, dtypes in cases:
            yield pytest.param(kernel, shapes, dtypes, id=f"{kernel}-{label}")


@pytest.mark.parametrize("kernel,shapes,dtypes", list(_calls()))
def test_the_launch_price_never_undercuts_the_site_bound(kernel, shapes, dtypes):
    """The site is priced at its largest argument's dtype (the cross
    entropy's bf16 logits, not its fp32 cotangent that the key promotes to)."""
    from repro_torch.core.evaluate import site_dtype

    big = max(range(len(shapes)), key=lambda i: (math.prod(shapes[i]), -i))
    assert site_dtype(shapes, dtypes) == dtypes[big]
    site = analytic.site_roofline_seconds(kernel, shapes, dtypes[big], H100_SXM)
    space = gm.registered_models()[kernel].space
    for cfg in space.legal_configs(H100_SXM, shapes, dtypes, kernel=kernel):
        t = roofline_from_launch(kernel, cfg, shapes, dtypes, H100_SXM)
        assert t.step_time_s >= site and t.analytic_s == pytest.approx(site, rel=REL)
        assert t.compute_s > 0 and t.memory_s > 0 and t.collective_s == 0.0


@pytest.mark.parametrize("kernel,shapes", [
    ("matmul", ((8192, 896), (896, 4864))),
    ("matmul_bias_act", ((8192, 896), (896, 4864), (4864,))),
    ("expert_gemm", ((8, 2560, 4096), (8, 4096, 14336)))])
def test_the_price_follows_the_config(kernel, shapes):
    """Where the tensor cores bound the call, the padded tiles and the last
    wave make configs' prices differ; the heuristic's is among them."""
    space = gm.registered_models()[kernel].space
    prices = {ParamSpace.config_key(c): roofline_from_launch(kernel, c, shapes, "bfloat16")
              .step_time_s for c in space.legal_configs(H100_SXM, shapes, "bfloat16",
                                                        kernel=kernel)}
    assert len(set(prices.values())) > 3
    assert min(prices.values()) >= analytic.site_roofline_seconds(kernel, shapes, "bfloat16",
                                                                  H100_SXM)


def test_the_price_counts_padded_tiles_waves_and_spilled_partials():
    cfg = {"bm": 128, "bn": 256, "bk": 64, "stages": 3, "splits": 1}
    (m,) = gm.build_models("matmul", cfg, ((8192, 896), (896, 4864)))
    assert m.flops == 2.0 * 8192 * (19 * 256) * 896                      # 4864 -> 19 tiles
    t = price_launches((m,), H100_SXM)
    assert t.compute_s == pytest.approx(
        m.flops / (64 * 19) * 10 * 132 / H100_SXM.peak_flops_bf16)     # 1216 blocks: 10 waves
    big = gm.build_models("matmul", dict(cfg, splits=16),
                          ((8192, 65536), (65536, 8192)))[0]
    assert big.workspace > H100_SXM.l2_bytes
    spilled = price_launches((big,), H100_SXM)
    assert spilled.bytes == big.bytes + 2 * (big.workspace - H100_SXM.l2_bytes)


def test_cost_model_evaluator_scores_without_launching():
    shapes, dtypes = _site_args("matmul")
    cfg = {"bm": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1}
    ev = CostModelEvaluator(H100_SXM)
    m = ev.evaluate(lambda: gm.build_models("matmul", cfg, shapes, dtypes))
    assert m.ok and m.objective == price_launches(
        gm.build_models("matmul", cfg, shapes, dtypes), H100_SXM).step_time_s
    m2 = ev.evaluate(lambda: roofline_from_launch("matmul", cfg, shapes, dtypes, H100_SXM))
    assert m2.ok and m2.objective >= m.objective and "roofline" in m2.meta
    assert isinstance(roofline_from_launch("matmul", cfg, shapes, dtypes), RooflineTerms)
    bad = ev.evaluate(lambda: roofline_from_launch("matmul", cfg, ((8, 3), (4, 5)), dtypes))
    assert not bad.ok and "ValueError" in bad.error
