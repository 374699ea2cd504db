"""The hybrid slice's parameters and serving: reduced Jamba-1.5-Large
without experts (the model of ``test_torch_hybrid.py``) in the port against
the JAX package.

Held against JAX: every parameter leaf with its dtype; the serving engine's
tokens; the serving plan. The port's engine serves any arrival pattern as it
serves each request alone, and a freed slot's Mamba state never reaches its
next occupant. Tolerance: ``test_torch_hybrid.py``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.campaign import planner as jplanner  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed.sharding import Layout  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.campaign import planner  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402
from test_torch_hybrid import (  # noqa: E402,F401
    CACHE_LEN,
    JRUN,
    RUN,
    _dense,
    _leaves,
    model,
)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converted_params_carry_every_leaf_with_its_dtype(dtype):
    jcfg = dataclasses.replace(_dense(j_get_config), dtype=dtype, num_layers=8)
    cfg = dataclasses.replace(_dense(get_config), dtype=dtype, num_layers=8)
    params, _ = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tparams = from_jax_params(np_params, cfg, device="cpu")
    own = lm.init_params(cfg, 0, "cpu")
    jl = {name: leaf for name, leaf in _leaves(
        {k: v for k, v in np_params.items() if k != "segments"})}
    for name, leaf in _leaves(np_params["segments"][0]):
        jl[f"/segments/0/0{name}"] = leaf[0]
    tl, ol = dict(_leaves(tparams)), dict(_leaves(own))
    assert set(tl) == set(jl) == set(ol)
    for name, a in jl.items():
        assert tuple(tl[name].shape) == a.shape == tuple(ol[name].shape), name
        assert str(tl[name].dtype).split(".")[1] == str(a.dtype) == str(ol[name].dtype).split(".")[1], name
        np.testing.assert_array_equal(tl[name].float().numpy(), a.astype(np.float32))
    fp32 = {n.rsplit("/", 1)[1] for n, t in tl.items() if t.dtype == torch.float32}
    want = {"dt_bias", "A_log", "D"} if dtype == "bfloat16" else {n.rsplit("/", 1)[1] for n in tl}
    assert fp32 == want


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _prompt(length: int, seed: int) -> np.ndarray:
    return np.random.RandomState(10_000 + 17 * length + seed).randint(0, 256, length).astype(np.int32)


def _engine(cfg, tparams, max_batch=3, **kw):
    return ServingEngine(cfg, RUN, tparams, EngineConfig(max_batch=max_batch, max_seq=CACHE_LEN,
                                                         **kw),
                         runtime=repro_torch.runtime())


def test_same_tokens_as_the_jax_engine(model):
    jcfg, cfg, params, tparams = model
    spec = [(8, 5, 0.0, 0), (19, 4, 0.8, 1), (2, 6, 0.0, 2), (11, 4, 1.0, 3)]
    j_engine = jeng.ServingEngine(
        jcfg, JRUN, params, make_host_mesh(), Layout(),
        jeng.EngineConfig(max_batch=3, max_seq=CACHE_LEN), runtime=repro.runtime(mode="reference"))
    t_engine = _engine(cfg, tparams)
    for eng, R in ((j_engine, jeng.Request), (t_engine, Request)):
        for i, (L, n, temp, seed) in enumerate(spec):
            eng.submit(R(prompt=_prompt(L, seed), max_new_tokens=n, temperature=temp,
                         seed=seed, arrival_time=float(i)))
    j_done, t_done = j_engine.serve(), t_engine.serve()
    assert [r.output.tolist() for r in t_done] == [r.output.tolist() for r in j_done]
    assert t_engine.stats["decode_steps"] == j_engine.stats["decode_steps"]
    # exact-length prefill: no bucket padding
    assert t_engine.stats["prefill_tokens"] == j_engine.stats["prefill_tokens"] \
        == sum(L for L, *_ in spec)
    assert sorted(t_engine.timings["prefill_s"]) == sorted(L for L, *_ in spec)


_SOLO = {}


def _solo_greedy(cfg, tparams, prompt, max_new):
    key = (prompt.tobytes(), max_new)
    if key not in _SOLO:
        with torch.inference_mode():
            toks = torch.from_numpy(prompt.astype(np.int64))[None]
            logits, caches = lm.prefill(tparams, {"tokens": toks}, cfg, RUN, cache_len=CACHE_LEN)
            out = [int(logits[0].argmax())]
            for step in range(min(max_new, CACHE_LEN - len(prompt)) - 1):
                logits, caches = lm.decode_step(tparams, torch.tensor([[out[-1]]]), caches,
                                                torch.tensor(len(prompt) + step), cfg, RUN)
                out.append(int(logits[0].argmax()))
        _SOLO[key] = np.asarray(out, np.int32)
    return _SOLO[key]


@pytest.mark.parametrize("case_seed", range(3))
def test_any_arrival_pattern_matches_solo(model, case_seed):
    _, cfg, _, tparams = model
    rs = np.random.RandomState(700 + case_seed)
    eng = _engine(cfg, tparams)
    t = 0.0
    reqs = []
    for _ in range(rs.randint(2, 6)):
        t += int(rs.randint(0, 5))
        reqs.append(Request(prompt=_prompt(int(rs.choice([2, 8, 13])), int(rs.randint(3))),
                            max_new_tokens=int(rs.randint(1, 6)), arrival_time=t))
    for r in reqs:
        eng.submit(r)
    done = eng.serve()
    assert len(done) == len(reqs) and all(s is None for s in eng._slots)
    assert eng.stats["prefill_tokens"] == sum(len(r.prompt) for r in reqs)
    for r in done:
        np.testing.assert_array_equal(r.output, _solo_greedy(cfg, tparams, r.prompt,
                                                             r.max_new_tokens))


def test_freed_slot_state_never_leaks(model):
    """One slot, two requests in turn: the second occupant decodes as it
    would alone, though the first left its Mamba state and conv tail in the
    slot (an 8-token prompt after a 17-token one)."""
    _, cfg, _, tparams = model
    one = _engine(cfg, tparams, max_batch=1)
    a = Request(prompt=_prompt(17, 0), max_new_tokens=10)
    b = Request(prompt=_prompt(8, 1), max_new_tokens=7)
    one.submit(a)
    one.submit(b)
    da, db = one.serve()
    assert da.slot == db.slot == 0
    np.testing.assert_array_equal(db.output, _solo_greedy(cfg, tparams, b.prompt, 7))
    np.testing.assert_array_equal(da.output, _solo_greedy(cfg, tparams, a.prompt, 10))


def test_warmup_covers_the_hybrid_sites(model):
    _, cfg, _, tparams = model
    eng = _engine(cfg, tparams)
    resolved = eng.warmup()
    kernels = {k.split("|")[0] for k in resolved}
    assert {"ssm_scan", "ssm_update", "matmul", "rmsnorm", "flash_attention"} <= kernels


# ---------------------------------------------------------------------------
# Planner and errors
# ---------------------------------------------------------------------------

FIELDS = ("kernel", "arg_shapes", "arg_dtypes", "key_extra", "weight", "scenarios")


def _rows(jobs):
    return [tuple(getattr(j, f) for f in FIELDS) for j in jobs]


@pytest.mark.parametrize("reduced,serving,max_tokens", [
    (True, (2, 32), 4096), (True, (8, 128), 8192), (False, (8, 2048), 8192)],
    ids=["reduced-2x32", "reduced-8x128", "full-8x2048"])
def test_serving_plan_equals_jax(reduced, serving, max_tokens):
    jcfg, tcfg = _dense(j_get_config, reduced), _dense(get_config, reduced)
    if not reduced:                       # one super-block, as the card serves it
        jcfg, tcfg = (dataclasses.replace(c, num_layers=8) for c in (jcfg, tcfg))
    t = planner.plan_serving_jobs(tcfg, *serving, max_tokens=max_tokens)
    j = jplanner.plan_serving_jobs(jcfg, *serving, kernels=planner.DEFAULT_KERNELS,
                                   max_tokens=max_tokens)
    assert _rows(t) == _rows(j)
    assert {x.kernel for x in t} >= {"ssm_scan", "ssm_update"}
    if not reduced:
        (scan,) = [x for x in t if x.kernel == "ssm_scan" and x.arg_shapes[0][1] == 2048]
        assert scan.arg_shapes[0] == (1, 2048, 16384) and scan.weight == 7


def test_errors_name_the_missing_slice():
    """Jamba with its MoE layers initialises (every second layer an MoE
    FFN), and hybrid training is no longer a missing slice: Jamba's training
    plans, with and without experts, reduced and at full width, equal the
    JAX planner's, the Mamba rows and the scan's backward included."""
    cfg = get_config("jamba_1_5_large").reduced()
    params = lm.init_params(cfg, 0, "cpu")
    block = params["segments"][0][0]
    assert [("moe" in block[f"l{i}"], "ffn" in block[f"l{i}"]) for i in range(8)] == \
        [(False, True), (True, False)] * 4
    for reduced in (True, False):
        name, chunk = ("train_smoke", 32) if reduced else ("train_2k", 512)
        t_shape = SHAPES[name]
        j_shape = jconfigs.ShapeSpec(t_shape.name, t_shape.seq_len, t_shape.global_batch,
                                     t_shape.kind)
        for experts in (True, False):
            get = lambda g: (g("jamba_1_5_large") if experts else _dense(g, False))
            tcfg, jcfg = get(get_config), get(j_get_config)
            if reduced:
                tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
            t = (planner.plan_training_jobs(tcfg, t_shape, run=RunConfig(loss_chunk=chunk))
                 + planner.plan_train_jobs(tcfg, t_shape))
            j = (jplanner.plan_training_jobs(
                     jcfg, j_shape, run=JRun(remat="none", loss_chunk=chunk, microbatches=1),
                     kernels=planner.DEFAULT_KERNELS, max_tokens=planner.MAX_TOKENS)
                 + jplanner.plan_train_jobs(jcfg, j_shape, kernels=planner.DEFAULT_KERNELS,
                                            max_tokens=planner.MAX_TOKENS))
            assert _rows(t) == _rows(j)
            kernels = {x.kernel for x in t}
            assert {"ssm_scan", "ssm_scan_bwd", "attn_chunks"} <= kernels
            assert ("expert_gemm" in kernels) == experts
            if not reduced:
                (bwd,) = [x for x in t if x.kernel == "ssm_scan_bwd"]
                assert bwd.arg_shapes[:3] == ((4, 2048, 16384), (4, 16384, 16),
                                              (4, 2048, 16384))
                assert bwd.weight == 63             # 9 super-blocks of 7 Mamba layers


@pytest.mark.parametrize("reduced,serving,max_tokens", [
    (True, (2, 32), 4096), (True, (8, 128), 8192), (False, (8, 2048), 8192)],
    ids=["reduced-2x32", "reduced-8x128", "full-8x2048"])
def test_serving_plan_with_experts_equals_jax(reduced, serving, max_tokens):
    jcfg, tcfg = j_get_config("jamba_1_5_large"), get_config("jamba_1_5_large")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    t = planner.plan_serving_jobs(tcfg, *serving, max_tokens=max_tokens)
    j = jplanner.plan_serving_jobs(jcfg, *serving, kernels=planner.DEFAULT_KERNELS,
                                   max_tokens=max_tokens)
    assert _rows(t) == _rows(j)
    egemm = [x for x in t if x.kernel == "expert_gemm"]
    assert egemm and all(x.arg_shapes[0][0] == tcfg.num_experts for x in egemm)
    if not reduced:                       # 36 MoE layers; a decode pool of 8 has capacity 2
        pool = [x for x in egemm if x.scenarios[0].endswith("b8s1024")]
        assert [x.arg_shapes for x in pool] == [((16, 2, 8192), (16, 8192, 24576)),
                                                ((16, 2, 24576), (16, 24576, 8192))]
        assert [x.weight for x in pool] == [2 * 36 * 1024, 36 * 1024]
