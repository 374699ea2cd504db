"""The serving slice: the port's ServingEngine against the JAX package's.

Both engines get the same parameters (JAX init, carried across through
numpy) and the same seeded requests, and must emit the same tokens, greedy
and sampled (the host-side numpy sampler is shared by design). The
continuous-batching property of tests/test_serving_continuous.py holds for
the port too: any arrival pattern gives the tokens of serving each request
alone, and a reused slot leaks nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402,F401

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed.sharding import Layout  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402

MAX_SEQ = 64
RUN = RunConfig(q_chunk=16, k_chunk=16)


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config("qwen2_0_5b").reduced()
    cfg = get_config("qwen2_0_5b").reduced()
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, tparams


def _prompt(length: int, seed: int) -> np.ndarray:
    return np.random.RandomState(10_000 + 17 * length + seed).randint(0, 256, length).astype(np.int32)


def _engine(cfg, tparams, max_batch=3, **kw):
    return ServingEngine(cfg, RUN, tparams, EngineConfig(max_batch=max_batch, max_seq=MAX_SEQ, **kw),
                         runtime=repro_torch.runtime())


def test_same_tokens_as_the_jax_engine(model):
    jcfg, cfg, params, tparams = model
    spec = [(3, 6, 0.0, 0), (17, 5, 0.8, 1), (9, 7, 0.0, 2), (12, 4, 1.0, 3), (30, 6, 0.7, 4)]
    j_engine = jeng.ServingEngine(
        jcfg, JRun(remat="none", q_chunk=16, k_chunk=16), params, make_host_mesh(), Layout(),
        jeng.EngineConfig(max_batch=3, max_seq=MAX_SEQ), runtime=repro.runtime(mode="reference"))
    t_engine = _engine(cfg, tparams)
    for eng, R in ((j_engine, jeng.Request), (t_engine, Request)):
        for i, (L, n, temp, seed) in enumerate(spec):
            eng.submit(R(prompt=_prompt(L, seed), max_new_tokens=n, temperature=temp,
                         seed=seed, arrival_time=float(i)))
    j_done, t_done = j_engine.serve(), t_engine.serve()
    assert [r.output.tolist() for r in t_done] == [r.output.tolist() for r in j_done]
    assert t_engine.stats["decode_steps"] == j_engine.stats["decode_steps"]
    assert t_engine.stats["prefill_tokens"] == j_engine.stats["prefill_tokens"]
    assert set(t_engine.runtime.telemetry.tiers) == {"heuristic"}


_SOLO = {}


def _solo_greedy(cfg, tparams, prompt, max_new):
    key = (prompt.tobytes(), max_new)
    if key not in _SOLO:
        with torch.inference_mode():
            toks = torch.from_numpy(prompt.astype(np.int64))[None]
            logits, caches = lm.prefill(tparams, {"tokens": toks}, cfg, RUN, cache_len=MAX_SEQ)
            out = [int(logits[0].argmax())]
            for step in range(min(max_new, MAX_SEQ - len(prompt)) - 1):
                logits, caches = lm.decode_step(tparams, torch.tensor([[out[-1]]]), caches,
                                                torch.tensor(len(prompt) + step), cfg, RUN)
                out.append(int(logits[0].argmax()))
        _SOLO[key] = np.asarray(out, np.int32)
    return _SOLO[key]


@pytest.mark.parametrize("case_seed", range(4))
def test_any_arrival_pattern_matches_solo(model, case_seed):
    _, cfg, _, tparams = model
    rs = np.random.RandomState(500 + case_seed)
    eng = _engine(cfg, tparams)
    t = 0.0
    reqs = []
    for _ in range(rs.randint(2, 7)):
        t += int(rs.randint(0, 7))
        reqs.append(Request(prompt=_prompt(int(rs.choice([3, 9, 12, 17])), int(rs.randint(4))),
                            max_new_tokens=int(rs.randint(1, 7)), arrival_time=t))
    for r in reqs:
        eng.submit(r)
    done = eng.serve()
    assert len(done) == len(reqs) and all(s is None for s in eng._slots)
    for r in done:
        np.testing.assert_array_equal(r.output, _solo_greedy(cfg, tparams, r.prompt,
                                                             r.max_new_tokens))


def test_freed_slot_cache_never_leaks(model):
    _, cfg, _, tparams = model
    one = _engine(cfg, tparams, max_batch=1)
    a = Request(prompt=_prompt(17, 0), max_new_tokens=12)
    b = Request(prompt=_prompt(3, 1), max_new_tokens=8)
    one.submit(a)
    one.submit(b)
    da, db = one.serve()
    assert da.slot == db.slot == 0
    np.testing.assert_array_equal(db.output, _solo_greedy(cfg, tparams, b.prompt, 8))
    np.testing.assert_array_equal(da.output, _solo_greedy(cfg, tparams, a.prompt, 12))


def test_admission_sheds_past_max_queue_and_rejects_bad_requests(model):
    _, cfg, _, tparams = model
    eng = _engine(cfg, tparams, max_queue=2)
    assert eng.submit(Request(prompt=_prompt(3, 0), max_new_tokens=2))
    assert eng.submit(Request(prompt=_prompt(3, 1), max_new_tokens=2))
    shed = Request(prompt=_prompt(3, 2), max_new_tokens=2)
    assert not eng.submit(shed)
    assert shed.shed and shed.shed_reason.startswith("queue_full")
    assert eng.stats["requests_shed"] == 1
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=_prompt(MAX_SEQ, 0), max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=_prompt(3, 0), max_new_tokens=0))
    assert len(eng.serve()) == 2
    assert sorted(eng.timings["prefill_s"]) == [16]          # one bucket, timed
    assert len(eng.timings["decode_s"]) == eng.stats["decode_steps"]
