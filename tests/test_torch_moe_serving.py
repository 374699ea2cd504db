"""The MoE models' serving engines in the port against the JAX package's,
on the CPU (the models of ``test_torch_moe_models.py``).

* The serving engine's tokens against the JAX engine's under the same
  arrivals, for reduced Mixtral-8x7B and reduced Jamba-1.5-Large with its
  experts; with capacity headroom, any arrival pattern gives the tokens of
  serving each request alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.distributed.sharding import Layout  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402
from test_torch_moe_models import CACHE_LEN, JRUN, RUN, jamba, mixtral  # noqa: E402,F401


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _prompt(length: int, seed: int) -> np.ndarray:
    return np.random.RandomState(10_000 + 17 * length + seed).randint(0, 256, length).astype(
        np.int32)


def _engine(cfg, tparams, max_batch=3):
    return ServingEngine(cfg, RUN, tparams, EngineConfig(max_batch=max_batch, max_seq=CACHE_LEN),
                         runtime=repro_torch.runtime())


@pytest.mark.parametrize("which", ["mixtral", "jamba"])
def test_same_tokens_as_the_jax_engine(request, which):
    """Default capacity (1.25): the pool's rows share it, so both engines
    must route the same slots together, free ones included."""
    jcfg, cfg, params, tparams = request.getfixturevalue(which)
    spec = [(9, 5, 0.0, 0), (19, 4, 0.8, 1), (2, 6, 0.0, 2), (11, 4, 1.0, 3)]
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
    assert t_engine.stats["prefill_tokens"] == j_engine.stats["prefill_tokens"]


def _solo_greedy(cfg, tparams, prompt, max_new):
    with torch.inference_mode():
        toks = torch.from_numpy(prompt.astype(np.int64))[None]
        logits, caches = lm.prefill(tparams, {"tokens": toks}, cfg, RUN, cache_len=CACHE_LEN)
        out = [int(logits[0].argmax())]
        for step in range(min(max_new, CACHE_LEN - len(prompt)) - 1):
            logits, caches = lm.decode_step(tparams, torch.tensor([[out[-1]]]), caches,
                                            torch.tensor(len(prompt) + step), cfg, RUN)
            out.append(int(logits[0].argmax()))
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("case_seed", range(2))
def test_any_arrival_pattern_matches_solo_with_headroom(mixtral, case_seed):
    """With capacity_factor 8 no token is ever dropped, so the rows stop
    coupling and the solo property holds for MoE (the JAX tests set the
    same headroom). The capacity factor sets no parameter: the module's
    Mixtral serves with it."""
    _, cfg, _, tparams = mixtral
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    rs = np.random.RandomState(700 + case_seed)
    eng = _engine(cfg, tparams)
    t = 0.0
    reqs = []
    for _ in range(rs.randint(2, 6)):
        t += int(rs.randint(0, 5))
        reqs.append(Request(prompt=_prompt(int(rs.choice([2, 9, 13])), int(rs.randint(3))),
                            max_new_tokens=int(rs.randint(1, 8)), arrival_time=t))
    for r in reqs:
        eng.submit(r)
    done = eng.serve()
    assert len(done) == len(reqs)
    for r in done:
        np.testing.assert_array_equal(r.output, _solo_greedy(cfg, tparams, r.prompt,
                                                             r.max_new_tokens))


def test_serve_launcher_takes_mixtral_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "mixtral_8x7b", "--smoke", "--device", "cpu", "--requests", "3",
                "--new-tokens", "4", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens on cpu" in out
    assert "expert_gemm" in out
