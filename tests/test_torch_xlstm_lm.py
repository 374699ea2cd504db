"""The xLSTM slice end to end: reduced xLSTM-1.3B (alternating mLSTM and
sLSTM layers with no FFN, f32, 4 layers at d = 64) in the port against the
JAX package, on the CPU.

The JAX ``init_params`` output and the JAX pipeline's batches cross through
numpy with ``from_jax_params``. Held against JAX: prefill logits and every
state leaf at exact prompt lengths (a recurrent arch prefills at exact
length), in kernel mode (JAX: Pallas in interpret mode; the port: the
kernels' plain versions) and in reference mode; three decode steps at a
vector ``pos`` from a two-slot pool, the pool's mLSTM and sLSTM state after
each; the serving engine's tokens; ``loss_fn`` and every gradient leaf in
kernel mode (``tests/test_torch_arch_smoke.py`` holds reference mode); two
AdamW steps of the port's ``Trainer``. In the port alone: a decode step
writes each layer's new state back into the pool, the engine serves any
arrival pattern as it serves each request alone and a freed slot's state
never reaches its next occupant, ``remat="full"`` recomputes the same
gradients through the layers' Python loops, and both launchers run the arch
on the CPU.

Tolerances: logits and states 1e-5 of max|JAX| (at least 1), the loss 1e-5
relative and each gradient leaf 3e-5 of its max|JAX|, as for the hybrid:
the same fp32 math through 4 layers, sums in another order. Parameters
after two trainer steps, each leaf's max difference in units of the summed
learning rates: the median leaf within 5e-2 and every leaf within 0.25, as
``tests/test_torch_hybrid_train.py`` argues (Adam moves an element whose
gradient is a few fp32 steps from zero by up to lr).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipe  # noqa: E402
from repro.distributed.sharding import Layout  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import batch_to_tensors, from_jax_params  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

JRUN = JRun(remat="none", mlstm_chunk=8, loss_chunk=32)
RUN = RunConfig(mlstm_chunk=8, loss_chunk=32)
CACHE_LEN = 48
TOL = 1e-5
TOL_GRAD = 3e-5
TOL_STEP_MEDIAN = 5e-2
TOL_STEP_MAX = 0.25
MLSTM_LEAVES, SLSTM_LEAVES = ("C", "n", "m"), ("c", "n", "h", "m")


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = j_get_config("xlstm_1_3b").reduced(), get_config("xlstm_1_3b").reduced()
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, tparams


def _close(t, j, tol=TOL, floor=1.0):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max()
    assert err <= tol * max(np.abs(j).max(), floor), err


def _states_close(tc, jc):
    """Every state leaf of both layers of the super-block, each stacked over
    the repeats."""
    for name, leaves in (("l0", MLSTM_LEAVES), ("l1", SLSTM_LEAVES)):
        assert set(tc[0][name]) == set(leaves)
        for leaf in leaves:
            assert tc[0][name][leaf].dtype == torch.float32
            _close(tc[0][name][leaf], jc[0][name][leaf])


def test_the_config_is_the_reduced_jax_one(model):
    jcfg, cfg, _, tparams = model
    assert cfg.num_layers == 4 and cfg.d_model == 64 and cfg.d_ff == 0
    assert [s.mixer for s in cfg.segments()[0].pattern] == ["mlstm", "slstm"]
    block = tparams["segments"][0][0]
    assert set(block["l0"]) == set(block["l1"]) == {"norm1", "mixer"}
    assert tuple(block["l1"]["mixer"]["r"].shape) == (4, 16, 64)
    assert tuple(block["l1"]["mixer"]["up_g"].shape) == (64, 128)   # ff 4/3 of 64, to 64


def _prefill_both(model, mode, toks):
    jcfg, cfg, params, tparams = model
    L = toks.shape[1]
    with repro.runtime(mode=mode):
        jl, jc = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg, JRUN,
                             cache_len=CACHE_LEN, true_len=jnp.asarray(L))
    with repro_torch.runtime(mode=mode), torch.inference_mode():
        tl, tc = lm.prefill(tparams, {"tokens": torch.from_numpy(toks).long()}, cfg, RUN,
                            cache_len=CACHE_LEN, true_len=L)
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
@pytest.mark.parametrize("length", [2, 8, 19, 37])
def test_prefill_matches_jax(model, mode, length):
    """Logits and every state leaf, a ragged last mLSTM chunk at 19 and 37."""
    toks = np.random.RandomState(length).randint(0, 256, (1, length)).astype(np.int32)
    (jl, jc), (tl, tc) = _prefill_both(model, mode, toks)
    _close(tl, jl)
    _states_close(tc, jc)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_three_decode_steps_at_vector_pos_match_jax(model, mode):
    """Two slots prefilled at different lengths, inserted into a pool, then
    three decode steps: the logits and the pool's state after each step."""
    jcfg, cfg, params, tparams = model
    lens = (21, 8)
    j_pool = jlm.init_cache(jcfg, 2, CACHE_LEN)
    t_pool = lm.init_cache(cfg, 2, CACHE_LEN, "cpu")
    for slot, L in enumerate(lens):
        toks = np.random.RandomState(L).randint(0, 256, (1, L)).astype(np.int32)
        (_, jc), (_, tc) = _prefill_both(model, mode, toks)
        j_pool = jlm.insert_cache(j_pool, jc, slot)
        lm.insert_cache(t_pool, tc, slot)
    _states_close(t_pool, j_pool)
    rs = np.random.RandomState(9)
    for step in range(3):
        tokens = rs.randint(0, 256, (2, 1)).astype(np.int32)
        pos = np.array(lens, np.int32) + step
        with repro.runtime(mode=mode):
            jl, j_pool = jlm.decode_step(params, jnp.asarray(tokens), j_pool,
                                         jnp.asarray(pos), jcfg, JRUN)
        with repro_torch.runtime(mode=mode), torch.inference_mode():
            tl, t_pool = lm.decode_step(tparams, torch.from_numpy(tokens).long(), t_pool,
                                        torch.from_numpy(pos).long(), cfg, RUN)
        _close(tl, jl)
        _states_close(t_pool, j_pool)


def test_decode_writes_every_layer_state_back_into_the_pool(model):
    _, cfg, _, tparams = model
    pool = lm.init_cache(cfg, 2, CACHE_LEN, "cpu")
    before = {(name, k): t.clone() for name, leaves in pool[0].items() for k, t in leaves.items()}
    with repro_torch.runtime(), torch.inference_mode():
        _, out = lm.decode_step(tparams, torch.tensor([[5], [6]]), pool, torch.tensor([0, 0]),
                                cfg, RUN)
    assert out is pool
    for (name, k), t in before.items():
        # each leaf of each repeat moved (n and m start at 0 and step away)
        for r in range(t.shape[0]):
            assert not torch.equal(pool[0][name][k][r], t[r]), (name, k, r)


def test_decode_dispatches_only_matmul_and_rmsnorm(model):
    _, cfg, _, tparams = model
    toks = torch.from_numpy(np.arange(13)[None]).long()
    with repro_torch.runtime() as rt, torch.inference_mode():
        _, caches = lm.prefill(tparams, {"tokens": toks}, cfg, RUN, cache_len=CACHE_LEN)
        lm.decode_step(tparams, toks[:, :1], caches, torch.tensor([13]), cfg, RUN)
    assert {k.split("|")[0] for k in rt.telemetry.by_key} == {"matmul", "rmsnorm"}
    assert set(rt.telemetry.tiers) == {"heuristic"}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _prompt(length: int, seed: int) -> np.ndarray:
    return np.random.RandomState(20_000 + 17 * length + seed).randint(0, 256, length).astype(
        np.int32)


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
    rs = np.random.RandomState(900 + case_seed)
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
    """One slot, two requests in turn: the second decodes as it would
    alone, though the first left its mLSTM and sLSTM state in the slot."""
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


def test_warmup_resolves_the_xlstm_sites(model):
    _, cfg, _, tparams = model
    resolved = _engine(cfg, tparams).warmup()
    assert {k.split("|")[0] for k in resolved} == {"matmul", "rmsnorm", "rmsnorm_matmul"}
    # at the pool's 3 rows: the sLSTM's MLP (ff = 128) and gate stack (4d),
    # the mLSTM's wq/wk/wv (di = 128) and out_proj
    for shapes in ("3x64/64x128", "3x128/128x64", "3x64/64x256", "3x128/128x128"):
        assert f"matmul|torch-cpu|{shapes}|float32" in resolved, shapes


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _batch(jcfg, seed=1):
    return JPipe(jcfg, JData(seed=seed, batch_size=2, seq_len=24)).next_batch()


def test_loss_and_every_gradient_leaf_match_jax_in_kernel_mode(model):
    jcfg, cfg, params, _ = model
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with repro.runtime(mode="kernel"):
        (j_loss, _), j_grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jb, jcfg, JRUN), has_aux=True)(params)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_()
    with repro_torch.runtime(mode="kernel") as rt:
        loss, _ = lm.loss_fn(tp, batch_to_tensors(batch, "cpu"), cfg, RUN)
        grads = torch.autograd.grad(loss, leaves)
    _close(loss, j_loss, TOL, floor=1e-6)
    names = [n for n, _ in adamw.named_leaves(tp)]
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads), cfg,
                                            device="cpu"))
    assert len(j_leaves) == len(grads) == len(names)
    assert sum(n.endswith("/mixer/r") for n in names) == 2
    for name, g, jg in zip(names, grads, j_leaves):
        _close(g, jg.numpy(), TOL_GRAD, floor=1e-6)
    snap = rt.telemetry.snapshot()
    bwd = {k.split("|")[0] for k in snap["by_key_phase"]["bwd"]}
    assert bwd == {"matmul", "rmsnorm_bwd", "softmax_xent_bwd"}
    assert "reference" not in snap["tiers"]


def test_two_trainer_steps_match_jax(model):
    jcfg, cfg, params, tparams = model
    opt = dict(lr=2e-3, warmup_steps=1, total_steps=2)
    data = dict(seed=4, batch_size=2, seq_len=24)
    jopt = jadamw.AdamWConfig(**opt)
    jstate, jp, pipe = jadamw.init(jopt, params), params, JPipe(jcfg, JData(**data))
    with repro.runtime(mode="reference"):
        step = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg, JRUN),
                                          has_aux=True))
        j_losses = []
        for _ in range(2):
            (loss, _), g = step(jp, {k: jnp.asarray(v) for k, v in pipe.next_batch().items()})
            jp, jstate, _ = jadamw.update(jopt, g, jstate, jp)
            j_losses.append(float(loss))
    fresh = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    trainer = Trainer(cfg, RUN, DataConfig(**data), adamw.AdamWConfig(**opt),
                      TrainerConfig(total_steps=2), runtime=repro_torch.runtime(),
                      device="cpu", params=fresh)
    metrics = trainer.train()
    np.testing.assert_allclose([m["loss"] for m in metrics], j_losses, rtol=TOL)
    j_leaves = adamw.leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                            device="cpu"))
    lr_sum = sum(m["lr"] for m in metrics)
    errs = sorted(np.abs(p.detach().numpy() - jl.numpy()).max()
                  for p, jl in zip(adamw.leaves(trainer.params), j_leaves))
    assert errs[len(errs) // 2] <= TOL_STEP_MEDIAN * lr_sum
    assert errs[-1] <= TOL_STEP_MAX * lr_sum


def test_remat_full_recomputes_the_same_gradients(model):
    jcfg, cfg, params, _ = model
    batch = batch_to_tensors(_batch(jcfg, seed=6), "cpu")
    grads = {}
    for remat in ("none", "full"):
        run = RunConfig(remat=remat, mlstm_chunk=8, loss_chunk=32)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
        tr = Trainer(cfg, run, DataConfig(batch_size=2, seq_len=24), device="cpu", params=tp,
                     runtime=repro_torch.runtime())
        grads[remat] = tr.loss_and_grads(batch)
    _close(grads["full"][0], grads["none"][0].numpy(), TOL, floor=1e-6)
    for a, b in zip(grads["full"][1], grads["none"][1]):
        _close(a, b.numpy(), TOL_GRAD, floor=1e-6)


def test_launchers_run_xlstm_on_the_cpu(capsys):
    train_launcher.main(["--arch", "xlstm_1_3b", "--smoke", "--steps", "2", "--device", "cpu",
                         "--batch", "2", "--seq", "16"])
    serve_launcher.main(["--arch", "xlstm_1_3b", "--smoke", "--device", "cpu", "--requests", "2",
                         "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "trained xlstm-1.3b on cpu: 2 steps of 2 x 16 tokens" in out and "phase bwd" in out
    assert "served 2 requests / 6 tokens on cpu" in out
