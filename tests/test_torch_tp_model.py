"""Tensor parallelism on the CPU, end to end: reduced qwen2_0_5b and
minitron_4b (fp32, two layers) on meshes with a tensor axis, against the
JAX package's one-device functions on the same parameters (GSPMD runs a
sharded program with the one-device program's meaning, so one device is
the reference of every case).

The ranks run once a world size, in module fixtures (``RANK_CODE``,
spawned by ``repro_torch.launch.mesh.spawn_ranks``: one torch thread each,
a ``FileStore`` under the test's temporary directory, never JAX, a
deadline), after the parent has carried JAX's parameters across. Two
ranks run ``1x2`` for both archs; four ranks run ``2x2`` (qwen2_0_5b,
data and tensor axes together, ``remat="dots"``) and ``1x4`` with
``head_aware`` True (k/v replicated: each rank picks the kv head its query
reads; ``remat="full"``) and False (the k/v projection's cut splits a
head: gathered by ``constrain_heads``); a remat recomputes a layer's
collectives, in the same order on every rank. Each
case: the prefill logits, the Trainer's step 1 (its loss, and its
gradients gathered over the tensor axis) and its parameters after two
AdamW steps, clipping included (step 1's global norm
is above ``grad_clip``). At ``1x2`` the ranks also serve staggered greedy
requests through ``ServingEngine(mesh=...)``, and qwen2_0_5b checkpoints
at steps 0 and 2 and restores.

Tolerances, those of ``test_torch_train`` and ``test_torch_dp_train``: the
same fp32 math, sums in another order (the row-parallel products summed
over ranks, the vocab-parallel lse): losses and logits 1e-5 relative, each
gradient leaf 1e-5 of its largest element, the parameters after two steps
1e-5 of the largest parameter.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipe  # noqa: E402
from repro.distributed.sharding import Layout as JLayout  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.campaign import planner  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

TOL = 1e-5
RANK_TIMEOUT_S = 150.0
SHAPE = SHAPES["train_smoke"]             # batch 8 x 64, the launcher's smoke step
DATA = dict(seed=4, batch_size=SHAPE.global_batch, seq_len=SHAPE.seq_len)
OPT = dict(lr=2e-3, warmup_steps=2, total_steps=3)
JRUN = JRun(remat="none", q_chunk=32, k_chunk=32, loss_chunk=32)
PROMPT = np.random.RandomState(7).randint(0, 256, 21)
SERVE = [(3, 6, 0), (17, 5, 1), (9, 7, 2), (12, 4, 3)]     # (prompt length, new tokens, seed)
ARCHS = ("qwen2_0_5b", "minitron_4b")
CASES = {2: [dict(name="qwen-1x2", arch="qwen2_0_5b", mesh="1x2", head_aware=False,
                  what=["steps", "serve", "ckpt"]),
             dict(name="minitron-1x2", arch="minitron_4b", mesh="1x2", head_aware=True,
                  what=["steps", "serve"])],
         4: [dict(name="qwen-2x2", arch="qwen2_0_5b", mesh="2x2", head_aware=False,
                  what=["steps"], remat="dots"),
             dict(name="qwen-1x4-aware", arch="qwen2_0_5b", mesh="1x4", head_aware=True,
                  what=["steps"], remat="full"),
             dict(name="qwen-1x4-naive", arch="qwen2_0_5b", mesh="1x4", head_aware=False,
                  what=["steps"])]}

RANK_CODE = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import repro_torch
from repro_torch.configs import SHAPES, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.defaults import default_layout, default_run
from repro_torch.launch.mesh import init_ranks, make_mesh_from_spec
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.serving.engine import EngineConfig, LockStepEngine, Request, ServingEngine
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.checkpoint import flatten_with_paths

out = sys.argv[1]
cases, data, opt, prompt, serve = (json.loads(a) for a in sys.argv[2:7])
env = init_ranks("gloo", store=os.path.join(out, "store"), timeout_s=100)
res, arrays = {}, {}


def whole(ts, like):
    # each leaf gathered over the tensor axis (a piece takes its parameter's cut)
    return [tp.gather_full(tp.mark(t.detach(), *tp.shard_info(p)) if tp.shard_info(p)
                           else t.detach()).numpy().copy() for t, p in zip(ts, like)]


for case in cases:
    name, cfg = case["name"], get_config(case["arch"]).reduced()
    run = dataclasses.replace(default_run(cfg, SHAPES["train_smoke"]),
                              remat=case.get("remat", "none"))
    layout = dataclasses.replace(default_layout(cfg), head_aware=case["head_aware"])
    mesh = make_mesh_from_spec(case["mesh"])
    fresh = lambda: torch.load(os.path.join(out, case["arch"] + ".pt"))
    rt = repro_torch.runtime(name=name)
    kw = dict(runtime=rt, device="cpu", mesh=mesh, layout=layout)
    tcfg = TrainerConfig(total_steps=3, checkpoint_every=100, async_checkpoint=False,
                         checkpoint_dir=os.path.join(out, "ck-" + name))
    tr = Trainer(cfg, run, DataConfig(**data), adamw.AdamWConfig(**opt), tcfg, params=fresh(),
                 **kw)
    r = {"local_params": sum(p.numel() for p in tr._leaves)}
    with torch.inference_mode(), rt, shd.mesh_context(mesh, layout):
        logits, _ = lm.prefill(tr.params, {"tokens": torch.tensor([prompt])}, cfg, run,
                               cache_len=32)
    arrays[name + "/logits"] = logits.numpy()
    if "ckpt" in case["what"]:
        tr.save_checkpoint()                                   # step 0
    kept = []
    compress = collectives.compress_grads

    def keep(grads, *a, **k):
        if not kept:
            kept.extend(g.detach().clone() for g in grads)
        return compress(grads, *a, **k)

    collectives.compress_grads = keep
    try:
        steps = [tr.run_one_step()]
        tr.check_replicas()
        r["keys"] = {ph: sorted(v) for ph, v in rt.telemetry.snapshot()["by_key_phase"].items()}
        if "steps" in case["what"]:
            steps.append(tr.run_one_step())
            tr.check_replicas()
    finally:
        collectives.compress_grads = compress
    r["steps"] = steps
    with shd.mesh_context(mesh, layout):
        for i, g in enumerate(whole(kept, tr._leaves)):
            arrays[f"{name}/grad/{i}"] = g
        for i, p in enumerate(whole(tr._leaves, tr._leaves)):
            arrays[f"{name}/param/{i}"] = p
    for i, p in enumerate(tr._leaves):
        arrays[f"{name}/piece/{i}"] = p.detach().numpy().copy()
    if "ckpt" in case["what"]:
        tr.save_checkpoint()                                   # step 2
        tr2 = Trainer(cfg, run, DataConfig(**data), adamw.AdamWConfig(**opt), tcfg,
                      params=fresh(), **kw)
        r["restored_step"] = tr2.restore_checkpoint()
        live, back = flatten_with_paths(tr._state_tree()), flatten_with_paths(tr2._state_tree())
        r["restored_differ"] = [p for (p, a), (_, b) in zip(live, back)
                                if not (torch.equal(a, b) if isinstance(a, torch.Tensor)
                                        else a == b)]
        r["step3"] = [tr.run_one_step()["loss"], tr2.run_one_step()["loss"]]
    if "serve" in case["what"]:
        srt = repro_torch.runtime(name=name + "-serve")
        eng = ServingEngine(cfg, run, fresh(), EngineConfig(max_batch=3, max_seq=64),
                            runtime=srt, mesh=mesh, layout=layout)
        for i, (n, new, seed) in enumerate(serve):
            p = np.random.RandomState(10_000 + 17 * n + seed).randint(0, 256, n).astype(np.int32)
            eng.submit(Request(prompt=p, max_new_tokens=new, seed=seed, arrival_time=float(i)))
        r["tokens"] = [q.output.tolist() for q in eng.serve()]
        r["serve_keys"] = sorted(srt.telemetry.snapshot()["by_key"])
        lock = LockStepEngine(cfg, run, fresh(), EngineConfig(max_batch=3, max_seq=64),
                              mesh=mesh, layout=layout)
        for i, (n, new, seed) in enumerate(serve):
            p = np.random.RandomState(10_000 + 17 * n + seed).randint(0, 256, n).astype(np.int32)
            lock.submit(Request(prompt=p, max_new_tokens=new, seed=seed))
        r["lockstep"] = [q.output.tolist() for q in lock.serve()]
    res[name] = r
np.savez(os.path.join(out, f"rank{env.rank}.npz"), **arrays)
with open(os.path.join(out, f"rank{env.rank}.json"), "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = j_get_config(arch).reduced()
        params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, get_config(arch).reduced(), params)
    return out


def _port_params(models, arch):
    _, cfg, params = models[arch]
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


def _spawn(world, models, tmp_path_factory):
    """(world, each rank's (results, arrays), the output directory)."""
    out = tmp_path_factory.mktemp(f"tp{world}")
    for arch in ARCHS:
        torch.save(_port_params(models, arch), out / f"{arch}.pt")
    results = spawn_ranks([sys.executable, "-c", RANK_CODE, str(out)]
                          + [json.dumps(a) for a in (CASES[world], DATA, OPT, PROMPT.tolist(),
                                                     SERVE)],
                          world, str(out / "logs"), RANK_TIMEOUT_S,
                          env={"PYTHONPATH": os.pathsep.join(sys.path)})
    for res in results:
        assert res.returncode == 0, f"rank {res.rank}: {res.returncode}\n{res.log[-4000:]}"
    outs = []
    for r in range(world):
        with open(out / f"rank{r}.json") as f:
            outs.append((json.load(f), dict(np.load(out / f"rank{r}.npz"))))
    return world, outs, out


@pytest.fixture(scope="module")
def ranks2(models, tmp_path_factory):
    return _spawn(2, models, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(models, tmp_path_factory):
    return _spawn(4, models, tmp_path_factory)


@pytest.fixture(params=sorted(CASES))
def ranks(request):
    """Each world's ranks in turn."""
    return request.getfixturevalue(f"ranks{request.param}")


_REFS = {}


def _jax_ref(models, arch):
    """JAX one device, reference mode: the prompt's prefill logits, step 1's
    loss and gradients on the global batch, and the losses and parameters
    (the port's leaf order) of two AdamW steps."""
    if arch not in _REFS:
        jcfg, cfg, params = models[arch]
        jopt = jadamw.AdamWConfig(**OPT)
        with repro.runtime(mode="reference"):
            logits, _ = jlm.prefill(params, {"tokens": jnp.asarray(PROMPT[None])}, jcfg, JRUN,
                                    cache_len=32)
            step = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg, JRUN),
                                              has_aux=True))
            jp, js = params, jadamw.init(jopt, params)
            pipe, losses, g1 = JPipe(jcfg, JData(**DATA)), [], None
            for _ in range(2):
                (loss, _), g = step(jp, {k: jnp.asarray(v) for k, v in pipe.next_batch().items()})
                g1 = g if g1 is None else g1
                jp, js, _ = jadamw.update(jopt, g, js, jp)
                losses.append(float(loss))
        leaves = lambda tree: [t.numpy() for t in adamw.leaves(
            from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu"))]
        _REFS[arch] = dict(logits=np.asarray(logits), losses=losses, grads=leaves(g1),
                           params=leaves(jp))
    return _REFS[arch]


def _cases(world):
    return CASES[world]


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol * max(np.abs(b).max(), 1e-6), err


def _arrays(arrays, prefix):
    n = sum(k.startswith(prefix + "/") for k in arrays)
    return [arrays[f"{prefix}/{i}"] for i in range(n)]


def test_prefill_logits_equal_jax_one_device(ranks, models):
    world, outs, _ = ranks
    for case in _cases(world):
        ref = _jax_ref(models, case["arch"])["logits"]
        for _, arrays in outs:
            _close(arrays[case["name"] + "/logits"], ref)     # every rank the whole vocabulary


def test_step1_loss_and_every_gradient_leaf_equal_jax(ranks, models):
    world, outs, _ = ranks
    for case in _cases(world):
        ref = _jax_ref(models, case["arch"])
        for res, arrays in outs:
            r = res[case["name"]]
            np.testing.assert_allclose(r["steps"][0]["loss"], ref["losses"][0], rtol=TOL)
            grads = _arrays(arrays, case["name"] + "/grad")
            assert len(grads) == len(ref["grads"]) > 0
            for g, j in zip(grads, ref["grads"]):
                _close(g, j)


def test_parameters_after_two_clipped_steps_equal_jax(ranks, models):
    world, outs, _ = ranks
    for case in _cases(world):
        if "steps" not in case["what"]:
            continue
        ref = _jax_ref(models, case["arch"])
        assert ref["losses"] and outs[0][0][case["name"]]["steps"][0]["grad_norm"] > 1.0
        scale = max(np.abs(p).max() for p in ref["params"])
        for res, arrays in outs:
            np.testing.assert_allclose([m["loss"] for m in res[case["name"]]["steps"]],
                                       ref["losses"], rtol=TOL)
            for i, (t, j) in enumerate(zip(_arrays(arrays, case["name"] + "/param"),
                                           ref["params"])):
                assert np.abs(t - j).max() <= TOL * scale, (case["name"], i)


def test_2x2_data_replicas_are_bit_identical_and_reduce_over_the_data_group(ranks4):
    """Ranks (0, m) and (1, m) hold the same pieces, bit for bit; the
    gradient reduce is the data group's: the rank's pieces' fp32 gradients
    and the loss, no more."""
    world, outs, _ = ranks4
    name = "qwen-2x2"
    for m in range(2):
        (ra, a), (rb, b) = outs[m], outs[2 + m]
        for x, y in zip(_arrays(a, name + "/piece"), _arrays(b, name + "/piece")):
            assert np.array_equal(x, y)
        for res in (ra, rb):
            r = res[name]
            assert all(s["allreduce_bytes"] == 4 * (r["local_params"] + 1) for s in r["steps"])
            assert all(s["model_bytes"] > 0 for s in r["steps"])
    # the two tensor ranks of a data row hold different pieces of a cut leaf
    assert not np.array_equal(_arrays(outs[0][1], name + "/piece")[0],
                              _arrays(outs[1][1], name + "/piece")[0])


def _solo_greedy_jax(models, arch):
    jcfg, _, params = models[arch]
    eng = jeng.ServingEngine(jcfg, JRUN, params, make_host_mesh(), JLayout(),
                             jeng.EngineConfig(max_batch=3, max_seq=64),
                             runtime=repro.runtime(mode="reference"))
    for i, (n, new, seed) in enumerate(SERVE):
        p = np.random.RandomState(10_000 + 17 * n + seed).randint(0, 256, n).astype(np.int32)
        eng.submit(jeng.Request(prompt=p, max_new_tokens=new, seed=seed, arrival_time=float(i)))
    return [r.output.tolist() for r in eng.serve()]


def test_engine_over_the_mesh_gives_the_jax_engines_greedy_tokens(ranks2, models):
    world, outs, _ = ranks2
    for case in _cases(world):
        want = _solo_greedy_jax(models, case["arch"])
        for res, _ in outs:
            assert res[case["name"]]["tokens"] == want


def test_lockstep_engine_over_the_mesh_gives_one_processs_tokens(ranks2, models):
    """The static batcher on 1x2 against the same batcher in one process
    (its left pads attended to, as in the reference)."""
    from repro_torch.launch.defaults import default_run
    from repro_torch.serving.engine import EngineConfig, LockStepEngine, Request

    world, outs, _ = ranks2
    for case in _cases(world):
        _, cfg, _ = models[case["arch"]]
        lock = LockStepEngine(cfg, default_run(cfg, SHAPES["train_smoke"]),
                              _port_params(models, case["arch"]),
                              EngineConfig(max_batch=3, max_seq=64))
        for n, new, seed in SERVE:
            p = np.random.RandomState(10_000 + 17 * n + seed).randint(0, 256, n).astype(np.int32)
            lock.submit(Request(prompt=p, max_new_tokens=new, seed=seed))
        want = [r.output.tolist() for r in lock.serve()]
        for res, _ in outs:
            assert res[case["name"]]["lockstep"] == want


def test_checkpoint_at_1x2_equals_one_processs_and_restores_on_both(ranks2, models, tmp_path):
    """The 1x2 trainer's step-0 checkpoint holds one process's files byte
    for byte; its step-2 checkpoint restores into a 1x2 trainer (every leaf
    equal, step 3 equal) and into a one-process trainer (the gathered
    parameters, bit for bit)."""
    world, outs, out = ranks2
    name, arch = "qwen-1x2", "qwen2_0_5b"
    _, cfg, _ = models[arch]
    from repro_torch.launch.defaults import default_run

    run = default_run(cfg, SHAPES["train_smoke"])
    one = Trainer(cfg, run, DataConfig(**DATA), adamw.AdamWConfig(**OPT),
                  TrainerConfig(total_steps=3, checkpoint_every=100, async_checkpoint=False,
                                checkpoint_dir=str(tmp_path / "one")),
                  device="cpu", params=_port_params(models, arch))
    one.save_checkpoint()
    tp_dir, one_dir = out / f"ck-{name}" / "step_000000000", tmp_path / "one" / "step_000000000"
    files = sorted(os.listdir(one_dir))
    assert sorted(os.listdir(tp_dir)) == files and "manifest.json" in files
    for f in files:
        if f == "manifest.json":
            a, b = (json.loads((d / f).read_text()) for d in (tp_dir, one_dir))
            assert a["leaves"] == b["leaves"]
        else:
            assert (tp_dir / f).read_bytes() == (one_dir / f).read_bytes(), f
    for res, _ in outs:
        r = res[name]
        assert r["restored_step"] == 2 and r["restored_differ"] == []
        assert r["step3"][0] == r["step3"][1]
    one.ckpt.directory = str(out / f"ck-{name}")
    assert one.restore_checkpoint() == 2
    for p, t in zip(one._leaves, _arrays(outs[0][1], name + "/param")):
        assert np.array_equal(p.detach().numpy(), t)


def test_planned_keys_hold_every_key_a_tensor_rank_dispatches(ranks2, models):
    """``plan_jobs(train_mesh="1x2")`` and the serving plan at 1x2 hold
    every key a rank's training step and serving run looked up (recorded
    through the runtimes' Telemetry)."""
    world, outs, _ = ranks2
    jobs = planner.plan_jobs(list(ARCHS), train_shapes=("train_smoke",), serving=(3, 64),
                             reduced=True, train_mesh="1x2", serving_mesh="1x2")
    planned = {j.db_key("torch-cpu") for j in jobs}
    for res, _ in outs:
        for case in _cases(world):
            r = res[case["name"]]
            seen = {k for ph in ("fwd", "bwd") for k in r["keys"].get(ph, ())}
            seen |= set(r["serve_keys"])
            # the plain path's decode attention is planned, not dispatched
            missing = sorted(k for k in seen - planned if not k.startswith("attn_chunks|"))
            assert not missing, missing
