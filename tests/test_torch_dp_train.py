"""Data-parallel training on the CPU: two gloo ranks of the port's Trainer
against the JAX package's one-device trainer on the same global batch, at
reduced qwen2_0_5b (fp32, two layers), and ``remat="dots"``.

The ranks run once, in a module fixture (``RANK_CODE``, spawned by
``repro_torch.launch.mesh.spawn_ranks``: one torch thread each, a
``FileStore`` under the test's temporary directory, never JAX, a
deadline), after the parent has carried JAX's parameters across and tuned
a campaign planned for a ``2x1`` mesh. Each rank trains:

* with no compression, on the campaign's database: step 1's dispatch tiers
  and keys, then two steps;
* with ``bf16`` and with ``int8_ef`` compression, two steps, the
  ``int8_ef`` trainer checkpointing at step 2; a fresh trainer restores
  that checkpoint and both take step 3.

Tolerances. No compression: losses 1e-5 relative (``test_torch_train``'s
TOL: the same fp32 math, the sums in another order: two halves of the
batch reduced across ranks), parameters after two steps 1e-5 of the
largest magnitude. With compression the reduced gradient and JAX's global
one differ by fp32 rounding, and an element near a rounding boundary of the
compression may land one step apart: one bf16 ulp (2**-8 of the element)
or one int8 step (the tensor's max over 127). Adam divides each moment by
its own rms, so one step apart moves an element's update by at most its
whole size: the bound is 2 lr a step (an update is at most lr in size,
and at most 2 lr apart) on the elements where the codes differ, which must
be few (at most 1e-3 of them), and 1e-5 of the largest magnitude
elsewhere; the losses stay at 1e-5 relative. ``int8_ef``'s scale is a JAX
tensor's, a segment's layers stacked, which the Trainer's scale groups
reproduce.
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
from repro.distributed import collectives as jcoll  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import defaults as jdefaults  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.campaign import planner, runner, scheduler  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.convert import batch_to_tensors, from_jax_params  # noqa: E402
from repro_torch.core.database import TuningDatabase  # noqa: E402
from repro_torch.core.evaluate import WallClockEvaluator  # noqa: E402
from repro_torch.core.platform import TORCH_CPU  # noqa: E402
from repro_torch.core.search import RandomSearch  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

JRUN = JRun(remat="none", q_chunk=16, k_chunk=16, loss_chunk=32)
RUN = RunConfig(q_chunk=16, k_chunk=16, loss_chunk=32)
DATA = dict(seed=4, batch_size=4, seq_len=32)
OPT = dict(lr=2e-3, warmup_steps=2, total_steps=3)
SHAPE = ShapeSpec("train_dp", DATA["seq_len"], DATA["batch_size"], "train")
TOL = 1e-5
RANK_TIMEOUT_S = 150.0

RANK_CODE = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import repro_torch
from repro_torch.configs import get_config
from repro_torch.core.database import TuningDatabase
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import init_ranks, make_mesh_from_spec
from repro_torch.models.transformer import RunConfig
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.checkpoint import flatten_with_paths

out = sys.argv[1]
env = init_ranks("gloo", store=os.path.join(out, "store"), timeout_s=100)
mesh = make_mesh_from_spec("2x1")
cfg = get_config("qwen2_0_5b").reduced()
run = RunConfig(q_chunk=16, k_chunk=16, loss_chunk=32)
data = DataConfig(**json.loads(sys.argv[2]))
opt = adamw.AdamWConfig(**json.loads(sys.argv[3]))
ckpt = os.path.join(out, "ckpt")


def trainer(mode, rt=None, **kw):
    return Trainer(cfg, run, data, opt, TrainerConfig(total_steps=2, grad_compression=mode, **kw),
                   runtime=rt, device="cpu", params=torch.load(os.path.join(out, "params.pt")),
                   mesh=mesh)


res, arrays = {}, {}
rt = repro_torch.runtime(db=TuningDatabase(os.path.join(out, "torch-cpu.db.json")))
tr = trainer("none", rt, checkpoint_every=100)
steps = [tr.run_one_step()]
snap = rt.telemetry.snapshot()
res["step1_phases"] = snap["phases"]
res["step1_keys"] = {ph: sorted(snap["by_key_phase"].get(ph, {})) for ph in ("fwd", "bwd")}
steps.append(tr.run_one_step())
res["none"] = steps
arrays.update({f"none/{i}": p.detach().numpy().copy()
               for i, p in enumerate(adamw.leaves(tr.params))})
for mode in ("bf16", "int8_ef"):
    kw = {"checkpoint_every": 2, "checkpoint_dir": ckpt, "async_checkpoint": False} \
        if mode == "int8_ef" else {"checkpoint_every": 100}
    tr = trainer(mode, **kw)
    res[mode] = tr.train()
    arrays.update({f"{mode}/{i}": p.detach().numpy().copy()
                   for i, p in enumerate(adamw.leaves(tr.params))})
# a fresh trainer restores the int8_ef checkpoint of step 2; both take step 3
tr2 = trainer("int8_ef", checkpoint_every=100, checkpoint_dir=ckpt)
res["restored_step"] = tr2.restore_checkpoint()
live, back = flatten_with_paths(tr._state_tree()), flatten_with_paths(tr2._state_tree())
res["state_paths"] = [p for p, _ in live]
res["restored_differ"] = [p for (p, a), (_, b) in zip(live, back)
                          if not (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)]
res["step3"] = [tr.run_one_step()["loss"], tr2.run_one_step()["loss"]]
tr.check_replicas()
res["ckpt_dirs"] = sorted(os.listdir(ckpt))
np.savez(os.path.join(out, f"rank{env.rank}.npz"), **arrays)
with open(os.path.join(out, f"rank{env.rank}.json"), "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config("qwen2_0_5b").reduced()
    cfg = get_config("qwen2_0_5b").reduced()
    params, _ = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, params


def _port_params(model):
    jcfg, cfg, params = model
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


@pytest.fixture(scope="module")
def ranks(model, tmp_path_factory):
    """Plan and tune a 2x1 campaign, then run the two ranks; (each rank's
    results, its parameter arrays, the planned keys)."""
    _, cfg, _ = model
    out = tmp_path_factory.mktemp("dp")
    torch.save(_port_params(model), out / "params.pt")
    jobs = planner.plan_training_jobs(cfg, SHAPE, mesh_axes="2x1", run=RUN)
    manifest = scheduler.build_manifest(jobs, total_budget=2 * len(jobs),
                                        path=str(out / "campaign.json"), profile=TORCH_CPU,
                                        min_budget=2, max_budget=2)
    db = TuningDatabase(str(out / "tuning.json"))
    runner.run_campaign(manifest, db, evaluator=WallClockEvaluator(1, 0),
                        search_factory=lambda j: RandomSearch(budget=2), device="cpu")
    runner.export_campaign_db(db, str(out / "torch-cpu.db.json"), "torch-cpu")
    results = spawn_ranks([sys.executable, "-c", RANK_CODE, str(out), json.dumps(DATA),
                           json.dumps(OPT)], 2, str(out / "logs"), RANK_TIMEOUT_S,
                          env={"PYTHONPATH": os.pathsep.join(sys.path)})
    for res in results:
        assert res.returncode == 0, f"rank {res.rank}: {res.returncode}\n{res.log[-4000:]}"
    outs = []
    for r in range(2):
        with open(out / f"rank{r}.json") as f:
            outs.append((json.load(f), dict(np.load(out / f"rank{r}.npz"))))
    return outs, {j.db_key("torch-cpu") for j in manifest.jobs}, jobs


_REFS = {}


def _jax_trainer(model, mode, steps):
    """JAX's one-device trainer, step for step: value_and_grad in reference
    mode on the global batch, compress_grads, adamw.update. (losses, the
    parameters in the port's leaf order)."""
    if (mode, steps) not in _REFS:
        jcfg, cfg, params = model
        jopt = jadamw.AdamWConfig(**OPT)
        jp, js = params, jadamw.init(jopt, params)
        ef = jcoll.ef_init(params) if mode == "int8_ef" else None
        pipe = JPipe(jcfg, JData(**DATA))
        losses = []
        with repro.runtime(mode="reference"):
            step = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg, JRUN),
                                              has_aux=True))
            for _ in range(steps):
                (loss, _), g = step(jp, {k: jnp.asarray(v) for k, v in pipe.next_batch().items()})
                g, ef = jcoll.compress_grads(g, ef, mode)
                jp, js, _ = jadamw.update(jopt, g, js, jp)
                losses.append(float(loss))
        leaves = [t.numpy() for t in adamw.leaves(
            from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu"))]
        _REFS[(mode, steps)] = (losses, leaves)
    return _REFS[(mode, steps)]


def _rank_params(arrays, mode):
    return [arrays[f"{mode}/{i}"] for i in range(sum(k.startswith(mode + "/") for k in arrays))]


def test_two_ranks_equal_jax_one_device_trainer(ranks, model):
    outs, _, _ = ranks
    j_losses, j_params = _jax_trainer(model, "none", 2)
    scale = max(np.abs(p).max() for p in j_params)
    for res, arrays in outs:
        np.testing.assert_allclose([m["loss"] for m in res["none"]], j_losses, rtol=TOL)
        t_params = _rank_params(arrays, "none")
        assert len(t_params) == len(j_params) == 2 * 12 + 3
        for t, j in zip(t_params, j_params):
            assert np.abs(t - j).max() <= TOL * scale
    # the replicas hold the same bits, and report the same global numbers
    (a, pa), (b, pb) = outs
    assert a["none"] == [{**m, "step_time_s": n["step_time_s"], "allreduce_s": n["allreduce_s"]}
                         for m, n in zip(b["none"], a["none"])]
    for mode in ("none", "bf16", "int8_ef"):
        for x, y in zip(_rank_params(pa, mode), _rank_params(pb, mode)):
            assert np.array_equal(x, y)
    # the step's reduce: every fp32 gradient and the loss
    n_params = sum(p.size for p in _rank_params(pa, "none"))
    assert a["none"][0]["allreduce_bytes"] == 4 * (n_params + 1)


@pytest.mark.parametrize("mode", ["bf16", "int8_ef"])
def test_two_ranks_with_compression_within_one_code_of_jax(ranks, model, mode):
    outs, _, _ = ranks
    j_losses, j_params = _jax_trainer(model, mode, 2)
    scale = max(np.abs(p).max() for p in j_params)
    lr_sum = sum(adamw.schedule(adamw.AdamWConfig(**OPT), s) for s in (1, 2))
    for res, arrays in outs:
        np.testing.assert_allclose([m["loss"] for m in res[mode]], j_losses, rtol=TOL)
        far = 0
        total = 0
        for t, j in zip(_rank_params(arrays, mode), j_params):
            d = np.abs(t - j)
            assert d.max() <= 2 * lr_sum, d.max()
            far += int((d > TOL * scale).sum())
            total += d.size
        assert far <= 1e-3 * total, (far, total)    # one code apart: a few elements


def test_rank_keys_equal_jax_local_keys_and_exact_hit_the_2x1_campaign(ranks, model):
    """Step 1 of a rank dispatches JAX's keys under mesh_context(dp_degree=2)
    on the same global batch, forward and backward (dL/dw's token dim
    included), every one an exact hit of the campaign planned for 2x1. The
    rank's database may also bank the fused SwiGLU gate
    (``matmul_bias_act``, where the campaign found it faster), a site JAX
    with no database never takes; its backward runs on the matmul keys."""
    outs, planned, _ = ranks
    jcfg, _, params = model
    batch = {k: jnp.asarray(v) for k, v in JPipe(jcfg, JData(**DATA)).next_batch().items()}
    with repro.runtime(mode="kernel") as rt, jshd.mesh_context(
            jmesh.make_host_mesh(), jdefaults.default_layout(jcfg), dp_degree=2):
        jax.value_and_grad(lambda p: jlm.loss_fn(p, batch, jcfg, JRUN), has_aux=True)(params)
    j_snap = rt.telemetry.snapshot()

    def strip(keys):
        return {"|".join(k.split("|")[:1] + k.split("|")[2:]) for k in keys}

    for res, _ in outs:
        assert set(res["step1_phases"]) == {"fwd", "bwd"}
        for phase in ("fwd", "bwd"):
            assert set(res["step1_phases"][phase]) == {"exact"}, res["step1_phases"]
            port, ref = strip(res["step1_keys"][phase]), strip(j_snap["by_key_phase"][phase])
            assert ref <= port and all(k.startswith("matmul_bias_act|") for k in port - ref)
            assert set(res["step1_keys"][phase]) <= planned
        # the unembed's dL/dw on a rank's 64 rows: x^T [d, 64] @ ct [64, vocab]
        assert "matmul|64x64/64x256|float32" in strip(res["step1_keys"]["bwd"])


def test_checkpoint_holds_ef_written_once_and_restores(ranks, model):
    outs, _, _ = ranks
    j_losses, _ = _jax_trainer(model, "int8_ef", 3)
    for res, _ in outs:
        assert res["ckpt_dirs"] == ["step_000000002"]        # rank 0 wrote it, once
        assert any(p.startswith("['ef']") for p in res["state_paths"])
        assert res["restored_step"] == 2 and res["restored_differ"] == []
        a, b = res["step3"]
        assert a == b
        np.testing.assert_allclose(a, j_losses[2], rtol=TOL)


def test_dp_rows_cover_each_microbatch_once(model):
    """Each data shard takes its rows of every microbatch, and the weights
    sum to one over the shards: the global mean, a loss mask included."""
    _, cfg, _ = model

    class _Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, shard):
            self.shard = shard
            self.mesh = torch.zeros(4, 1)

        def size(self):
            return 1     # one process stands for rank `shard` of 4: no collective

        def get_coordinate(self):
            return [self.shard, 0]

    batch = {"tokens": np.arange(8 * 3).reshape(8, 3), "labels": np.zeros((8, 3)),
             "loss_mask": (np.arange(8 * 3).reshape(8, 3) % 5 != 0).astype(np.float32)}
    run = RunConfig(microbatches=2)
    seen, weights = [], np.zeros(2)
    for s in range(4):
        tr = Trainer(cfg, run, DataConfig(batch_size=8, seq_len=3), device="cpu",
                     mesh=_Mesh(s))
        tr._dp = dataclasses.replace(tr._dp, ranks=4, replicas=1)
        assert (tr._dp.degree, tr._dp.shard) == (4, s)
        parts, w = tr.rank_rows(batch)
        assert [p["tokens"].shape[0] for p in parts] == [1, 1]
        seen += [int(p["tokens"][0, 0]) // 3 for p in parts]
        weights += np.array(w)
    assert sorted(seen) == list(range(8))
    np.testing.assert_allclose(weights, [0.5, 0.5])        # 1/k a microbatch


def _loss_and_grads(model, remat, mode, count=None):
    _, cfg, _ = model
    params = _port_params(model)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_()
    batch = batch_to_tensors(JPipe(model[0], JData(seed=6, batch_size=2, seq_len=32))
                             .next_batch(), "cpu")
    run = RunConfig(remat=remat, q_chunk=16, k_chunk=16, loss_chunk=32)
    packed = [0]

    def pack(t):
        packed[0] += 1
        return t

    with repro_torch.runtime(mode=mode):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = lm.loss_fn(params, batch, cfg, run)
        grads = torch.autograd.grad(loss, leaves)
    return loss, grads, packed[0]


@pytest.mark.parametrize("mode", ["reference", "kernel"])
def test_remat_dots_matches_none_and_saves_between_full_and_none(model, mode, monkeypatch):
    """``"dots"`` gives ``"none"``'s loss and gradients at the tolerance
    ``"full"`` is held to (test_torch_train). Saved tensors: those packed
    through ``saved_tensors_hooks`` outside a checkpoint, plus the outputs
    the selective policy keeps (torch holds those in the checkpoint's own
    storage, which saved-tensor hooks do not see), counted as the policy
    decides them in the forward."""
    kept = [0]
    policy = tf.dots_policy

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and out.name == "MUST_SAVE":
            kept[0] += 1
        return out

    monkeypatch.setattr(tf, "dots_policy", counting)
    counts = {}
    loss_n, grads_n, counts["none"] = _loss_and_grads(model, "none", mode)
    loss_f, _, counts["full"] = _loss_and_grads(model, "full", mode)
    loss_d, grads_d, packed = _loss_and_grads(model, "dots", mode)
    counts["dots"] = packed + kept[0]
    if mode == "reference":
        assert counts["full"] < counts["dots"] < counts["none"], counts
    else:
        # every matmul is a dispatched kernel, recomputed as JAX's checkpoint_dots
        # recomputes a pallas_call: nothing more kept than under "full"
        assert kept[0] == 0 and counts["full"] == counts["dots"] < counts["none"], counts
    for a, b in ((loss_d, loss_n), (loss_f, loss_n)):
        assert abs(a.item() - b.item()) <= TOL * abs(b.item())
    scale = max(float(g.abs().max()) for g in grads_n)
    for gd, gn in zip(grads_d, grads_n):
        assert float((gd - gn).abs().max()) <= TOL * scale


def test_train_launcher_on_a_host_mesh_with_compression(capsys, tmp_path):
    train_launcher.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "2", "--device", "cpu",
                         "--batch", "2", "--seq", "32", "--mesh", "1x1",
                         "--compression", "int8_ef", "--ckpt-every", "2",
                         "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "trained qwen2-0.5b on cpu: 2 steps of 2 x 32 tokens" in out
    assert "mesh 1x1, compression int8_ef" in out
    manifest = json.loads((tmp_path / "ck" / "step_000000002" / "manifest.json").read_text())
    assert any("['ef']" in leaf["path"] for leaf in manifest["leaves"])
