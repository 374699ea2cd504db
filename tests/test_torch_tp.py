"""Tensor parallelism on the CPU, its pieces: the autograd collectives, the
vocab-parallel embedding and cross entropy, the head plans, the specs and
the refusals.

The collectives run in gloo ranks spawned by
``repro_torch.launch.mesh.spawn_ranks`` (one torch thread each, a
``FileStore`` under the test's temporary directory, never JAX, a
deadline), at 2 and at 4 ranks on a ``1xT`` mesh; every rank draws the same
inputs from a numpy seed. The references are one process's computation and
JAX's ``softmax_xent`` Pallas kernels in interpret mode on the whole
logits, as JAX's own tests run them.

Tolerances. The collectives move fp32 and sum in fp32: a reduce of
integers-times-floats is exact to fp32 rounding, 1e-6 relative. The
vocab-parallel loss is a logsumexp of the ranks' fp32 lse's, against a
logsumexp over the whole row: 1e-6 relative (``test_torch_kernels``'s
fp32 cross entropy limit); its d_logits 1e-6 of the largest.
"""
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.kernels.xent import softmax_xent_bwd_pallas, softmax_xent_pallas  # noqa: E402
from repro.launch import defaults as jdefaults  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.launch import defaults, steps  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

TOL = 1e-6
RANK_TIMEOUT_S = 120.0
V, D, T = 64, 8, 12            # vocabulary, embedding width, loss rows

RANK_CODE = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.nn.functional as F
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import init_ranks, make_mesh_from_spec

out = sys.argv[1]
V, D, T = 64, 8, 12
env = init_ranks("gloo", store=os.path.join(out, "store"), timeout_s=60)
t = env.world_size
mesh = make_mesh_from_spec(f"1x{t}")
rs = np.random.RandomState(0)
x = torch.from_numpy(rs.randn(6, 8).astype(np.float32))
g = torch.from_numpy(rs.randn(6, 8).astype(np.float32))
table = torch.from_numpy(rs.randn(V, D).astype(np.float32))
tokens = torch.from_numpy(rs.randint(0, V, (2, 9)))
tokens[0, :4] = torch.tensor([0, V // t - 1, V // t, V - 1])       # shard edges
g_emb = torch.from_numpy(rs.randn(2, 9, D).astype(np.float32))
logits = torch.from_numpy((2 * rs.randn(T, V)).astype(np.float32))
labels = torch.from_numpy(rs.randint(0, V, T))
labels[:4] = torch.tensor([0, V // t - 1, V // t, V - 1])
mask = torch.from_numpy((rs.rand(T) > 0.3).astype(np.float32))
res = {}
with shd.mesh_context(mesh, shd.Layout()):
    ax = tp.model_axis()
    r = ax.index
    xi = x.clone().requires_grad_()
    y = tp.copy_to_model(xi)
    (y * g * (r + 1)).sum().backward()
    res["copy_fwd"], res["copy_bwd"] = y.detach(), xi.grad
    xi = (x * (r + 1)).requires_grad_()
    y = tp.reduce_from_model(xi)
    (y * g).sum().backward()
    res["reduce_fwd"], res["reduce_bwd"] = y.detach(), xi.grad
    w = 8 // t
    xi = x[:, r * w:(r + 1) * w].clone().requires_grad_()
    y = tp.gather_from_model(xi, 1)
    (y * g).sum().backward()
    res["gather_fwd"], res["gather_bwd"] = y.detach(), xi.grad
    xi = x.clone().requires_grad_()
    y = tp.scatter_to_model(xi, 1)
    (y * g[:, r * w:(r + 1) * w]).sum().backward()
    res["scatter_fwd"], res["scatter_bwd"] = y.detach(), xi.grad
    piece = tp.mark(table[r * (V // t):(r + 1) * (V // t)].clone(), 0, r, t).requires_grad_()
    e = tp.vocab_parallel_embed(piece, tokens)
    (e * g_emb).sum().backward()
    res["embed_fwd"], res["embed_bwd"] = e.detach(), piece.grad
    lp = logits[:, r * (V // t):(r + 1) * (V // t)].clone().requires_grad_()
    losses = tp.vocab_parallel_xent(lp, labels)
    ((losses * mask).sum() / mask.sum()).backward()
    res["xent"], res["xent_dl"] = losses.detach(), lp.grad
    res["stack"] = tp.stack_from_model(torch.full((3,), float(r)))
    piece = x[:, r * w:(r + 1) * w]
    res["constrain_keep"] = shd.constrain(piece, None, "model", full_shape=(6, 8))
    res["constrain_gather"] = shd.constrain(piece, None, None, full_shape=(6, 8))
    res["constrain_cut"] = shd.constrain(x, None, "model")
    res["heads_keep"] = shd.constrain_heads(piece, t, 1, full=8)         # one head a rank
    res["heads_gather"] = shd.constrain_heads(piece, 1, 1, full=8)      # a head split
np.savez(os.path.join(out, f"rank{env.rank}.npz"), **{k: v.numpy() for k, v in res.items()})
"""


@pytest.fixture(scope="module", params=[2, 4])
def ops(request, tmp_path_factory):
    """Each rank's results at ``request.param`` ranks, and the inputs."""
    t = request.param
    out = tmp_path_factory.mktemp(f"tp_ops{t}")
    results = spawn_ranks([sys.executable, "-c", RANK_CODE, str(out)], t, str(out / "logs"),
                          RANK_TIMEOUT_S, env={"PYTHONPATH": os.pathsep.join(sys.path)})
    for res in results:
        assert res.returncode == 0, f"rank {res.rank}: {res.returncode}\n{res.log[-4000:]}"
    rs = np.random.RandomState(0)
    x, g = rs.randn(6, 8).astype(np.float32), rs.randn(6, 8).astype(np.float32)
    table = rs.randn(V, D).astype(np.float32)
    tokens = rs.randint(0, V, (2, 9))
    tokens[0, :4] = [0, V // t - 1, V // t, V - 1]
    g_emb = rs.randn(2, 9, D).astype(np.float32)
    logits = (2 * rs.randn(T, V)).astype(np.float32)
    labels = rs.randint(0, V, T)
    labels[:4] = [0, V // t - 1, V // t, V - 1]
    mask = (rs.rand(T) > 0.3).astype(np.float32)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(t)]
    return t, ranks, dict(x=x, g=g, table=table, tokens=tokens, g_emb=g_emb, logits=logits,
                          labels=labels, mask=mask)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-6), np.abs(a - b).max()


def test_autograd_collectives_and_the_layout_hints_equal_one_process(ops):
    t, ranks, inp = ops
    x, g = inp["x"], inp["g"]
    w = 8 // t
    total = t * (t + 1) / 2
    for r, res in enumerate(ranks):
        _close(res["copy_fwd"], x)
        _close(res["copy_bwd"], g * total)          # the ranks' gradients summed
        _close(res["reduce_fwd"], x * total)
        _close(res["reduce_bwd"], g)
        _close(res["gather_fwd"], x)
        _close(res["gather_bwd"], g[:, r * w:(r + 1) * w])
        _close(res["scatter_fwd"], x[:, r * w:(r + 1) * w])
        _close(res["scatter_bwd"], g)
        assert res["stack"].tolist() == [[float(i)] * 3 for i in range(t)]
        # the hints: a cut the spec keeps stays; one it replicates is gathered;
        # a whole dim the spec cuts is cut; a head split is gathered
        piece = x[:, r * w:(r + 1) * w]
        _close(res["constrain_keep"], piece)
        _close(res["constrain_gather"], x)
        _close(res["constrain_cut"], piece)
        _close(res["heads_keep"], piece)
        _close(res["heads_gather"], x)


def test_vocab_parallel_embedding_equals_one_lookup(ops):
    t, ranks, inp = ops
    table = torch.from_numpy(inp["table"]).requires_grad_()
    e = torch.nn.functional.embedding(torch.from_numpy(inp["tokens"]), table)
    (e * torch.from_numpy(inp["g_emb"])).sum().backward()
    vl = V // t
    for r, res in enumerate(ranks):
        assert np.array_equal(res["embed_fwd"], e.detach().numpy())    # one nonzero row a sum
        _close(res["embed_bwd"], table.grad.numpy()[r * vl:(r + 1) * vl])


def test_vocab_parallel_xent_equals_jax_and_cross_entropy(ops):
    """Labels on every shard and on shard edges, a loss mask: the rows'
    losses against JAX's kernel on the whole row and ``F.cross_entropy``,
    the ranks' d_logits together against JAX's backward kernel with the
    masked mean's cotangent."""
    t, ranks, inp = ops
    logits, labels, mask = inp["logits"], inp["labels"], inp["mask"]
    j_loss, j_lse = softmax_xent_pallas(jnp.asarray(logits), jnp.asarray(labels, jnp.int32),
                                        block_rows=4, block_v=32, interpret=True,
                                        return_residuals=True)
    ct = mask / mask.sum()
    j_dl = softmax_xent_bwd_pallas(jnp.asarray(ct), jnp.asarray(logits),
                                   jnp.asarray(labels, jnp.int32), j_lse, block_rows=4,
                                   block_v=32, interpret=True)
    ce = torch.nn.functional.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                           reduction="none")
    dl = np.concatenate([res["xent_dl"] for res in ranks], axis=1)
    for res in ranks:
        _close(res["xent"], np.asarray(j_loss))
        _close(res["xent"], ce.numpy())
    _close(dl, np.asarray(j_dl))


@pytest.mark.parametrize("heads,kv,t,aware", [(14, 2, 2, True), (4, 2, 4, True),
                                               (4, 2, 4, False), (24, 8, 2, False)])
def test_head_plans_cover_each_query_heads_kv_once(heads, kv, t, aware):
    """Every rank's query heads read kv heads its attention holds; the
    ranks' query heads tile the heads in order."""
    hd, d = 16, 64
    sizes = {"data": 1, "model": t}
    layout = shd.Layout(counts=(("heads", heads), ("kv_heads", kv)), head_aware=aware)
    cut = lambda name, n: shd.spec_for_dims(("d_model", name), (d, n * hd), sizes,
                                            layout) != shd.P()
    covered = []
    for r in range(t):
        plan = tp.head_plan(heads, kv, cut("heads", heads), cut("kv_heads", kv), t, r)
        q = list(range(plan.q_lo, plan.q_lo + plan.q_n))
        covered += q
        kv_heads = (list(range(r * plan.kv_n, (r + 1) * plan.kv_n)) if plan.kv_local
                    else list(plan.kv_pick) if plan.kv_pick is not None else list(range(kv)))
        group = plan.q_n // plan.kv_n
        for i, h in enumerate(q):
            assert kv_heads[i // group] == h // (heads // kv)
    assert covered == list(range(heads)) or covered == list(range(heads)) * t


def _jax_specs(jcfg, sizes, jlayout):
    """JAX's param specs, each stacked segment leaf's leading ``layers``
    dim dropped (the port unstacks it; no rule shards it)."""
    jm = types.SimpleNamespace(axis_names=tuple(sizes),
                               devices=np.empty(tuple(sizes.values()), dtype=np.int8))
    jabs, jaxes = jlm.abstract_params(jcfg)
    out = {}

    def walk(ax, leaf, path):
        if isinstance(ax, tuple) and all(isinstance(a, str) for a in ax):
            spec = tuple(jshd.spec_for_dims(ax, leaf.shape, jm, jlayout))
            if ax[0] == "layers":
                spec = spec[1:] if spec else ()
            out[path] = spec
        else:
            for k in (ax if isinstance(ax, dict) else range(len(ax))):
                walk(ax[k], leaf[k], f"{path}/{k}")

    walk(jaxes, jabs, "")
    return out


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "minitron_4b"])
@pytest.mark.parametrize("mesh_spec", ["1x2", "16x16"])
def test_param_and_cache_specs_equal_jax_and_the_port_cache_follows_the_heads(arch, mesh_spec):
    """``param_shardings`` and ``cache_shardings`` give JAX's specs at full
    size. The port's cache departs by design: JAX's ``cache_shardings``
    gives the tensor axis to the largest divisible dim, the cache length
    (dim 2 of [layers, batch, len, kv, hd]: sequence parallelism of the
    cache), where a rank's cache (``Cell.rank_cache_specs``) holds the kv
    heads its attention computes: cut on dim 3 where its k/v projections
    hold whole heads, else the heads its queries read of whole k and v."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    sizes = dict(zip(("data", "model"), (int(d) for d in mesh_spec.split("x"))))
    layout, jlayout = defaults.default_layout(cfg), jdefaults.default_layout(jcfg)
    want = _jax_specs(jcfg, sizes, jlayout)
    specs = lm.param_specs(cfg, sizes, layout)
    got = {}
    for name, spec in spec_named(specs):
        parts = name.split("/")
        key = ("/".join(parts[:3] + parts[4:]) if parts[1] == "segments" else name)
        got.setdefault(key, set()).add(tuple(spec))
    assert {k: {v} for k, v in want.items()} == got
    # the caches
    shape = ShapeSpec("serve_decode", 2048, 8, "decode")      # the engine's pool
    devs = np.array(jax.devices() * int(np.prod(list(sizes.values()))))
    jm = jax.sharding.Mesh(devs.reshape(tuple(sizes.values())), ("data", "model"))
    j_cache = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        jshd.cache_shardings(jlm.cache_specs(jcfg, shape.global_batch, shape.seq_len), jm,
                             jlayout))]
    cell = steps.build_cell(cfg, shape, sizes, layout, RunConfig())
    port = [tuple(s) for s in jax.tree_util.tree_leaves(
        cell.in_specs[1], is_leaf=lambda x: isinstance(x, shd.PartitionSpec))]
    assert port == j_cache and j_cache
    plan = tp.spec_plan(cfg, sizes, layout)
    k_jax, k_rank = cell.in_specs[1][0]["l0"]["k"], cell.rank_cache_specs[0]["l0"]["k"]
    assert k_jax[2] == "model"                      # JAX: the cache length
    if plan.kv_local:
        assert k_rank == shd.P(None, None, None, "model")        # the port: the kv heads
    else:
        assert k_rank == shd.P() and (plan.kv_pick is not None or plan.kv_n == cfg.num_kv_heads)
    assert cell.abstract_inputs[1][0]["l0"]["k"].shape[3] == plan.kv_n


def test_trainer_and_engine_refuse_what_the_port_does_not_run():
    """On a tensor axis of more than one rank: experts, recurrent mixers and
    frontends; FSDP over a data axis; serving with a data axis."""

    class _Mesh:
        def __init__(self, sizes):
            self.mesh_dim_names = tuple(sizes)
            self.mesh = torch.zeros(tuple(sizes.values()))

        def size(self):
            return self.mesh.numel()

        def get_coordinate(self):
            return [0] * self.mesh.dim()

    data = DataConfig(batch_size=4, seq_len=8)
    for arch, sizes, what in (("mixtral_8x7b", {"data": 1, "model": 2}, "experts"),
                              ("jamba_1_5_large", {"data": 1, "model": 2}, "experts"),
                              ("xlstm_1_3b", {"data": 1, "model": 2}, "recurrent"),
                              ("paligemma_3b", {"data": 1, "model": 2}, "frontend"),
                              ("gemma3_27b", {"data": 2, "model": 1}, "FSDP")):
        cfg = get_config(arch).reduced()
        with pytest.raises(NotImplementedError, match=what):
            Trainer(cfg, RunConfig(), data, device="cpu", mesh=_Mesh(sizes))
    cfg = get_config("qwen2_0_5b").reduced()
    with pytest.raises(NotImplementedError, match="data axis"):
        ServingEngine(cfg, RunConfig(), lm.init_params(cfg, 0, "cpu"),
                      mesh=_Mesh({"data": 2, "model": 1}))


def test_shard_of_cuts_and_init_params_draws_the_same_numbers():
    cfg = get_config("qwen2_0_5b").reduced()
    full = lm.init_params(cfg, 3, "cpu")

    class _Rank:
        def __init__(self, r):
            self.mesh_dim_names = ("data", "model")
            self.mesh = torch.zeros(1, 2)
            self.r = r

        def get_coordinate(self):
            return [0, self.r]

    layout = defaults.default_layout(cfg)
    specs = [sp for _, sp in spec_named(lm.param_specs(cfg, {"data": 1, "model": 2}, layout))]
    for r in range(2):
        mine = lm.init_params(cfg, 3, "cpu", mesh=_Rank(r), layout=layout)
        for (n, p), f, spec in zip(lm_named(mine), lm_leaves(full), specs):
            assert torch.equal(p, shd.shard_of(f, spec, {"data": 1, "model": 2},
                                               {"data": 0, "model": r})), n
            info = tp.shard_info(p)
            assert (info is None) == (spec == shd.P() or "model" not in tuple(spec))
            if info is not None:
                assert tp.global_shape(p) == tuple(f.shape)


def lm_named(tree):
    from repro_torch.optim import adamw

    return adamw.named_leaves(tree)


def spec_named(tree, prefix=""):
    """(path, spec) of a spec tree in ``adamw.named_leaves``'s order."""
    if isinstance(tree, shd.PartitionSpec):
        return [(prefix, tree)]
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    return [leaf for k, v in items for leaf in spec_named(v, f"{prefix}/{k}")]


def lm_leaves(tree):
    from repro_torch.optim import adamw

    return adamw.leaves(tree)


def test_build_cell_gives_a_ranks_local_inputs():
    cfg = get_config("qwen2_0_5b")
    layout = defaults.default_layout(cfg)
    sizes = {"data": 1, "model": 2}
    train = steps.build_cell(cfg, SHAPES["train_2k"], sizes, layout, RunConfig())
    params = train.abstract_inputs[0]
    assert params["embed"]["table"].shape == (cfg.vocab_size // 2, cfg.d_model)
    assert params["lm_head"]["w"].shape == (cfg.d_model, cfg.vocab_size // 2)
    layer = params["segments"][0][0]["l0"]
    assert layer["mixer"]["q"]["w"].shape == (cfg.d_model, cfg.num_heads * cfg.hd // 2)
    assert layer["mixer"]["o"]["w"].shape == (cfg.num_heads * cfg.hd // 2, cfg.d_model)
    assert layer["ffn"]["wd"].shape == (cfg.d_ff // 2, cfg.d_model)
    assert layer["norm1"]["scale"].shape == (cfg.d_model,)
    assert train.kind == "train" and train.abstract_inputs[2]["tokens"].shape[0] == \
        SHAPES["train_2k"].global_batch
    w = tp.rank_widths(cfg, sizes, layout)
    assert w == {"q": 448, "kv": 64, "o": 448, "ff": 2432, "vocab": 75968, "heads": 7,
                 "kv_heads": 1}


def test_make_train_step_is_the_trainers_step():
    """JAX's ``train_step(params, opt_state, batch)`` signature over the same
    gradient step the Trainer takes: one step from the same parameters and
    batch gives the Trainer's loss and parameters, bit for bit."""
    from repro_torch.convert import batch_to_tensors
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.optim import adamw
    from repro_torch.train import TrainerConfig

    cfg = get_config("qwen2_0_5b").reduced()
    run = RunConfig(q_chunk=16, k_chunk=16, loss_chunk=16, microbatches=2)
    data = DataConfig(seed=2, batch_size=4, seq_len=16)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    tr = Trainer(cfg, run, data, opt, TrainerConfig(total_steps=1), device="cpu",
                 params=lm.init_params(cfg, 1, "cpu"))
    batch = batch_to_tensors(SyntheticPipeline(cfg, data).next_batch(), "cpu")   # its first
    want = tr.run_one_step()
    params = lm.init_params(cfg, 1, "cpu")
    for p in lm_leaves(params):
        p.requires_grad_(True)
    state = adamw.init(opt, params)
    step = steps.make_train_step(cfg, run, opt)
    params, state, metrics = step(params, state, batch)
    assert float(metrics["loss"]) == want["loss"] and state["step"] == 1
    for a, b in zip(lm_leaves(params), tr._leaves):
        assert torch.equal(a.detach(), b.detach())
