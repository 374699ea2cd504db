"""The port's collectives against the JAX package's, on the CPU.

* ``compress_grads`` and ``ef_init`` against ``repro.distributed.
  collectives`` on the same numpy gradients: the int8 codes equal, every
  other output within 1e-6 (the same fp32 arithmetic).
* ``ring_all_reduce``, ``reduce_grads`` and the min / max ``all_reduce``
  over 4 gloo ranks against the numpy sum, min and max: within 1e-4 of the
  sum's magnitude (JAX's ring test's bound), the bytes each counted by kind.
  The ranks are spawned once, in a module fixture, with
  ``repro_torch.launch.mesh.spawn_ranks``; each sets one torch thread,
  meets at a ``FileStore`` under the test's temporary directory (no TCP
  port, so parallel test workers cannot collide), never imports JAX (it
  runs ``RANK_CODE``, which imports torch and the port only), and has a
  deadline, so a hang fails the fixture instead of the whole run.
* The cost model's collective term against JAX's ``analytic_roofline`` for
  the same bytes and interconnect rate, and ``collective_stats`` from the
  counts.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.platform import HardwareProfile as JProfile  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro.tools import analytic as janalytic  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.evaluate import collective_stats  # noqa: E402
from repro_torch.core.platform import H100_PCIE, H100_SXM  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.tools import analytic  # noqa: E402

WORLD = 4
SIZES = (37, 1000, 4096)          # not a multiple of 4, and two that are
RANK_TIMEOUT_S = 120.0

# One rank's work: its rows from a seed, the ring at each size, the bucketed
# gradient reduce (buckets small enough to make several) and min / max.
RANK_CODE = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import init_ranks

out_dir, sizes = sys.argv[1], [int(s) for s in sys.argv[2].split(",")]
env = init_ranks("gloo", store=os.path.join(out_dir, "store"), timeout_s=60)
r = env.rank
rows = {d: np.random.default_rng(100 * d + r).standard_normal(d).astype(np.float32)
        for d in sizes}
res = {}
for d in sizes:
    collectives.reset_collective_counts()
    res[f"ring{d}"] = collectives.ring_all_reduce(torch.from_numpy(rows[d])).numpy()
    res[f"ring{d}_bytes"] = np.array(collectives.COLLECTIVE_BYTES["collective-permute"])
    res[f"ring{d}_hops"] = np.array(collectives.COLLECTIVE_CALLS["collective-permute"])
grads = [torch.from_numpy(rows[d].copy()) for d in sizes]
collectives.reset_collective_counts()
collectives.reduce_grads(grads, scale=0.5, bucket_bytes=4 * 1100)
res["reduce_calls"] = np.array(collectives.COLLECTIVE_CALLS["all-reduce"])
res["reduce_bytes"] = np.array(collectives.COLLECTIVE_BYTES["all-reduce"])
for d, g in zip(sizes, grads):
    res[f"reduce{d}"] = g.numpy()
x = torch.tensor([r, -r, 7], dtype=torch.int64)
res["min"] = collectives.all_reduce(x.clone(), "min").numpy()
res["max"] = collectives.all_reduce(x.clone(), "max").numpy()
np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring"))
    results = spawn_ranks([sys.executable, "-c", RANK_CODE, out, ",".join(map(str, SIZES))],
                          WORLD, os.path.join(out, "logs"), RANK_TIMEOUT_S,
                          env={"PYTHONPATH": os.pathsep.join(sys.path)})
    for res in results:
        assert res.returncode == 0, f"rank {res.rank}: {res.returncode}\n{res.log[-3000:]}"
    rows = {d: [np.random.default_rng(100 * d + r).standard_normal(d).astype(np.float32)
                for r in range(WORLD)] for d in SIZES}
    return rows, [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(WORLD)]


@pytest.mark.parametrize("d", SIZES)
def test_ring_all_reduce_equals_the_sum_on_every_rank(ranks, d):
    rows, outs = ranks
    want = np.sum(rows[d], axis=0)
    chunk = -(-d // WORLD)
    for out in outs:
        got = out[f"ring{d}"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
        # n - 1 reduce-scatter and n - 1 all-gather hops of one padded chunk
        assert int(out[f"ring{d}_hops"]) == 2 * (WORLD - 1)
        assert int(out[f"ring{d}_bytes"]) == 2 * (WORLD - 1) * chunk * 4


def test_bucketed_gradient_reduce_sums_the_scaled_gradients(ranks):
    rows, outs = ranks
    for out in outs:
        for d in SIZES:
            want = 0.5 * np.sum(rows[d], axis=0)
            assert np.abs(out[f"reduce{d}"] - want).max() <= 1e-4 * np.abs(want).max()
        # 37 + 1000 floats fit a 1100-float bucket; 4096 makes one of its own
        assert int(out["reduce_calls"]) == 2
        assert int(out["reduce_bytes"]) == 4 * sum(SIZES)


def test_min_and_max_all_reduce(ranks):
    _, outs = ranks
    for out in outs:
        assert out["min"].tolist() == [0, -(WORLD - 1), 7]
        assert out["max"].tolist() == [WORLD - 1, 0, 7]


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((17, 9))).astype(np.float32),
            "b": [(scale * rng.standard_normal(33)).astype(np.float32),
                  np.zeros(5, np.float32)]}


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_ef_init_matches_jax():
    g = _grads(0)
    t, j = _flat(collectives.ef_init(_to_torch(g))), _flat(jcoll.ef_init(g))
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape and not a.any()


@pytest.mark.parametrize("mode", ["none", "bf16", "int8_ef"])
def test_compress_grads_matches_jax_over_three_steps(mode):
    """Three steps, the residual carried: int8 codes equal, the rest within
    1e-6. The third step's gradients are tiny, so the residual dominates."""
    ef_t = collectives.ef_init(_to_torch(_grads(0)))
    ef_j = jcoll.ef_init(_grads(0))
    for step, scale in enumerate((1.0, 3.0, 1e-3)):
        g = _grads(step + 1, scale)
        out_t, ef_t = collectives.compress_grads(_to_torch(g), ef_t, mode)
        out_j, ef_j = jcoll.compress_grads(jax.tree_util.tree_map(jnp.asarray, g), ef_j, mode)
        for a, b in zip(_flat(out_t), _flat(out_j)):
            a = a.numpy()
            assert a.dtype == np.asarray(b).dtype
            assert np.abs(a - np.asarray(b)).max() <= 1e-6 * max(1.0, np.abs(b).max())
        if mode == "int8_ef":
            for a, b in zip(_flat(ef_t), _flat(ef_j)):
                assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6
    if mode == "int8_ef":
        x = np.random.default_rng(9).standard_normal(257).astype(np.float32)
        q_t, s_t = collectives._quant_int8(torch.from_numpy(x))
        q_j, s_j = jcoll._quant_int8(jnp.asarray(x))
        assert q_t.dtype == torch.int8 and np.array_equal(q_t.numpy(), np.asarray(q_j))
        assert float(s_t) == pytest.approx(float(s_j), rel=1e-6)


def test_int8_scale_groups_equal_jax_on_the_stacked_tensor():
    """JAX stacks a segment's layers into one tensor; the port's layers are
    leaves of their own, which ``scale_groups`` gives the stacked tensor's
    one scale: codes, outputs and residuals equal JAX's."""
    rng = np.random.default_rng(3)
    stacked = np.stack([rng.standard_normal((17, 9)), 0.01 * rng.standard_normal((17, 9))]
                       ).astype(np.float32)
    other = rng.standard_normal(33).astype(np.float32)
    out_j, ef_j = jcoll.compress_grads({"s": jnp.asarray(stacked), "o": jnp.asarray(other)},
                                       jcoll.ef_init({"s": stacked, "o": other}), "int8_ef")
    leaves = [torch.from_numpy(stacked[0].copy()), torch.from_numpy(stacked[1].copy()),
              torch.from_numpy(other)]
    out_t, ef_t = collectives.compress_grads(leaves, collectives.ef_init(leaves), "int8_ef",
                                             scale_groups=[[0, 1], [2]])
    for t, j in ((torch.stack(out_t[:2]), out_j["s"]), (out_t[2], out_j["o"]),
                 (torch.stack(ef_t[:2]), ef_j["s"]), (ef_t[2], ef_j["o"])):
        assert np.abs(t.numpy() - np.asarray(j)).max() <= 1e-6
    # a scale a layer would quantise the small layer more finely than JAX does
    alone, _ = collectives.compress_grads(leaves, collectives.ef_init(leaves), "int8_ef")
    assert np.abs(alone[1].numpy() - np.asarray(out_j["s"][1])).max() > 1e-6


def test_unknown_compression_mode_raises():
    with pytest.raises(ValueError):
        collectives.compress_grads(_to_torch(_grads(0)), None, "fp8")


@pytest.mark.parametrize("profile", [H100_SXM, H100_PCIE], ids=lambda p: p.name)
def test_collective_term_matches_jax_at_the_same_bytes_and_rate(profile):
    cfg, jcfg = get_config("qwen2_0_5b"), jbase.get_config("qwen2_0_5b")
    shape, jshape = ShapeSpec("train_2k", 2048, 4, "train"), jbase.ShapeSpec(
        "train_2k", 2048, 4, "train")
    kinds = {"all-reduce": 1.976e9, "collective-permute": 3.0e6, "all-gather": 5.0e5}
    jprof = JProfile(name=profile.name, peak_flops_bf16=profile.peak_flops_bf16,
                     hbm_bandwidth=profile.hbm_bandwidth,
                     ici_bandwidth=profile.interconnect_bandwidth,
                     hbm_bytes=profile.hbm_bytes, vmem_bytes=profile.smem_per_block)
    t = analytic.analytic_roofline(cfg, shape, chips=2, collective_bytes_by_kind=kinds,
                                   profile=profile)
    j = janalytic.analytic_roofline(jcfg, jshape, 2, kinds, model_par=1, remat="none",
                                    profile=jprof)
    assert t.collective_bytes_per_chip == pytest.approx(j.collective_bytes_per_chip, rel=1e-12)
    assert t.collective_s == pytest.approx(j.collective_s, rel=1e-12)
    assert t.collective_s == pytest.approx(
        (2 * 1.976e9 + 3.0e6 + 5.0e5) / profile.interconnect_bandwidth, rel=1e-12)


def test_collective_stats_reads_the_counts():
    counts = {"bytes_by_kind": {"all-reduce": 400, "collective-permute": 48},
              "calls_by_kind": {"all-reduce": 2, "collective-permute": 6}}
    stats = collective_stats(counts)
    assert stats == {"bytes_by_kind": counts["bytes_by_kind"], "total_bytes": 448, "count": 8}
    collectives.reset_collective_counts()
    assert collective_stats()["total_bytes"] == 0
    # the shape of JAX's record, the HLO parser's
    assert set(stats) == {"bytes_by_kind", "total_bytes", "count"}
    json.dumps(stats)
