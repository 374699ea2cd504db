"""The port's checkpointer (``repro_torch.train.checkpoint``): the
counterparts of ``tests/test_checkpoint.py`` and of
``tests/test_chaos.py``'s async write failure, and the on-disk format held
against ``repro.train.checkpoint``: one tree of fp32, int32 and bf16
leaves gives equal manifests and equal ``.npy`` bytes in both packages.

The JAX package is imported inside the parity test only, so the
``gpu``-marked case runs on a card's host without jax.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core

from repro_torch.testing import FaultPlan, FaultRule  # noqa: E402
from repro_torch.train.checkpoint import _COMMIT_MARK, Checkpointer  # noqa: E402


def tree(seed=0, device="cpu"):
    rs = np.random.RandomState(seed)
    return {
        "a": torch.from_numpy(rs.randn(4, 8).astype(np.float32)).to(device),
        "nested": {"b": torch.from_numpy(rs.randn(3).astype(np.float32)).to(device,
                                                                           torch.bfloat16),
                   "list": [torch.arange(5, dtype=torch.int32, device=device)],
                   "step": 7},
    }


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())
    else:
        assert type(a) is type(b) and a == b


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = tree()
    ck.save(3, t)
    assert ck.all_steps() == [3]
    assert_tree_equal(t, ck.restore(3, tree(seed=1)))


def test_async_save_copies_before_it_returns(tmp_path):
    """The host copy is taken before save_async returns: mutating the
    tensors in place afterwards (as the next AdamW step does) does not
    reach the checkpoint."""
    ck = Checkpointer(str(tmp_path))
    t = tree()
    want = tree()
    ck.save_async(1, t)
    t["a"].add_(1.0)
    t["nested"]["b"].mul_(2)
    ck.wait()
    assert ck.latest_step() == 1
    assert_tree_equal(want, ck.restore(1, t))


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, tree())
    # a crash mid-save: a directory without the commit mark
    broken = tmp_path / "step_000000009"
    shutil.copytree(tmp_path / "step_000000005", broken)
    os.unlink(broken / _COMMIT_MARK)
    assert ck.all_steps() == [5]
    assert ck.latest_step() == 5


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    path = ck.save(2, tree())
    leaf = os.path.join(path, "leaf_00000.npy")
    arr = np.load(leaf)
    flipped = arr.view(np.uint8).copy()
    flipped[-1] ^= 0xFF
    np.save(leaf, flipped.view(arr.dtype).reshape(arr.shape))
    with pytest.raises(ValueError, match="crc|corrupt"):
        ck.restore(2, tree())


def test_gc_keeps_last_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree(s))
    assert ck.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_000000003", "step_000000004"]


def test_tree_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree())
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(1, {"a": torch.zeros(4, 8)})
    bad = tree()
    bad["a"] = torch.zeros(4, 9)
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(1, bad)


def test_the_directory_is_made_at_the_first_save(tmp_path):
    d = tmp_path / "ckpt"
    ck = Checkpointer(str(d))
    assert not d.exists() and ck.all_steps() == [] and ck.latest_step() is None
    ck.save(1, tree())
    assert ck.all_steps() == [1]


def _elastic(tmp_path, save_on, restore_on):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree(device=save_on))
    out = ck.restore(1, tree(seed=1, device=save_on), device=restore_on)
    assert_tree_equal(tree(), out)
    for t in (out["a"], out["nested"]["b"], out["nested"]["list"][0]):
        assert t.device.type == torch.device(restore_on).type
    assert out["nested"]["step"] == 7


def test_elastic_restore_onto_another_device(tmp_path):
    """The checkpoint knows nothing of devices: ``device=`` puts every leaf
    where the caller runs now (CPU to CPU here; the card case below)."""
    _elastic(tmp_path, "cpu", "cpu")
    # target leaves on the CPU, no device=: they stay where the target is
    out = Checkpointer(str(tmp_path)).restore(1, tree(seed=2))
    assert out["a"].device.type == "cpu"


@pytest.mark.gpu
@pytest.mark.parametrize("save_on, restore_on", [("cuda", "cpu"), ("cpu", "cuda")])
def test_elastic_restore_between_the_card_and_the_cpu(tmp_path, save_on, restore_on):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _elastic(tmp_path, save_on, restore_on)


def test_async_write_failure_surfaces_and_never_commits(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    t = {"w": torch.arange(8, dtype=torch.float32)}
    # the write runs on the writer thread: install(), not a scope
    plan = FaultPlan([
        FaultRule(site="checkpoint.write:2", message="disk full"),
        FaultRule(site="checkpoint.write:4", message="disk full again"),
    ])
    plan.install()
    try:
        ck.save_async(1, t)
        ck.wait()
        ck.save_async(2, t)
        with pytest.raises(RuntimeError, match="async checkpoint failed"):
            ck.wait()
        assert ck.all_steps() == [1], "a failed write must never commit"
        # the next save_async surfaces a pending failure too (it waits first)
        ck.save_async(4, t)
        with pytest.raises(RuntimeError, match="async checkpoint failed"):
            ck.save_async(5, t)
        assert plan.count("checkpoint.write:*") == 2
        # the error clears once raised: saving goes on
        ck.save_async(6, t)
        ck.wait()
        assert ck.all_steps() == [1, 6]
        assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    finally:
        plan.uninstall()


def test_manifest_and_npy_bytes_equal_the_jax_checkpointers(tmp_path):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.train.checkpoint import Checkpointer as JCheckpointer

    rs = np.random.RandomState(3)
    f32 = rs.randn(6, 5).astype(np.float32)
    bf = rs.randn(4, 7).astype(np.float32)
    i32 = rs.randint(-1000, 1000, size=(9,)).astype(np.int32)
    jtree = {"w": jnp.asarray(f32), "opt": {"m": [jnp.asarray(bf, jnp.bfloat16)],
                                            "step": jnp.asarray(11, jnp.int32)},
             "ids": jnp.asarray(i32)}
    ttree = {"w": torch.from_numpy(f32),
             "opt": {"m": [torch.from_numpy(bf).to(torch.bfloat16)], "step": 11},
             "ids": torch.from_numpy(i32)}
    jdir = JCheckpointer(str(tmp_path / "jax")).save(2, jtree)
    tdir = Checkpointer(str(tmp_path / "port")).save(2, ttree)

    def manifest(d):
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    jm, tm = manifest(jdir), manifest(tdir)
    assert jm["step"] == tm["step"] == 2
    fields = ("path", "file", "shape", "dtype", "stored_dtype", "crc32")
    assert [{k: e[k] for k in fields} for e in tm["leaves"]] == \
        [{k: e[k] for k in fields} for e in jm["leaves"]]
    assert {e["dtype"] for e in tm["leaves"]} == {"float32", "bfloat16", "int32"}
    assert any(e["stored_dtype"] == "uint16" for e in tm["leaves"])
    for e in tm["leaves"]:
        with open(os.path.join(jdir, e["file"]), "rb") as a, \
                open(os.path.join(tdir, e["file"]), "rb") as b:
            assert a.read() == b.read(), e["path"]
    # and each package restores the other's
    back = Checkpointer(str(tmp_path / "jax")).restore(2, ttree)
    assert_tree_equal(ttree, back)
