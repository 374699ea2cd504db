"""The port's tuning core and dispatch runtime, on the CPU.

Keys must read exactly as the JAX package writes them (platform aside), a
record written by the port must resolve ``exact``, a miss ``heuristic``,
and each re-derived Hopper knob space must hold its own heuristic config at
the serving path's shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import database as jdb  # noqa: E402
from repro.core.annotate import get_tunable as j_get_tunable  # noqa: E402
from repro.core.runtime import ensure_registered as j_register  # noqa: E402
from repro.core.tuner import _args_key as j_args_key  # noqa: E402
from repro_torch.core import database as tdb  # noqa: E402
from repro_torch.core.runtime import ExactHit, Reference, current_runtime, runtime  # noqa: E402
from repro_torch.core.tuner import _args_key as t_args_key  # noqa: E402
from repro_torch.core.tuner import promoted_dtype  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

j_register()

_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _args(shapes_dtypes):
    j = tuple(jnp.zeros(s, _J[d]) for s, d in shapes_dtypes)
    t = tuple(torch.zeros(s, dtype=_T[d]) for s, d in shapes_dtypes)
    return j, t


@pytest.mark.parametrize("name,spec,extra", [
    ("matmul", [((8, 896), "bfloat16"), ((896, 151936), "bfloat16")], ""),
    ("matmul", [((300, 896), "bfloat16"), ((896, 4864), "float32")], ""),
    ("rmsnorm", [((2048, 896), "bfloat16"), ((896,), "bfloat16")], ""),
    ("flash_attention", [((1, 14, 512, 64), "bfloat16"), ((1, 2, 512, 64), "bfloat16"),
                         ((1, 2, 512, 64), "bfloat16")], "cTruew0"),
    ("softmax_xent", [((6, 100), "float32"), ((6,), "int32")], ""),
])
def test_keys_match_the_jax_package(name, spec, extra):
    j_args, t_args = _args(spec)
    j_key = j_args_key(j_get_tunable(name), j_args, "P", extra)
    t_tun = type("T", (), {"name": name})()          # keys need the name only
    assert t_args_key(t_tun, t_args, "P", extra) == j_key


@pytest.mark.parametrize("a,b", [("bfloat16", "float32"), ("int32", "float32"),
                                 ("int32", "bfloat16"), ("bfloat16", "bfloat16")])
def test_promoted_dtype_follows_jax(a, b):
    expect = str(jnp.result_type(_J[a], _J[b]))
    assert promoted_dtype([_T[a], _T[b]]) == expect
    assert promoted_dtype([_T[b], _T[a]]) == expect


def test_record_resolves_exact_and_miss_resolves_heuristic(tmp_path):
    x, w = torch.randn(8, 64), torch.randn(64, 32)
    path = str(tmp_path / "db.json")
    db = tdb.TuningDatabase(path)
    key = runtime(db=db).key_for(mm.matmul, (x, w))
    assert key == "matmul|torch-cpu|8x64/64x32|float32"
    cfg = {"bm": 16, "bn": 64, "bk": 32}
    db.put(tdb.Record(key=key, config=cfg, objective=1e-5, evaluator="wallclock",
                      evaluations=1, timestamp=tdb.now()))
    # a fresh process view of the file: the port's record, read back
    with runtime(db=tdb.TuningDatabase(path)) as rt:
        rt.dispatch("matmul", x, w)
        rt.dispatch("matmul", x, w)                       # cached resolution
        rt.dispatch("matmul", torch.randn(100, 64), w)    # another bucket: a miss
        assert rt.resolve("matmul", (x, w)).config == cfg
    snap = rt.telemetry.snapshot()
    assert snap["by_key"][key] == {"exact": 3}
    assert snap["by_key"]["matmul|torch-cpu|128x64/64x32|float32"] == {"heuristic": 1}
    assert snap["tiers"] == {"exact": 3, "heuristic": 1}
    assert snap["cache_hits"] == 2
    # the JAX package reads the same file: one schema, one key format
    assert jdb.TuningDatabase(path).lookup(key).config == cfg


def test_reference_mode_and_policies():
    x, w = torch.randn(5, 16), torch.randn(16, 8)
    with runtime(mode="reference") as rt:
        out = rt.dispatch("matmul", x, w, config={"bm": 16, "bn": 32, "bk": 16})
    assert rt.telemetry.tiers == {"reference": 1}
    torch.testing.assert_close(out, x @ w)
    with runtime(policy=(ExactHit(), Reference())) as rt:   # "tuned or reference"
        rt.dispatch("rmsnorm", torch.randn(4, 16), torch.ones(16))
    assert rt.telemetry.tiers == {"reference": 1}
    with runtime() as rt:
        rt.dispatch("matmul", x, w, config={"bm": 16, "bn": 32, "bk": 16})
    assert rt.telemetry.tiers == {"override": 1}


def test_runtimes_nest_and_inherit():
    db = tdb.TuningDatabase(None)
    outer_default = current_runtime()
    assert outer_default.mode == "kernel"       # the port's default: the kernel path
    with runtime(db=db, name="outer") as outer:
        with runtime(mode="reference") as inner:
            assert current_runtime() is inner
            assert inner.db is db and inner.mode == "reference"
            assert not inner.fusion_wins("matmul_bias_act", torch.ones(2, 2))
        assert current_runtime() is outer
    assert current_runtime() is outer_default


def test_cache_is_bounded():
    w = torch.randn(16, 8)
    with runtime(cache_capacity=1) as rt:
        for m in (4, 40, 4):
            rt.dispatch("matmul", torch.randn(m, 16), w)
    assert rt.cache_size == 1
    assert rt.telemetry.cache_evictions == 2
    assert rt.telemetry.cache_hits == 0


D, FF, KV, V = 896, 4864, 128, 151936
BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


@pytest.mark.parametrize("m", (1, 8) + BUCKETS)
def test_matmul_heuristic_is_legal_on_the_serving_path(m):
    for k, n in ((D, D), (D, KV), (D, FF), (FF, D), (D, V)):
        cfg = mm._matmul_heuristic(torch.empty(m, k, device="meta"),
                                   torch.empty(k, n, device="meta"))
        assert mm.MATMUL_SPACE.is_valid(cfg), (m, k, n, cfg)
        assert mm._threads(cfg) <= 512 and mm.smem_bytes(cfg, 2) <= 232_448


@pytest.mark.parametrize("rows", (8,) + BUCKETS)
def test_rmsnorm_heuristic_is_legal_on_the_serving_path(rows):
    cfg = rn._rmsnorm_heuristic(torch.empty(rows, D, device="meta"), None)
    assert rn.RMSNORM_SPACE.is_valid(cfg)


@pytest.mark.parametrize("s", BUCKETS)
def test_flash_heuristic_is_legal_on_the_serving_path(s):
    q = torch.empty(1, 14, s, 64, device="meta")
    kv = torch.empty(1, 2, s, 64, device="meta")
    cfg = fa._attn_heuristic(q, kv, kv)
    assert fa.ATTENTION_SPACE.is_valid(cfg)
    assert fa.smem_bytes(cfg, 64) <= 232_448


def test_spaces_are_hopper_limits_not_vmem():
    # every enumerated config fits one H100 block; the largest tiles do not
    assert all(mm._threads(c) <= 512 for c in mm.MATMUL_SPACE.enumerate())
    assert not mm.MATMUL_SPACE.is_valid({"bm": 256, "bn": 256, "bk": 128})
    assert not fa.ATTENTION_SPACE.is_valid({"block_q": 128, "block_k": 256})
    assert rn.RMSNORM_SPACE.is_valid({"block_rows": 32})
