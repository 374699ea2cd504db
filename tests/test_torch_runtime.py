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


# ---------------------------------------------------------------------------
# The backward plane: keys, the autograd plane, phases
# ---------------------------------------------------------------------------

import repro  # noqa: E402
from repro.core.runtime import dispatch as j_dispatch  # noqa: E402
from repro_torch.core.annotate import DispatchSpec, Tunable  # noqa: E402
from repro_torch.core.params import ParamSpace, PowerOfTwoParam  # noqa: E402
from repro_torch.core.runtime import dispatch  # noqa: E402


@pytest.mark.parametrize("name,spec,extra", [
    # the backward's transposed matmul calls: keys from shapes only
    ("matmul", [((2048, 151936), "bfloat16"), ((151936, 896), "bfloat16")], ""),
    ("matmul", [((896, 2048), "bfloat16"), ((2048, 151936), "bfloat16")], ""),
    ("matmul", [((4864, 8192), "bfloat16"), ((8192, 896), "bfloat16")], ""),
    ("rmsnorm_bwd", [((8192, 896), "bfloat16"), ((8192, 896), "bfloat16"),
                     ((896,), "bfloat16"), ((8192,), "float32")], ""),
    ("softmax_xent", [((2048, 151936), "bfloat16"), ((2048,), "int32")], ""),
    ("softmax_xent_bwd", [((2048,), "float32"), ((2048, 151936), "bfloat16"),
                          ((2048,), "int32"), ((2048,), "float32")], ""),
    ("flash_attention_bwd", [((4, 14, 2048, 64), "bfloat16"), ((4, 14, 2048, 64), "bfloat16"),
                             ((4, 2, 2048, 64), "bfloat16"), ((4, 2, 2048, 64), "bfloat16"),
                             ((4, 14, 2048, 64), "bfloat16"), ((4, 14, 2048), "float32")],
     "cTruew0"),
])
def test_backward_keys_match_the_jax_package(name, spec, extra):
    j_args, t_args = _args(spec)
    j_key = j_args_key(j_get_tunable(name), j_args, "P", extra)
    t_tun = type("T", (), {"name": name})()
    assert t_args_key(t_tun, t_args, "P", extra) == j_key


def test_transposed_views_key_like_their_shapes():
    """dw = x^T @ ct reaches the key function as a view; its key is the
    key of the shapes, as JAX's (which never sees strides)."""
    x, ct = torch.zeros(64, 32), torch.zeros(64, 48)
    rt = runtime()
    assert rt.key_for(mm.matmul, (x.T, ct)) == rt.key_for(mm.matmul, (x.T.contiguous(), ct))


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_kernel_mode_dispatch_carries_its_backward():
    """On the CPU the plain versions are torch ops that autograd would
    differentiate anyway; the graph must hold the dispatch's own node and
    the backward must run in phase bwd through the *_bwd tunables."""
    x = torch.randn(2, 8, 32, requires_grad=True)
    w = torch.randn(32, requires_grad=True)
    with runtime() as rt:
        y = dispatch("rmsnorm", x, w)
        assert "KernelCallBackward" in _graph_names(y)
        y.sum().backward()
    assert set(rt.telemetry.phases) == {"fwd", "bwd"}
    bwd_kernels = {k.split("|")[0] for k in rt.telemetry.by_key_phase["bwd"]}
    assert bwd_kernels == {"rmsnorm_bwd"}
    # the reference path differentiates plain torch ops: no dispatch node
    with runtime(mode="reference"):
        assert "KernelCallBackward" not in _graph_names(dispatch("rmsnorm", x, w))


def test_bwd_dispatch_off_takes_the_reference_vjp():
    x, w = torch.randn(6, 16, requires_grad=True), torch.randn(16, 8, requires_grad=True)
    with runtime(bwd_dispatch=False) as rt:
        gx, gw = torch.autograd.grad(dispatch("matmul", x, w).sum(), (x, w))
    assert "bwd" not in rt.telemetry.phases               # no gradient dispatch site
    torch.testing.assert_close(gx, torch.ones(6, 8) @ w.detach().T)
    torch.testing.assert_close(gw, x.detach().T @ torch.ones(6, 8))


def test_dispatch_without_a_backward_raises_instead_of_detaching():
    def kernel(x, *, blk):
        return (x * 2).detach()      # a kernel's output: no grad_fn

    probe = Tunable("no_bwd_probe", kernel, ParamSpace([PowerOfTwoParam("blk", 1, 2)]),
                    reference=lambda x: x * 2, dispatch=DispatchSpec(vjp="none"))
    x = torch.randn(4)
    with runtime():
        assert torch.equal(dispatch(probe, x), x * 2)          # no grad needed: fine
        with pytest.raises(RuntimeError, match="declares no backward"):
            dispatch(probe, x.requires_grad_())
        with torch.no_grad():
            dispatch(probe, x)                                # grad mode off: fine


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# name, numpy args, kwargs, which args are differentiable
GRAD_CASES = [
    ("matmul", lambda: (_np(2, 9, 40, seed=1), _np(40, 24, seed=2, scale=0.2)), {}, (0, 1)),
    ("rmsnorm", lambda: (_np(3, 7, 48, seed=3), 1 + _np(48, seed=4, scale=0.1)),
     {"eps": 1e-6}, (0, 1)),
    ("flash_attention", lambda: (_np(1, 4, 48, 16, seed=5, scale=0.5),
                                 _np(1, 2, 48, 16, seed=6, scale=0.5),
                                 _np(1, 2, 48, 16, seed=7)), {"causal": True, "window": 0},
     (0, 1, 2)),
    ("flash_attention", lambda: (_np(1, 4, 48, 16, seed=8, scale=0.5),
                                 _np(1, 2, 48, 16, seed=9, scale=0.5),
                                 _np(1, 2, 48, 16, seed=10)), {"causal": True, "window": 20},
     (0, 1, 2)),
    ("softmax_xent", lambda: (_np(13, 300, seed=11, scale=2.0),
                              np.random.RandomState(12).randint(0, 300, 13).astype(np.int32)),
     {}, (0,)),
]


@pytest.mark.parametrize("case", range(len(GRAD_CASES)),
                         ids=[f"{c[0]}{i}" for i, c in enumerate(GRAD_CASES)])
def test_forward_tunable_gradients_match_jax(case):
    """jax.grad through JAX's dispatch (Pallas in interpret mode, its
    backward plan) against torch.autograd through the port's KernelCall
    (the plain versions), f32, the same numpy inputs and cotangent.
    Tolerance 1e-5 of max|grad|: the same fp32 math, sums in another order."""
    name, make, kw, diff = GRAD_CASES[case]
    args = make()
    with repro.runtime(mode="kernel"):
        out_shape = np.shape(j_dispatch(name, *map(jnp.asarray, args), **kw))
    ct = _np(*out_shape, seed=99)

    def jloss(*dargs):
        full = list(map(jnp.asarray, args))
        for i, a in zip(diff, dargs):
            full[i] = a
        return jnp.sum(j_dispatch(name, *full, **kw) * ct)

    with repro.runtime(mode="kernel"):
        j_grads = jax.grad(jloss, argnums=tuple(range(len(diff))))(
            *(jnp.asarray(args[i]) for i in diff))
    t_args = [torch.from_numpy(a) for a in args]
    for i in diff:
        t_args[i].requires_grad_()
    with runtime() as rt:
        out = dispatch(name, *t_args, **kw)
        t_grads = torch.autograd.grad(out, [t_args[i] for i in diff], torch.from_numpy(ct))
    assert rt.telemetry.phases["bwd"]
    for t, j in zip(t_grads, j_grads):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-5 * max(np.abs(j).max(), 1e-6)


def test_rmsnorm_grad_of_grad_matches_jax():
    """Second order through a dispatched gradient site: the first backward
    runs rmsnorm_bwd (vjp="reference"), whose own backward is the autograd
    of the oracle. JAX routes its double grad to the reference as well."""
    x, w = _np(5, 24, seed=20), 1 + _np(24, seed=21, scale=0.1)
    ct = _np(5, 24, seed=22)

    def jf(xx):
        g = jax.grad(lambda y: jnp.sum(j_dispatch("rmsnorm", y, jnp.asarray(w)) * ct))(xx)
        return jnp.sum(g * g)

    with repro.runtime(mode="kernel"):
        j_gg = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    with runtime() as rt:
        y = dispatch("rmsnorm", tx, torch.from_numpy(w))
        (g,) = torch.autograd.grad(y, tx, torch.from_numpy(ct), create_graph=True)
        (gg,) = torch.autograd.grad((g * g).sum(), tx)
    assert "rmsnorm_bwd" in {k.split("|")[0] for k in rt.telemetry.by_key_phase["bwd"]}
    assert np.abs(gg.numpy() - j_gg).max() <= 1e-4 * np.abs(j_gg).max()


def test_phases_reject_unknown_names():
    from repro_torch.core.runtime import PHASES, current_phase, dispatch_phase

    assert PHASES == ("fwd", "bwd", "opt") and current_phase() == "fwd"
    with dispatch_phase("opt"):
        assert current_phase() == "opt"
    with pytest.raises(ValueError):
        with dispatch_phase("train"):
            pass


def test_training_heuristics_are_legal_at_full_width():
    from repro_torch.kernels import attention as fa_
    from repro_torch.kernels import xent as xe

    meta = lambda *s: torch.empty(*s, device="meta")
    cfg = xe._xent_heuristic(meta(2048, V), meta(2048))
    assert xe.XENT_SPACE.is_valid(cfg) and cfg == {"block_rows": 4, "block_v": 2048}
    for b, s in ((1, 16), (1, 2048), (4, 2048)):
        q, kv = meta(b, 14, s, 64), meta(b, 2, s, 64)
        bcfg = fa_._attn_bwd_heuristic(q, q, kv, kv, q, meta(b, 14, s))
        assert fa_.ATTENTION_BWD_SPACE.is_valid(bcfg)
        assert fa_.bwd_smem_bytes(bcfg, 128) <= 232_448
        assert fa_.ATTENTION_SPACE.is_valid(fa_._attn_heuristic(q, kv, kv))
    # the training step's shape takes the 64-row tiles; serving prefill not
    assert bcfg == {"block_q": 64, "block_k": 32}
    assert fa_._attn_heuristic(q, kv, kv) == {"block_q": 64, "block_k": 64}
    assert fa_._attn_heuristic(meta(1, 14, 2048, 64), kv, kv)["block_q"] == 32
    assert rn.RMSNORM_SPACE.is_valid(rn._rmsnorm_bwd_heuristic(None, meta(8192, D), None, None))
    assert rn.rmsnorm_bwd_smem_bytes(32, D) <= 232_448
    for k, n in ((D, D), (D, FF), (FF, D), (V, D), (2048, V), (8192, FF)):
        assert mm.MATMUL_SPACE.is_valid(mm._matmul_heuristic(meta(2048, k), meta(k, n)))
