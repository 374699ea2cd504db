"""The fused tunables of the port against the JAX package, on the CPU.

* The plain versions of ``matmul_bias_act`` and ``rmsnorm_matmul`` (what the
  port's wrappers run on a CPU tensor) against JAX's Pallas kernels in
  interpret mode, in f32 and bf16, for every activation, at ragged shapes;
  the reference tiers of both packages too.
* Their gradients, through each package's kernel-mode dispatch and
  backward plan, against each other.
* The model sites: ``dense``, ``rmsnorm_dense`` and ``ffn_apply`` route
  through the fused tunables exactly when the database holds a record for
  the call's key, and give the JAX package's numbers under the same
  routing.

Tolerances, relative to max|JAX output| (``core/evaluate.py``'s table):
f32 1e-5 (the same fp32 math, sums in another order); bf16 2e-2 (one bf16
rounding of the output on each side, plus the bf16 normalised rows of
rmsnorm_matmul, which both round at the same places).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core.database import Record as JRecord  # noqa: E402
from repro.core.database import TuningDatabase as JDB  # noqa: E402
from repro.core.database import make_key as j_make_key  # noqa: E402
from repro.core.platform import detect_platform as j_detect  # noqa: E402
from repro.core.runtime import dispatch as j_dispatch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused import matmul_bias_act_pallas, rmsnorm_matmul_pallas  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.core.database import Record, TuningDatabase, make_key  # noqa: E402
from repro_torch.core.runtime import dispatch, runtime  # noqa: E402
from repro_torch.kernels import fused as fu  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
ACTS = ("none", "gelu", "silu")


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _pair(a, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(t_out, j_out, dtype):
    j = np.asarray(jnp.asarray(j_out).astype(jnp.float32))
    t = t_out.detach().float().numpy()
    assert t.shape == j.shape
    err = np.abs(t - j).max()
    assert err <= DTYPES[dtype][2] * max(np.abs(j).max(), 1e-6), err


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n,blocks", [
    (32, 64, 128, (8, 128, 128)),
    (37, 100, 45, (16, 128, 128)),      # nothing divides: the Pallas kernel pads
    (8, 96, 200, (8, 128, 256)),
])
def test_matmul_bias_act_matches_pallas(dtype, act, m, k, n, blocks):
    jx, tx = _pair(_np(m, k, seed=m), dtype)
    jw, tw = _pair(_np(k, n, seed=k, scale=k ** -0.5), dtype)
    jb, tb = _pair(_np(n, seed=n, scale=0.3), dtype)
    bm, bn, bk = blocks
    j_out = matmul_bias_act_pallas(jx, jw, jb, bm=bm, bn=bn, bk=bk, act=act, interpret=True)
    _close(fu.matmul_bias_act_plain(tx, tw, tb, act), j_out, dtype)
    _close(dispatch("matmul_bias_act", tx, tw, tb, act=act), j_out, dtype)
    _close(tref.matmul_bias_act(tx, tw, tb, act), jref.matmul_bias_act(jx, jw, jb, act), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,d,n,blocks", [
    (16, 64, 128, (8, 128)),
    (13, 100, 45, (8, 128)),            # ragged rows and columns
    (8, 96, 300, (8, 256)),
    (8, 8192, 40, (8, 128)),            # the hybrid's width, a narrow n
])
def test_rmsnorm_matmul_matches_pallas(dtype, m, d, n, blocks):
    jx, tx = _pair(_np(m, d, seed=m), dtype)
    js, ts = _pair(1 + _np(d, seed=d, scale=0.1), dtype)
    jw, tw = _pair(_np(d, n, seed=n, scale=d ** -0.5), dtype)
    bm, bn = blocks
    j_out = rmsnorm_matmul_pallas(jx, js, jw, bm=bm, bn=bn, eps=1e-6, interpret=True)
    _close(fu.rmsnorm_matmul_plain(tx, ts, tw), j_out, dtype)
    _close(dispatch("rmsnorm_matmul", tx, ts, tw, eps=1e-6), j_out, dtype)
    _close(tref.rmsnorm_matmul(tx, ts, tw), jref.rmsnorm_matmul(jx, js, jw), dtype)


GRAD_CASES = [
    ("matmul_bias_act", lambda: (_np(2, 9, 40, seed=1), _np(40, 24, seed=2, scale=0.2),
                                 _np(24, seed=3, scale=0.3)), {"act": "silu"}),
    ("matmul_bias_act", lambda: (_np(13, 40, seed=4), _np(40, 24, seed=5, scale=0.2),
                                 _np(24, seed=6, scale=0.3)), {"act": "gelu"}),
    ("matmul_bias_act", lambda: (_np(13, 40, seed=7), _np(40, 24, seed=8, scale=0.2),
                                 _np(24, seed=9, scale=0.3)), {"act": "none"}),
    ("rmsnorm_matmul", lambda: (_np(3, 7, 48, seed=10), 1 + _np(48, seed=11, scale=0.1),
                                _np(48, 40, seed=12, scale=0.2)), {"eps": 1e-6}),
]


@pytest.mark.parametrize("case", range(len(GRAD_CASES)),
                         ids=[f"{c[0]}-{c[2].get('act', '')}" for c in GRAD_CASES])
def test_fused_gradients_match_jax(case):
    """jax.grad through JAX's kernel-mode dispatch (Pallas in interpret mode
    and its backward plan) against torch.autograd through the port's
    (the plain versions and the plan's matmul / rmsnorm / rmsnorm_bwd
    dispatch sites), f32, the same inputs and cotangent: 1e-5 of max|grad|."""
    name, make, kw = GRAD_CASES[case]
    args = make()
    with repro.runtime(mode="kernel", db=JDB(None)):
        out_shape = np.shape(j_dispatch(name, *map(jnp.asarray, args), **kw))
    ct = _np(*out_shape, seed=99)
    with repro.runtime(mode="kernel", db=JDB(None)):
        j_grads = jax.grad(lambda *a: jnp.sum(j_dispatch(name, *a, **kw) * ct),
                           argnums=(0, 1, 2))(*map(jnp.asarray, args))
    t_args = [torch.from_numpy(a).requires_grad_() for a in args]
    with runtime(db=TuningDatabase(None)) as rt:
        out = dispatch(name, *t_args, **kw)
        t_grads = torch.autograd.grad(out, t_args, torch.from_numpy(ct))
    bwd_kernels = {k.split("|")[0] for k in rt.telemetry.by_key_phase["bwd"]}
    assert "matmul" in bwd_kernels
    if name == "rmsnorm_matmul":
        assert {"rmsnorm", "rmsnorm_bwd"} <= bwd_kernels
    for t, j in zip(t_grads, j_grads):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-5 * max(np.abs(j).max(), 1e-6)


# ---------------------------------------------------------------------------
# Model sites: fused exactly where a record is banked
# ---------------------------------------------------------------------------

D, FF = 32, 64


def _dbs(records):
    """The same records in both packages' databases, each under its own
    platform key: [(kernel, shapes, dtype, extra, config)]."""
    jdb, tdb = JDB(None), TuningDatabase(None)
    jplat = j_detect().name
    for kernel, shapes, dt, extra, cfg in records:
        jdb.put(JRecord(j_make_key(kernel, jplat, shapes, dt, extra), cfg, 1e-6, "w", 1, 0.0))
    for kernel, shapes, dt, extra, cfg in records:
        tdb.put(Record(make_key(kernel, "torch-cpu", shapes, dt, extra), TORCH_CFG[kernel], 1e-6,
                       "w", 1, 0.0))
    return jdb, tdb


def _run_both(fn_j, fn_t, records, dtype="float32"):
    jdb, tdb = _dbs(records)
    with repro.runtime(mode="kernel", db=jdb) as jrt:
        j_out = fn_j()
    with runtime(db=tdb) as trt:
        t_out = fn_t()
    jk = {k.split("|")[0] for k in jrt.telemetry.snapshot()["by_key"]}
    tk = {k.split("|")[0] for k in trt.telemetry.snapshot()["by_key"]}
    assert jk == tk
    _close(t_out, j_out, dtype)
    return tk


MBA_CFG = {"bm": 8, "bn": 128, "bk": 128}
# The port's records: both fused tunables take matmul's space.
TORCH_CFG = {"matmul_bias_act": {"bm": 16, "bn": 64, "bk": 64, "stages": 4, "splits": 1},
             "rmsnorm_matmul": {"bm": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1}}


@pytest.mark.parametrize("kind,act", [("swiglu", "silu"), ("geglu", "gelu"),
                                      ("gelu", "gelu"), ("relu2", None)])
@pytest.mark.parametrize("banked", [False, True], ids=["unfused", "fused"])
def test_ffn_routes_fused_exactly_when_banked(kind, act, banked):
    x = _np(2, 5, D, seed=1)
    p = {"wg": _np(D, FF, seed=2, scale=D ** -0.5), "wu": _np(D, FF, seed=3, scale=D ** -0.5),
         "wd": _np(FF, D, seed=4, scale=FF ** -0.5)}
    if kind in ("gelu", "relu2"):
        del p["wg"]
    records = ([("matmul_bias_act", [(10, D), (D, FF), (FF,)], "float32", f"a{act}", MBA_CFG)]
               if banked and act else [])
    kernels = _run_both(
        lambda: jlayers.ffn_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                  kind),
        lambda: tlayers.ffn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                  torch.from_numpy(x), kind),
        records)
    assert ("matmul_bias_act" in kernels) == bool(records)


@pytest.mark.parametrize("banked", [False, True], ids=["unfused", "fused"])
def test_dense_with_bias_routes_fused_exactly_when_banked(banked):
    x = _np(3, 4, D, seed=5)
    p = {"w": _np(D, 48, seed=6, scale=D ** -0.5), "b": _np(48, seed=7, scale=0.3)}
    records = ([("matmul_bias_act", [(12, D), (D, 48), (48,)], "float32", "anone", MBA_CFG)]
               if banked else [])
    kernels = _run_both(
        lambda: jlayers.dense({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)),
        lambda: tlayers.dense({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x)),
        records)
    assert ("matmul_bias_act" in kernels) == banked


@pytest.mark.parametrize("banked", [False, True], ids=["unfused", "fused"])
def test_rmsnorm_dense_routes_fused_exactly_when_banked(banked):
    x = _np(8, D, seed=8)
    pn = {"scale": 1 + _np(D, seed=9, scale=0.1)}
    pd = {"w": _np(D, 300, seed=10, scale=D ** -0.5)}
    records = ([("rmsnorm_matmul", [(8, D), (D,), (D, 300)], "float32", "",
                 {"bm": 8, "bn": 128})] if banked else [])
    kernels = _run_both(
        lambda: jlayers.rmsnorm_dense({"scale": jnp.asarray(pn["scale"])},
                                      {"w": jnp.asarray(pd["w"])}, jnp.asarray(x)),
        lambda: tlayers.rmsnorm_dense({"scale": torch.from_numpy(pn["scale"])},
                                      {"w": torch.from_numpy(pd["w"])}, torch.from_numpy(x)),
        records)
    assert ("rmsnorm_matmul" in kernels) == banked
    assert ("rmsnorm" in kernels) != banked


def test_fused_spaces_are_hopper_limits():
    from repro_torch.core.platform import H100_SXM

    # both fused tunables take matmul's space, every config of which fits a
    # block with the norm prologue too: it keeps its rows' statistics in
    # registers and rewrites A's slice in place, and adds only a scale slice
    # a stage
    assert fu.rmsnorm_matmul.space is mm.MATMUL_SPACE
    for cfg in mm.MATMUL_SPACE.enumerate():
        assert mm.smem_bytes(cfg) < fu.prologue_smem_bytes(cfg) <= H100_SXM.smem_per_block
    assert not mm.MATMUL_SPACE.is_valid({"bm": 16, "bn": 256})       # the first port's space
    # the decode unembed and the training rows: heuristics of the space
    w = torch.empty(896, 151936, dtype=torch.bfloat16, device="meta")
    big = torch.empty(8, 896, dtype=torch.bfloat16, device="meta")
    assert fu.rmsnorm_matmul.default_config(big, None, w) == mm.gemm_heuristic(8, 151936, 896)
    rows = torch.empty(8192, 896, dtype=torch.bfloat16, device="meta")
    assert mm.MATMUL_SPACE.is_valid(fu._rmm_heuristic(rows, None, w))
    # matmul_bias_act runs on matmul's space: the training gate's heuristic
    # is legal and takes the tensor-core route
    x = torch.empty(8192, 896, dtype=torch.bfloat16, device="meta")
    gate = torch.empty(896, 4864, dtype=torch.bfloat16, device="meta")
    cfg = fu.matmul_bias_act.default_config(x, gate, None)
    assert fu.matmul_bias_act.space is mm.MATMUL_SPACE and mm.MATMUL_SPACE.is_valid(cfg)
    assert mm.route(x, gate, cfg["bm"]) == "tc"


# The decode unembeds of the three served models, a ragged row count, the
# 64-row pool and wide rows at the hybrid's width: the heuristic is a legal
# config of matmul's space on the decode route up to 16 rows, tc above.
@pytest.mark.parametrize("m,d,n", [(8, 896, 151936), (13, 896, 151936), (8, 4096, 32000),
                                   (8, 8192, 65536), (64, 896, 151936), (64, 8192, 65536),
                                   (2048, 8192, 65536)])
def test_rmsnorm_matmul_heuristic_is_legal(m, d, n):
    x = torch.empty(m, d, dtype=torch.bfloat16, device="meta")
    w = torch.empty(d, n, dtype=torch.bfloat16, device="meta")
    cfg = fu.rmsnorm_matmul.default_config(x, None, w)
    assert mm.MATMUL_SPACE.is_valid(cfg) and cfg == mm.gemm_heuristic(m, n, d)
    assert (cfg["bm"] == mm.DECODE_ROWS) == (m <= mm.DECODE_ROWS)
    kps, splits = mm.split_k(d, cfg["bk"], cfg["splits"])
    assert splits * kps >= -(-d // cfg["bk"]) > (splits - 1) * kps


# The route rule: aligned bf16 takes decode (bm 16) or tc (bm 64, 128); a
# width whose rows TMA cannot address (d = 100: 200-byte rows) or a scale
# one element past an aligned base the k-sliced WMMA loop at matmul's WMMA
# tiles; fp32 the k-sliced SIMT loop (counted as ``simt`` and
# ``simt_loop``); force_loop the loop of its dtype.
@pytest.mark.parametrize("dtype,m,d,cfg_bm,force_loop,scale_off,route,kernel", [
    (torch.bfloat16, 8, 896, None, False, 0, "decode", "decode"),
    (torch.bfloat16, 13, 8192, None, False, 0, "decode", "decode"),
    (torch.bfloat16, 64, 896, None, False, 0, "tc", "tc"),
    (torch.bfloat16, 200, 896, 128, False, 0, "tc", "tc"),
    (torch.bfloat16, 64, 896, 16, False, 0, "decode", "decode"),    # a record's bm rules
    (torch.bfloat16, 8, 100, None, False, 0, "wmma", "wmma"),
    (torch.bfloat16, 64, 100, 128, False, 0, "wmma", "wmma"),
    (torch.bfloat16, 8, 896, None, False, 1, "wmma", "loop"),
    (torch.bfloat16, 8, 896, None, True, 0, "wmma", "loop"),
    (torch.float32, 8, 896, None, False, 0, "simt", "loop"),
    (torch.float32, 200, 8192, 128, False, 0, "simt", "loop"),
])
def test_rmsnorm_matmul_route_rule(dtype, m, d, cfg_bm, force_loop, scale_off, route, kernel):
    x, w = torch.zeros(m, d, dtype=dtype), torch.zeros(d, 40, dtype=dtype)
    s = torch.zeros(d + 8, dtype=dtype)[scale_off:scale_off + d]
    assert (s.data_ptr() % 16 == 0) == (scale_off == 0)
    cfg = fu.rmsnorm_matmul.default_config(x, s, w)
    if cfg_bm is not None:
        cfg = dict(cfg, bm=cfg_bm, bn=128, bk=64, stages=4)
    assert mm.MATMUL_SPACE.is_valid(cfg)
    p = fu.rmm_plan(x, s, w, cfg, force_loop)
    assert (p["route"], p["kernel"]) == (route, kernel)
    if route in ("wmma", "simt"):       # the loop's tiles whatever the config
        assert {k: p[k] for k in ("bm", "bn", "bk")} == {
            k: mm.wmma_tiles(m)[k] for k in ("bm", "bn", "bk")}
        assert p["splits"] == 1
    else:
        assert {k: p[k] for k in ("bm", "bn", "bk", "stages")} == {
            k: cfg[k] for k in ("bm", "bn", "bk", "stages")}


# A record of the first port's {bm, bn} space is no config of the new one:
# the site resolves at the heuristic tier and the fused site is not opted
# in; a record of the new space opts it in at the exact tier.
@pytest.mark.parametrize("record,tier,wins", [({"bm": 16, "bn": 64}, "heuristic", False),
                                              (TORCH_CFG["rmsnorm_matmul"], "exact", True)],
                         ids=["first-port-space", "matmul-space"])
def test_rmsnorm_matmul_record_space(record, tier, wins):
    x, s = _np(8, D, seed=11), 1 + _np(D, seed=12, scale=0.1)
    w = _np(D, 300, seed=13, scale=D ** -0.5)
    db = TuningDatabase(None)
    db.put(Record(make_key("rmsnorm_matmul", "torch-cpu", [(8, D), (D,), (D, 300)], "float32"),
                  record, 1e-6, "w", 1, 0.0))
    tx, ts, tw = map(torch.from_numpy, (x, s, w))
    with runtime(db=db) as rt:
        assert rt.fusion_wins("rmsnorm_matmul", tx, ts, tw, eps=1e-6) == wins
        out = dispatch("rmsnorm_matmul", tx, ts, tw, eps=1e-6)
    assert rt.telemetry.snapshot()["tiers"] == {tier: 1}
    _close(out, jref.rmsnorm_matmul(*map(jnp.asarray, (x, s, w))), "float32")
