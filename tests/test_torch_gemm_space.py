"""The gemm's knob spaces and routes on the CPU (meta tensors only): every
config of ``MATMUL_SPACE`` and ``EXPERT_GEMM_SPACE`` fits one H100 block;
each heuristic is legal at every shape of the main paths; the routing rule
sends every bf16 main-path shape to the tensor-core or decode route, fp32
to SIMT and an operand TMA cannot address to WMMA; the split-k partition
covers k in whole slices with no empty split; a record of the first port's
spaces falls to the heuristic. ``matmul_bias_act`` runs on the same kernels:
matmul's space, heuristic and route rule at its main-path shapes.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
from repro_torch.core import database as tdb  # noqa: E402
from repro_torch.core.platform import H100_SXM  # noqa: E402
from repro_torch.core.runtime import runtime  # noqa: E402
from repro_torch.kernels import fused as fu  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402

SMEM = H100_SXM.smem_per_block       # 227 KB
BF16, F32 = torch.bfloat16, torch.float32


def _meta(*s, dtype=BF16):
    return torch.empty(*s, device="meta", dtype=dtype)


def _fits(cfg):
    return (mm.smem_bytes(cfg) <= SMEM and mm._threads(cfg) <= mm.MAX_THREADS
            and mm._acc_regs(cfg) <= mm.MAX_ACC)


def test_every_matmul_config_fits_one_block():
    cfgs = list(mm.MATMUL_SPACE.enumerate())
    assert cfgs and all(_fits(c) for c in cfgs)
    assert {c["bm"] for c in cfgs} == {16, 64, 128}
    assert {c["stages"] for c in cfgs} == {2, 3, 4, 5, 6}
    assert {c["splits"] for c in cfgs} == {1, 2, 4, 8, 16}
    # the widest tile takes two stages of 128-deep slices, not three
    assert mm.MATMUL_SPACE.is_valid({"bm": 128, "bn": 256, "bk": 128, "stages": 2, "splits": 1})
    big = {"bm": 128, "bn": 256, "bk": 128, "stages": 3, "splits": 1}
    assert mm.smem_bytes(big) > SMEM and not mm.MATMUL_SPACE.is_valid(big)


def test_every_expert_gemm_config_fits_one_block():
    cfgs = list(mg.EXPERT_GEMM_SPACE.enumerate())
    assert len(cfgs) == len(list(mm.MATMUL_SPACE.enumerate()))
    assert all(_fits(mg._tile(c)) for c in cfgs)
    assert mg.EXPERT_GEMM_SPACE.names == ("bc", "bn", "bk", "stages", "splits")


def test_simt_and_wmma_tiles_follow_their_rule_whatever_the_config():
    x, w = _meta(8, 16384, dtype=F32), _meta(16384, 8192, dtype=F32)
    plans = {tuple(mm.plan(x, w, c).items()) for c in list(mm.MATMUL_SPACE.enumerate())[::37]}
    assert len(plans) == 1
    p = dict(plans.pop())
    assert p["route"] == "simt" and p["code"] == mm.ROWS_CODE and p["bn"] == mm.ROWS_COLS
    assert p["kernel"] == "rows" and p["splits"] > 1   # 16 column blocks over k = 16,384
    # more rows: the register-tiled kernel, 128 x 256 tiles in 32-deep k
    # slices through a ring of 3, whatever the config
    assert mm.simt_tiles(2048, 8192, 16384) == {"bm": 128, "bn": 256, "bk": 32, "stages": 3,
                                                "splits": 1}
    x = _meta(2048, 16384, dtype=F32)
    plans = {tuple(mm.plan(x, w, c).items()) for c in list(mm.MATMUL_SPACE.enumerate())[::37]}
    assert len(plans) == 1
    p = dict(plans.pop())
    assert p["code"] == mm.ROUTES["simt"] and p["kernel"] == "tile" and p["bm"] == 128
    for rows in (8, 37, 2048):
        t = mm.wmma_tiles(rows)
        assert mm.loop_threads(t) <= 512 and mm.loop_smem_bytes(t, 2) <= SMEM
        assert mm.loop_threads(t) <= 512 and mm.loop_smem_bytes(t, 4) <= SMEM   # fp32 loop
    for rows in (17, 37, 64, 65, 2048):
        assert mm.simt_tiles(rows, 64, 64) == dict(mm.SIMT_TILE, splits=1)
    # a ring of three 32-deep slices of A and B, rows padded by 4 floats:
    # 147 KB, one CTA an SM
    assert mm.SIMT_SMEM == 3 * 32 * (132 + 260) * 4 <= SMEM < 2 * mm.SIMT_SMEM


# qwen2_0_5b, Jamba-1.5-Large (d_model 8192, d_inner 16384, dt_rank 512,
# d_state 16: x_proj's 544) and Mixtral-8x7B (d_model 4096, d_ff 14336)
D, FF, KV, V = 896, 4864, 128, 151936
QWEN = ((D, D), (D, KV), (D, FF), (FF, D), (D, V))


def _assert_legal(x, w, route_want):
    cfg = mm.matmul.default_config(x, w)
    assert mm.MATMUL_SPACE.is_valid(cfg) and _fits(cfg), cfg
    assert mm.route(x, w) == mm.route(x, w, cfg["bm"]) == route_want, (x.shape, w.shape, cfg)
    return cfg


@pytest.mark.parametrize("m", (1, 8, 16, 32, 64, 128, 256, 512, 1024, 2048))
def test_qwen_serving_heuristic_is_legal_and_on_the_tensor_cores(m):
    for k, n in QWEN:
        _assert_legal(_meta(m, k), _meta(k, n), "decode" if m <= 16 else "tc")


@pytest.mark.parametrize("t,k,n", [(8192, D, D), (8192, D, KV), (8192, D, FF), (8192, FF, D),
                                   (2048, D, V)])
def test_qwen_training_heuristic_is_legal_in_all_three_forms(t, k, n):
    # forward x @ w, dx = ct @ w^T, dw = x^T @ ct (views, never copies)
    _assert_legal(_meta(t, k), _meta(k, n), "tc")
    _assert_legal(_meta(t, n), _meta(k, n).T, "tc")
    cfg = _assert_legal(_meta(t, k).T, _meta(t, n), "tc")
    if t == 8192 and n == KV:
        assert cfg["splits"] > 1                # 7 output tiles over k = 8192


@pytest.mark.parametrize("m", (8, 1500, 2048))
def test_hybrid_heuristic_is_legal_in_bf16_and_fp32(m):
    dm, di, dtr = 8192, 16384, 512
    bf = "decode" if m <= 16 else "tc"
    _assert_legal(_meta(m, dm), _meta(dm, 2 * di), bf)               # in_proj
    _assert_legal(_meta(m, di), _meta(di, dtr + 32), bf)             # x_proj, n = 544
    _assert_legal(_meta(m, dtr, dtype=F32), _meta(dtr, di, dtype=F32), "simt")   # dt_proj
    _assert_legal(_meta(m, di, dtype=F32), _meta(di, dm, dtype=F32), "simt")     # out_proj


@pytest.mark.parametrize("m", (8, 8192))
def test_mixtral_heuristic_is_legal(m):
    dm = 4096
    for k, n in ((dm, dm), (dm, 1024), (dm, 32000)):
        _assert_legal(_meta(m, k), _meta(k, n), "decode" if m <= 16 else "tc")


@pytest.mark.parametrize("c", (2, 37, 640, 2560))
def test_expert_gemm_heuristic_is_legal_in_all_three_forms(c):
    e, dm, ff = 8, 4096, 14336
    route = "decode" if c <= 16 else "tc"
    for k, n in ((dm, ff), (ff, dm)):
        x, w = _meta(e, c, k), _meta(e, k, n)
        for a, b in ((x, w), (_meta(e, c, n), _meta(e, n, k).transpose(1, 2)),   # ct @ w^T
                     (_meta(e, k, c).transpose(1, 2), _meta(e, c, n))):          # x^T @ ct
            cfg = mg.expert_gemm.default_config(a, b)
            assert mg.EXPERT_GEMM_SPACE.is_valid(cfg) and _fits(mg._tile(cfg))
            want = route
            if a.stride(1) == 1 and c % 8:   # x^T @ ct: a leading dim of c elements
                want = "wmma"
            assert mm.route(a, b) == want, (c, a.shape, a.stride(), b.shape)


def test_route_sends_what_tma_cannot_address_to_wmma():
    w = _meta(128, 64)
    assert mm.route(_meta(8, 128), w) == "decode"
    assert mm.route(_meta(8, 100), _meta(100, 64)) == "wmma"     # leading dim of 200 bytes
    assert mm.route(_meta(128, 13).T, w) == "wmma"                # leading dim 13 elements
    assert mm.route(_meta(128, 16).T, w) == "decode"              # 32 bytes: aligned
    assert mm.route(_meta(8, 128), _meta(128, 60)) == "wmma"      # odd leading dim of B
    assert mm.route(_meta(8, 100, dtype=F32), _meta(100, 64, dtype=F32)) == "simt"
    # a base that is not 16-byte aligned, on the CPU where data_ptr is real
    x = torch.empty(8 * 128 + 1, dtype=BF16)[1:].view(8, 128)
    assert x.data_ptr() % 16 and mm.route(x, torch.empty(128, 64, dtype=BF16)) == "wmma"
    # an expert stride of 37 * 4096 elements is aligned; a leading dim of 37 is not
    assert mm.route(_meta(8, 37, 4096), _meta(8, 4096, 64)) == "tc"
    assert mm.route(_meta(8, 40, 37).transpose(1, 2), _meta(8, 40, 64)) == "wmma"
    # the config's bm picks between the tensor-core kernels
    assert mm.route(_meta(8, 128), w, 64) == "tc"
    assert mm.route(_meta(300, 128), w, 16) == "decode"


@pytest.mark.parametrize("k", (1, 63, 64, 65, 896, 4864, 8192, 151936))
@pytest.mark.parametrize("bk", (32, 64, 128))
def test_split_k_covers_k_in_whole_slices_with_no_empty_split(k, bk):
    slices = -(-k // bk)
    for splits in (1, 2, 3, 4, 8, 16, 32):
        kps, n = mm.split_k(k, bk, splits)
        ranges = [(s * kps * bk, min((s + 1) * kps, slices) * bk) for s in range(n)]
        assert 1 <= n <= min(splits, slices)
        assert ranges[0][0] == 0 and ranges[-1][1] >= k > ranges[-1][0]
        assert all(a < b for a, b in ranges)                       # none empty
        assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))   # contiguous
        assert all(a % bk == 0 for a, _ in ranges)                 # whole slices


@pytest.mark.parametrize("name,old", [
    ("matmul", {"bm": 16, "bn": 32, "bk": 16}),
    ("expert_gemm", {"bc": 64, "bn": 64, "bk": 64}),
    ("matmul_bias_act", {"bm": 64, "bn": 64, "bk": 64}),     # the WMMA loop's own space
])
def test_a_record_of_the_first_spaces_falls_to_the_heuristic(tmp_path, name, old):
    extra = ""
    if name == "matmul":
        tun, args = mm.matmul, (torch.randn(8, 64), torch.randn(64, 32))
    elif name == "expert_gemm":
        tun, args = mg.expert_gemm, (torch.randn(2, 12, 16), torch.randn(2, 16, 8))
    else:
        tun, args = fu.matmul_bias_act, (torch.randn(8, 64), torch.randn(64, 32), torch.randn(32))
        extra = "asilu"
    path = str(tmp_path / "db.json")
    db = tdb.TuningDatabase(path)
    key = runtime(db=db).key_for(tun, args, extra)
    db.put(tdb.Record(key=key, config=old, objective=1e-5, evaluator="wallclock",
                      evaluations=1, timestamp=tdb.now()))
    with runtime(db=tdb.TuningDatabase(path)) as rt:
        res = rt.resolve(name, args, extra)
    assert res.key == key and res.tier == "heuristic"
    assert res.config == tun.default_config(*args) != old
    assert rt.telemetry.snapshot()["by_key"][key] == {"heuristic": 1}


# matmul_bias_act: the gemm with a bias + activation epilogue on matmul's
# kernels. Its main-path shapes: the training gate [8192,896]@[896,4864],
# the serving buckets at the gate's n, and the biased q/k/v projections
# [T,896]@[896,896|128] at decode, prefill and training rows.
MBA_SHAPES = ([(8192, D, FF)] + [(m, D, FF) for m in (16, 32, 64, 128, 256, 512, 1024, 2048)]
              + [(t, D, n) for t in (8, 2048, 8192) for n in (D, KV)])


def test_matmul_bias_act_takes_matmuls_space():
    assert fu.matmul_bias_act.space is mm.MATMUL_SPACE
    assert not hasattr(fu, "FUSED_MATMUL_SPACE")
    # the first port's WMMA loop space is gone: its tiles alone are no config
    assert not mm.MATMUL_SPACE.is_valid({"bm": 64, "bn": 64, "bk": 64})


@pytest.mark.parametrize("m,k,n", MBA_SHAPES)
def test_matmul_bias_act_heuristic_is_legal_and_on_the_tensor_cores(m, k, n):
    x, w, b = _meta(m, k), _meta(k, n), _meta(n)
    cfg = fu.matmul_bias_act.default_config(x, w, b)
    assert cfg == mm.gemm_heuristic(m, n, k) == mm.matmul.default_config(x, w)
    assert mm.MATMUL_SPACE.is_valid(cfg) and _fits(cfg)
    p = mm.plan(x, w, cfg)
    assert p["route"] == ("decode" if m <= 16 else "tc") == mm.route(x, w), (m, n, cfg)
    assert p["splits"] == 1                     # k = 896: no split


@pytest.mark.parametrize("x,w,want", [
    (_meta(1000, D), _meta(D, 4860), "wmma"),          # row stride of 9,720 bytes
    (_meta(8, D), _meta(D, 4860), "wmma"),
    (_meta(8192, D, dtype=F32), _meta(D, FF, dtype=F32), "simt"),
    (_meta(8, D, dtype=F32), _meta(D, D, dtype=F32), "simt"),
    (_meta(8192, D), _meta(FF, D).T, "tc"),             # a transposed weight: aligned
])
def test_matmul_bias_act_route_rule_is_matmuls(x, w, want):
    cfg = fu.matmul_bias_act.default_config(x, w, None)
    p = mm.plan(x, w, cfg)
    assert p["route"] == want == mm.route(x, w, cfg["bm"])
    if want == "simt" and x.shape[0] <= mm.DECODE_ROWS:
        assert p["code"] == mm.ROWS_CODE
    # force_loop: the first port's tile loop, the before of a same-call timing
    assert mm.plan(x, w, cfg, force_loop=True)["route"] == ("simt" if want == "simt" else "wmma")


# The fp32 route's register-tiled kernel (more than 16 rows) at every shape
# of the hybrid's fp32 gemms: dt_proj [rows, 512] @ [512, d_inner] and
# out_proj [rows, d_inner] @ [d_inner, 8192], forward and, for the coming
# hybrid training, out_proj's dx = ct @ w^T and dw = x^T @ ct; d_inner 16384
# and a ragged 16380.
HYBRID_F32 = [(rows, k, n) for rows in (17, 37, 64, 200, 256, 1000, 1500, 2048)
              for di in (16384, 16380) for k, n in ((512, di), (di, 8192))]


@pytest.mark.parametrize("rows,k,n", HYBRID_F32)
def test_simt_tiles_fit_the_h100_at_every_hybrid_shape(rows, k, n):
    t = mm.simt_tiles(rows, n, k)
    assert {key: t[key] for key in mm.SIMT_TILE} == mm.SIMT_TILE
    # the ring within a block's shared memory, and each split a range of
    # whole slices covering k
    assert mm.SIMT_SMEM <= SMEM and mm.SIMT_SMEM + 1024 <= H100_SXM.smem_per_sm
    kps, splits = mm.split_k(k, t["bk"], t["splits"])
    assert splits == t["splits"] and kps * splits * t["bk"] >= k
    for x, w in ((_meta(rows, k, dtype=F32), _meta(k, n, dtype=F32)),          # forward
                 (_meta(rows, n, dtype=F32), _meta(k, n, dtype=F32).T),        # dx
                 (_meta(rows, k, dtype=F32).T, _meta(rows, n, dtype=F32))):    # dw
        p = mm.plan(x, w, mm.matmul.default_config(x, w))
        assert p["route"] == "simt" and p["kernel"] == "tile"
        assert p["code"] == mm.ROUTES["simt"] and p["bn"] == 256


@pytest.mark.parametrize("rows,want", [(17, 8), (37, 8), (128, 8), (129, 4), (200, 4),
                                       (256, 4), (300, 2), (600, 1), (1500, 1), (2048, 1)])
def test_simt_splits_few_rows_over_a_long_k(rows, want):
    """out_proj over k = 16,384: split until the tiles fill a wave of the
    132 SMs (one CTA an SM), each split at least 16 slices of 32; none once
    the tiles fill it (2048 rows: 512 tiles), and none over dt_proj's
    k = 512."""
    t = mm.simt_tiles(rows, 8192, 16384)
    assert t["splits"] == want
    wave = H100_SXM.sm_count
    tiles = -(-rows // t["bm"]) * 32
    assert tiles * t["splits"] >= wave
    assert t["splits"] == 1 or tiles * t["splits"] // 2 < wave
    assert mm.simt_tiles(rows, 16384, 512)["splits"] == 1
    assert mm.simt_tiles(rows, 8192, mm.LONG_K - 16)["splits"] == 1


def test_simt_granules_follow_the_operands_layout_and_alignment():
    """A row-major x and a transposed w are stored along k: transposed on
    their way into shared memory, element by element (4 bytes). A transposed
    x and a row-major w are copied as stored, in the widest granule that
    their base, leading dimension and batch stride divide."""
    f = lambda *s: torch.zeros(*s, dtype=F32)
    x, w = f(64, 512), f(512, 256)
    assert mm.simt_granules(x, w) == (4, 16)                  # row-major x, aligned w
    assert mm.simt_granules(f(512, 64).T, f(256, 512).T) == (16, 4)
    assert mm.simt_granules(x, f(512, 16380)) == (4, 16)      # 65,520-byte rows
    assert mm.simt_granules(x, f(512, 258)[:, :256]) == (4, 8)     # rows of 1,032 bytes
    assert mm.simt_granules(x, f(512, 257)[:, :256]) == (4, 4)     # rows of 1,028 bytes
    flat = f(512 * 256 + 2)
    assert mm.simt_granules(x, flat[2:].view(512, 256)) == (4, 8)  # base 8 bytes off
    assert mm.simt_granules(x, flat[1:-1].view(512, 256)) == (4, 4)
    xt = f(512 * 64 + 1)[1:].view(512, 64).T                   # a transposed x, 4 bytes off
    assert mm.simt_granules(xt, w) == (4, 16)
    # 3-D operands (expert_gemm): the batch stride joins the rule
    assert mm.simt_granules(f(3, 40, 64), f(3, 64, 130)) == (4, 8)
    assert mm.simt_granules(f(3, 64, 40).transpose(1, 2), f(3, 64, 128)) == (16, 16)
    assert mm.simt_granules(f(3, 64, 37).transpose(1, 2), f(3, 64, 128)) == (4, 16)


def test_forced_fp32_loop_keeps_the_first_ports_loop():
    """force_loop reaches the first port's fp32 loop (its own kernel code)
    at the WMMA rule's tiles; the rule itself takes the register tiles."""
    x, w = _meta(2048, 16384, dtype=F32), _meta(16384, 8192, dtype=F32)
    cfg = mm.matmul.default_config(x, w)
    loop, tile = mm.plan(x, w, cfg, force_loop=True), mm.plan(x, w, cfg)
    assert loop["route"] == tile["route"] == "simt"
    assert (loop["kernel"], loop["code"]) == ("loop", mm.LOOP_CODE)
    assert (tile["kernel"], tile["code"]) == ("tile", mm.ROUTES["simt"])
    assert {k: loop[k] for k in ("bm", "bn", "bk", "splits")} == \
        dict(mm.wmma_tiles(2048), splits=1)
    bf = mm.plan(_meta(2048, 512), _meta(512, 256), mm.gemm_heuristic(2048, 256, 512),
                 force_loop=True)
    assert (bf["route"], bf["kernel"], bf["code"]) == ("wmma", "loop", mm.ROUTES["wmma"])
