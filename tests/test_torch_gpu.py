"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips on a host with no card (the
check runs inside the fixture, never at import). On the card:

    python -m pytest -m gpu tests/test_torch_*.py

Tolerances, relative to max|plain|: f32 1e-5 (fp32 sums in another order);
bf16 1e-2 (the same fp32 sums, then one bf16 rounding of 2^-8 an element).
This file holds the kernels to their plain versions and needs no jax, which
the card's host may not have; the parity with the JAX package is held on
the CPU by the other ``test_torch_*`` files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import fused as fu  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.kernels import xent as xe  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _t(rs, shape, dtype, device, scale=1.0):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to(device, dtype)


def _close(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * max(ref.float().abs().max().item(), 1e-6), err


# Legal configs of the gemm space: the decode route split over k, one
# consumer warpgroup, two with the widest tile.
MATMUL_CONFIGS = [None, {"bm": 16, "bn": 64, "bk": 64, "stages": 4, "splits": 2},
                  {"bm": 64, "bn": 128, "bk": 64, "stages": 3, "splits": 1},
                  {"bm": 128, "bn": 256, "bk": 64, "stages": 3, "splits": 1}]


def _route_counts(name, x, w, cfg, force_loop=False):
    """The launch counts one call of ``name`` on (x, w) at ``cfg`` must add."""
    p = mm.plan(x, w, cfg if "bm" in cfg else dict(cfg, bm=cfg["bc"]), force_loop)
    want = {name: 1, f"{name}_{p['route']}": 1}
    if p["route"] == "simt":                  # fp32: its kernel too (rows, tile, loop)
        want[f"{name}_simt_{p['kernel']}"] = 1
    lay = [mm.operand(t)[0] for t in (x, w)]
    if any(lay):
        want[f"{name}_transposed"] = 1
    if p["splits"] > 1:
        want[f"{name}_splitk"] = 1
    return want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 896, 896), (5, 100, 37), (33, 64, 130),
                                   (256, 896, 4864), (1, 896, 151936)])
@pytest.mark.parametrize("config", MATMUL_CONFIGS)
def test_matmul_kernel_matches_plain(cuda, dtype, m, k, n, config):
    rs = np.random.RandomState(m + k + n)
    x, w = _t(rs, (m, k), dtype, cuda), _t(rs, (k, n), dtype, cuda, k ** -0.5)
    cfg = config or mm.matmul.default_config(x, w)
    kernels.reset_launch_counts()
    out = mm.matmul_cuda(x, w, **cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == _route_counts("matmul", x, w, cfg)
    assert out.dtype == dtype and out.shape == (m, n)
    _close(out, mm.matmul_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8, 896), (13, 100), (2048, 896)])
@pytest.mark.parametrize("block_rows", [None, 1, 32])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d, block_rows):
    rs = np.random.RandomState(rows + d)
    x, w = _t(rs, (rows, d), dtype, cuda), _t(rs, (d,), dtype, cuda)
    cfg = {"block_rows": block_rows} if block_rows else rn.rmsnorm.default_config(x, w)
    out, r = rn.rmsnorm_cuda(x, w, eps=1e-6, **cfg)
    torch.cuda.synchronize()
    p_out, p_r = rn.rmsnorm_plain(x, w, 1e-6)
    _close(out, p_out, dtype)
    _close(r, p_r, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", (64, 100, 896, 4096, 8192))
@pytest.mark.parametrize("rows", (1, 8, 13, 2048))
@pytest.mark.parametrize("block_rows", [None, 1, 32])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_rmsnorm_kernel_on_its_memory_paths(cuda, dtype, d, rows, block_rows, offset):
    """The 16-byte path (d a multiple of the vector, aligned rows), the
    element-load tail (d = 100; every row and the weight one element past a
    16-byte boundary when offset), one warp a row (d <= 1024 in bf16) and a
    team of warps summing through shared memory (d = 4096, 8192), at
    block_rows' limits: out within the bf16 or f32 tolerance, invrms within
    1e-5 of max|plain|, as chip_smoke.py holds them."""
    rs = np.random.RandomState(rows + d + offset)
    x = _t(rs, (rows * d + offset,), dtype, cuda)[offset:].view(rows, d)
    w = (1 + 0.1 * _t(rs, (d + offset,), torch.float32, cuda)).to(dtype)[offset:]
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    cfg = {"block_rows": block_rows} if block_rows else rn.rmsnorm.default_config(x, w)
    out, r = rn.rmsnorm_cuda(x, w, eps=1e-6, **cfg)
    torch.cuda.synchronize()
    p_out, p_r = rn.rmsnorm_plain(x, w, 1e-6)
    _close(out, p_out, dtype)
    _close(r, p_r, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", (16400, 20001))
def test_rmsnorm_kernel_rows_too_wide_for_registers(cuda, dtype, d):
    """Rows wider than a CTA's sixteen warps hold in registers (bf16 d above
    16,384, f32 above 8,192) are read twice, once for the sum and once for
    the output."""
    rs = np.random.RandomState(d)
    x, w = _t(rs, (5, d), dtype, cuda), _t(rs, (d,), dtype, cuda)
    for block_rows in (1, 4):
        out, r = rn.rmsnorm_cuda(x, w, eps=1e-6, block_rows=block_rows)
        torch.cuda.synchronize()
        p_out, p_r = rn.rmsnorm_plain(x, w, 1e-6)
        _close(out, p_out, dtype)
        _close(r, p_r, torch.float32)


# (s_q, s_k, window, d, h, kv): the first five at 4/2 heads; then head dim
# 128 at ragged lengths (the hybrid's exact-length prefills) in groups of 8,
# and a window with s_q < s_k. fp32 runs the SIMT kernels at simt_tiles(d)
# whatever the config; bf16 the tensor-core kernels at the config's tiles.
FLASH_SHAPES = [(16, 16, 0, 64, 4, 2), (100, 100, 0, 64, 4, 2), (64, 128, 0, 16, 4, 2),
                (128, 128, 24, 128, 4, 2), (1, 77, 0, 32, 4, 2), (300, 300, 0, 128, 16, 2),
                (1500, 1500, 0, 128, 16, 2), (200, 333, 100, 64, 16, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k,window,d,h,kv", FLASH_SHAPES)
@pytest.mark.parametrize("config", [None, {"block_q": 64, "block_k": 64, "stages": 3},
                                    {"block_q": 128, "block_k": 64, "stages": 2}])
def test_flash_kernel_matches_plain(cuda, dtype, s_q, s_k, window, d, h, kv, config):
    rs = np.random.RandomState(s_q + s_k + d)
    q = _t(rs, (2, h, s_q, d), dtype, cuda)
    k, v = _t(rs, (2, kv, s_k, d), dtype, cuda), _t(rs, (2, kv, s_k, d), dtype, cuda)
    cfg = config or fa.flash_attention.default_config(q, k, v)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=window, **cfg)
    torch.cuda.synchronize()
    p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    _close(out, p_out, dtype)
    assert (lse - p_lse).abs().max().item() <= 1e-3


def test_wrappers_count_only_kernel_launches(cuda):
    kernels.reset_launch_counts()
    x = torch.randn(4, 64, device=cuda)
    w = torch.randn(64, 32, device=cuda)
    mm.matmul(x, w)
    mm.matmul_plain(x, w)                 # the plain version is not a launch
    mm.matmul(x.cpu(), w.cpu())           # nor is the CPU path
    assert kernels.launch_counts() == _route_counts("matmul", x, w,
                                                    mm.matmul.default_config(x, w))
    assert kernels.launch_counts()["matmul_simt"] == 1


def test_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.randn(64, 64, device=cuda)[:, ::2]      # neither row- nor column-major
    with pytest.raises(ValueError):
        mm.matmul(x, w)


def test_reduced_model_on_card_matches_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig

    cfg = get_config("qwen2_0_5b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    to = lambda t: t.to(cuda) if isinstance(t, torch.Tensor) else (
        {k: to(v) for k, v in t.items()} if isinstance(t, dict) else type(t)(to(v) for v in t))
    on_card = to(params)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 32)))
    run = RunConfig(q_chunk=16, k_chunk=16)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        l_gpu, _ = lm.prefill(on_card, {"tokens": toks.to(cuda)}, cfg, run, true_len=29)
        l_cpu, _ = lm.prefill(params, {"tokens": toks}, cfg, run, true_len=29)
    counts = kernels.launch_counts()
    assert {k for k in counts if not k.startswith("matmul_")} == {"matmul", "rmsnorm",
                                                                  "flash_attention"}
    assert counts["matmul_simt"] == counts["matmul"]          # f32: the SIMT route
    # two layers of fp32 sums in another order: 1e-4 of max|logit|
    err = (l_gpu.cpu() - l_cpu).abs().max().item()
    assert err <= 1e-4 * l_cpu.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,ta,tb", [
    (64, 896, 130, False, True),          # ct @ w^T
    (896, 200, 64, True, False),          # x^T @ ct
    (37, 100, 45, True, True),            # ragged, both transposed
    (2048, 8192, 136, False, True),       # long k
    (130, 3000, 256, True, False),        # long k, ragged m
])
@pytest.mark.parametrize("config", MATMUL_CONFIGS)
def test_matmul_kernel_reads_transposed_operands(cuda, dtype, m, k, n, ta, tb, config):
    rs = np.random.RandomState(m + k + n)
    x = _t(rs, (k, m) if ta else (m, k), dtype, cuda)
    w = _t(rs, (n, k) if tb else (k, n), dtype, cuda, k ** -0.5)
    x, w = (x.T if ta else x), (w.T if tb else w)
    cfg = config or mm.matmul.default_config(x, w)
    kernels.reset_launch_counts()
    out = mm.matmul_cuda(x, w, **cfg)
    torch.cuda.synchronize()
    want = _route_counts("matmul", x, w, cfg)
    assert kernels.launch_counts() == want and want["matmul_transposed"] == 1
    _close(out, mm.matmul_plain(x, w), dtype)


# Every route of the gemm: the decode rows (1, 2, 8, 13, 16) and the first
# prefill ones (17, 64), at k = 328 and n = 200, which no k slice or column
# tile divides; configs on the decode route split over k, and on the tc
# route with one and two consumer warpgroups (split over k too).
ROUTE_ROWS = (1, 2, 8, 13, 16, 17, 64)
ROUTE_CONFIGS = [None, {"bm": 16, "bn": 128, "bk": 64, "stages": 5, "splits": 2},
                 {"bm": 64, "bn": 64, "bk": 128, "stages": 2, "splits": 1},
                 {"bm": 128, "bn": 128, "bk": 64, "stages": 4, "splits": 4}]
LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("m", ROUTE_ROWS)
@pytest.mark.parametrize("config", ROUTE_CONFIGS)
def test_gemm_routes_match_plain(cuda, dtype, ta, tb, m, config):
    k, n = 328, 200
    rs = np.random.RandomState(m + 7 * ta + 3 * tb)
    x = _t(rs, (k, m) if ta else (m, k), dtype, cuda)
    w = _t(rs, (n, k) if tb else (k, n), dtype, cuda, k ** -0.5)
    x, w = (x.T if ta else x), (w.T if tb else w)
    cfg = config or mm.matmul.default_config(x, w)
    # fp32: SIMT; a transposed x of 2 to 15 rows but 8: a leading dim TMA
    # cannot take (m * 2 bytes), so WMMA; else the config's bm
    if dtype == torch.float32:
        want = "simt"
    elif ta and m > 1 and m % 8:
        want = "wmma"
    else:
        want = "decode" if cfg["bm"] == 16 else "tc"
    assert mm.route(x, w, cfg["bm"]) == want
    if config is None and dtype == torch.bfloat16 and want != "wmma":
        assert mm.route(x, w) == want == ("decode" if m <= 16 else "tc")
    kernels.reset_launch_counts()
    out = mm.matmul_cuda(x, w, **cfg)
    again = mm.matmul_cuda(x, w, **cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["matmul"] == 2 and counts[f"matmul_{want}"] == 2
    _close(out, mm.matmul_plain(x, w), dtype)
    assert torch.equal(out, again)        # split-k sums in a fixed order: bitwise equal


@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("m,k,n", [(8, 16384, 2048), (2048, 8192, 136), (2048, 256, 4096)])
def test_gemm_split_k_is_deterministic(cuda, ta, tb, m, k, n):
    """Long-k shapes the heuristic splits (and one it does not), each split a
    range of whole k slices: two runs agree bit for bit."""
    rs = np.random.RandomState(k + n)
    x = _t(rs, (k, m) if ta else (m, k), torch.bfloat16, cuda)
    w = _t(rs, (n, k) if tb else (k, n), torch.bfloat16, cuda, k ** -0.5)
    x, w = (x.T if ta else x), (w.T if tb else w)
    cfg = mm.matmul.default_config(x, w)
    assert (cfg["splits"] > 1) == (k >= mm.LONG_K)
    kernels.reset_launch_counts()
    outs = [mm.matmul_cuda(x, w, **cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.launch_counts().get("matmul_splitk", 0) == (2 if cfg["splits"] > 1 else 0)
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], mm.matmul_plain(x, w), torch.bfloat16)


@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("m", (8, 64, 320))
def test_forced_wmma_route_matches_plain(cuda, ta, tb, m):
    rs = np.random.RandomState(m)
    k, n = 256, 192
    x = _t(rs, (k, m) if ta else (m, k), torch.bfloat16, cuda)
    w = _t(rs, (n, k) if tb else (k, n), torch.bfloat16, cuda, k ** -0.5)
    x, w = (x.T if ta else x), (w.T if tb else w)
    cfg = mm.matmul.default_config(x, w)
    assert mm.route(x, w) != "wmma"
    kernels.reset_launch_counts()
    out = mm.matmul_cuda(x, w, **cfg, force_loop=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == _route_counts("matmul", x, w, cfg, force_loop=True)
    assert kernels.launch_counts()["matmul_wmma"] == 1
    _close(out, mm.matmul_plain(x, w), torch.bfloat16)


# ---------------------------------------------------------------------------
# The fp32 route's register-tiled kernel (more than 16 rows)
# ---------------------------------------------------------------------------

# Ragged m, n and k: rows and columns that no 128 x 256 tile divides, k
# that no 32-deep slice divides, a k shorter than one slice.
SIMT_SHAPES = [(17, 328, 200), (64, 16, 130), (65, 1000, 37), (300, 333, 129), (129, 7, 257)]


def _simt_operands(rs, m, k, n, ta, tb, device):
    x = _t(rs, (k, m) if ta else (m, k), torch.float32, device)
    w = _t(rs, (n, k) if tb else (k, n), torch.float32, device, k ** -0.5)
    return (x.T if ta else x), (w.T if tb else w)


@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("m,k,n", SIMT_SHAPES)
def test_simt_kernel_matches_plain_and_the_first_loop_bit_for_bit(cuda, ta, tb, m, k, n):
    """All four layouts on ragged shapes: the register-tiled kernel agrees
    with the plain version and, at one split, with the first port's loop
    bit for bit (one fmaf chain over k from 0 an output, in both)."""
    x, w = _simt_operands(np.random.RandomState(m + k + n), m, k, n, ta, tb, cuda)
    cfg = mm.matmul.default_config(x, w)
    p = mm.plan(x, w, cfg)
    assert p["kernel"] == "tile" and p["splits"] == 1 and (p["bm"], p["bn"]) == (128, 256)
    kernels.reset_launch_counts()
    out = mm.matmul_cuda(x, w, **cfg)
    loop = mm.matmul_cuda(x, w, **cfg, force_loop=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["matmul_simt_tile"] == counts["matmul_simt_loop"] == 1
    assert counts["matmul_simt"] == counts["matmul"] == 2
    _close(out, mm.matmul_plain(x, w), torch.float32)
    assert torch.equal(out, loop)


def _strided(rs, rows, cols, ld, offset, device):
    """A [rows, cols] fp32 view with leading dimension ld whose base is
    ``offset`` elements past a 16-byte aligned one."""
    buf = torch.zeros(rows * ld + offset + 4, dtype=torch.float32, device=device)
    v = buf[offset:offset + rows * ld].view(rows, ld)[:, :cols]
    v.copy_(_t(rs, (rows, cols), torch.float32, device))
    return v


# (granule, leading-dimension padding, base offset in elements): 16 bytes
# (aligned), 8 (a leading dimension of 2 mod 4, or a base 8 bytes off), 4
# (an odd leading dimension, or a base 4 bytes off).
GRANULES = [(16, 0, 0), (8, 2, 0), (8, 0, 2), (4, 1, 0), (4, 0, 1)]


@pytest.mark.parametrize("g,pad,offset", GRANULES)
@pytest.mark.parametrize("side", ["x", "w"])
def test_simt_kernel_copies_in_every_granule(cuda, g, pad, offset, side):
    """The operand copied as it is stored (a transposed x, a row-major w) in
    the granule the rule names from its base and leading dimension; the
    other one element by element."""
    rs = np.random.RandomState(g + pad + offset)
    m, k, n = 100, 300, 132
    if side == "x":          # x^T stored [k, m]
        x = _strided(rs, k, m, m + pad, offset, cuda).T
        w = _t(rs, (n, k), torch.float32, cuda, k ** -0.5).T
        want = (g, 4)
    else:
        x = _t(rs, (m, k), torch.float32, cuda)
        w = _strided(rs, k, n, n + pad, offset, cuda)
        want = (4, g)
    assert mm.simt_granules(x, w) == want
    cfg = mm.matmul.default_config(x, w)
    out = mm.matmul_cuda(x, w, **cfg)
    loop = mm.matmul_cuda(x, w, **cfg, force_loop=True)
    torch.cuda.synchronize()
    _close(out, mm.matmul_plain(x, w), torch.float32)
    assert torch.equal(out, loop)


@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("m,n", [(17, 300), (200, 130), (256, 1024)])
def test_simt_kernel_splits_a_long_k_deterministically(cuda, ta, tb, m, n):
    """Few rows over k = 16,384 (a short prefill's out_proj, narrower): the
    rule splits over k; two launches agree bit for bit."""
    k = 16384
    x, w = _simt_operands(np.random.RandomState(m + n), m, k, n, ta, tb, cuda)
    cfg = mm.matmul.default_config(x, w)
    p = mm.plan(x, w, cfg)
    assert p["kernel"] == "tile" and p["splits"] > 1
    kernels.reset_launch_counts()
    outs = [mm.matmul_cuda(x, w, **cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["matmul_splitk"] == 2
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], mm.matmul_plain(x, w), torch.float32)


@pytest.mark.parametrize("act", ["none", "gelu", "silu"])
@pytest.mark.parametrize("m,k,n", [(300, 333, 129), (40, 16384, 260)])
def test_simt_kernel_runs_the_fp32_epilogue(cuda, act, m, k, n):
    """matmul_bias_act's bias and activation on the register tiles' fp32
    accumulator (and, split over k, in the second pass)."""
    rs = np.random.RandomState(m + k)
    x = _t(rs, (m, k), torch.float32, cuda)
    w = _t(rs, (k, n), torch.float32, cuda, k ** -0.5)
    b = _t(rs, (n,), torch.float32, cuda, 0.5)
    cfg = fu.matmul_bias_act.default_config(x, w, b)
    p = mm.plan(x, w, cfg)
    assert p["kernel"] == "tile" and (p["splits"] > 1) == (k >= mm.LONG_K)
    kernels.reset_launch_counts()
    out = fu.matmul_bias_act_cuda(x, w, b, act=act, **cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["matmul_bias_act_simt_tile"] == 1
    _close(out, fu.matmul_bias_act_plain(x, w, b, act), torch.float32)


@pytest.mark.parametrize("form", ["x@w", "ct@wT", "xT@ct"])
@pytest.mark.parametrize("e,c,k,n", [(3, 37, 100, 130), (8, 640, 512, 264)])
def test_expert_gemm_fp32_takes_the_simt_kernel(cuda, form, e, c, k, n):
    """expert_gemm in fp32 on the register tiles: 3-D operands, their
    transposed (swapaxes) views, the batch stride in the copy granules."""
    rs = np.random.RandomState(e + c + k)
    if form == "x@w":
        x, w = _t(rs, (e, c, k), torch.float32, cuda), _t(rs, (e, k, n), torch.float32, cuda)
    elif form == "ct@wT":
        x = _t(rs, (e, c, n), torch.float32, cuda)
        w = _t(rs, (e, k, n), torch.float32, cuda).transpose(1, 2)
    else:
        x = _t(rs, (e, c, k), torch.float32, cuda).transpose(1, 2)
        w = _t(rs, (e, c, n), torch.float32, cuda)
    cfg = mg.expert_gemm.default_config(x, w)
    kernels.reset_launch_counts()
    out = mg.expert_gemm_cuda(x, w, **cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["expert_gemm_simt_tile"] == 1
    _close(out, mg.expert_gemm_plain(x, w), torch.float32)


def test_matmul_kernel_reads_a_row_stride(cuda):
    h = torch.randn(3, 17, 64, device=cuda, dtype=torch.bfloat16)
    x = h[:, -1]                                        # rows 17*64 apart
    w = torch.randn(64, 96, device=cuda, dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    _close(mm.matmul_cuda(x, w, bm=16, bn=64, bk=64, stages=2, splits=1), mm.matmul_plain(x, w),
           torch.bfloat16)
    assert kernels.launch_counts()["matmul_decode"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8, 896), (13, 100), (8192, 896), (1000, 33),
                                    (8192, 4096), (2048, 8192), (5, 20000)])
@pytest.mark.parametrize("block_rows", [None] + [c["block_rows"]
                                                 for c in rn.RMSNORM_SPACE.enumerate()])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, rows, d, block_rows):
    """Every config at the training widths (Mixtral's 4096, Jamba's 8192),
    an odd d (element loads) and a row too wide for registers (read twice,
    the partial accumulated in place)."""
    rs = np.random.RandomState(rows + d)
    x, w = _t(rs, (rows, d), dtype, cuda), _t(rs, (d,), dtype, cuda)
    ct = _t(rs, (rows, d), dtype, cuda)
    _, r = rn.rmsnorm_plain(x, w, 1e-6)
    cfg = {"block_rows": block_rows} if block_rows else rn.rmsnorm_bwd.default_config(ct, x, w, r)
    dx, dw = rn.rmsnorm_bwd_cuda(ct, x, w, r, **cfg)
    torch.cuda.synchronize()
    p_dx, p_dw = rn.rmsnorm_bwd_plain(ct, x, w, r)
    _close(dx, p_dx, dtype)
    # dw sums `rows` products in fp32 in another order
    _close(dw, p_dw, dtype)
    dx2, dw2 = rn.rmsnorm_bwd_cuda(ct, x, w, r, **cfg)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)     # no atomics: run to run equal


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 896), (16, 8192)])
def test_rmsnorm_bwd_kernel_reads_rows_one_element_off(cuda, dtype, rows, d):
    """ct, x and dx as contiguous views one element past an aligned base:
    every row takes element loads and stores."""
    rs = np.random.RandomState(d)
    off = lambda t: torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:].view(t.shape).copy_(t)
    x, ct = off(_t(rs, (rows, d), dtype, cuda)), off(_t(rs, (rows, d), dtype, cuda))
    w = _t(rs, (d,), dtype, cuda)
    assert x.data_ptr() % 16 and ct.data_ptr() % 16
    _, r = rn.rmsnorm_plain(x, w, 1e-6)
    dx, dw = rn.rmsnorm_bwd_cuda(ct, x, w, r, block_rows=8)
    torch.cuda.synchronize()
    p_dx, p_dw = rn.rmsnorm_bwd_plain(ct, x, w, r)
    _close(dx, p_dx, dtype)
    _close(dw, p_dw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,vocab", [(16, 640), (13, 100), (2048, 151936), (7, 5000)])
@pytest.mark.parametrize("config", [None, {"block_rows": 1, "block_v": 256},
                                    {"block_rows": 16, "block_v": 1024},
                                    {"block_rows": 16, "block_v": 2048}])
def test_xent_kernels_match_plain(cuda, dtype, rows, vocab, config):
    rs = np.random.RandomState(rows + vocab)
    logits = _t(rs, (rows, vocab), dtype, cuda, 2.0)
    labels = torch.from_numpy(rs.randint(0, vocab, rows)).to(cuda)
    cfg = config or xe.softmax_xent.default_config(logits, labels)
    loss, lse = xe.softmax_xent_cuda(logits, labels, **cfg)
    torch.cuda.synchronize()
    p_loss, p_lse = xe.softmax_xent_plain(logits, labels)
    # fp32 on both sides: 1e-4 absolute covers another order of the sum
    assert (loss - p_loss).abs().max().item() <= 1e-4 * max(1.0, p_loss.abs().max().item())
    assert (lse - p_lse).abs().max().item() <= 1e-4 * max(1.0, p_lse.abs().max().item())
    ct = torch.from_numpy(rs.randn(rows).astype(np.float32)).to(cuda)
    dl = xe.softmax_xent_bwd_cuda(ct, logits, labels, lse, **cfg)
    torch.cuda.synchronize()
    _close(dl, xe.softmax_xent_bwd_plain(ct, logits, labels, lse), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k,window,d,h,kv", FLASH_SHAPES[:5] + [(300, 300, 0, 64, 4, 2)]
                         + FLASH_SHAPES[5:])
@pytest.mark.parametrize("config", [None, {"block_q": 64, "block_k": 128},
                                    {"block_q": 128, "block_k": 64}])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, s_q, s_k, window, d, h, kv, config):
    rs = np.random.RandomState(s_q + s_k + d)
    q = _t(rs, (2, h, s_q, d), dtype, cuda)
    k, v = _t(rs, (2, kv, s_k, d), dtype, cuda), _t(rs, (2, kv, s_k, d), dtype, cuda)
    do = _t(rs, (2, h, s_q, d), dtype, cuda)
    o, lse = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    cfg = config or fa.flash_attention_bwd.default_config(do, q, k, v, o, lse)
    grads = fa.flash_attention_bwd_cuda(do, q, k, v, o, lse, causal=True, window=window, **cfg)
    torch.cuda.synchronize()
    plain = fa.flash_attention_bwd_plain(do, q, k, v, o, lse, causal=True, window=window)
    for g, p in zip(grads, plain):
        _close(g, p, dtype)


# Head dim 256 (PaliGemma's heads): (b, h, kv, s_q, s_k, window), the MQA
# group of 8 at a ragged length and windowed, s_q < s_k, and MHA.
D256_SHAPES = [(2, 8, 1, 300, 300, 0), (1, 8, 1, 200, 200, 64), (1, 8, 1, 77, 333, 0),
               (2, 4, 4, 129, 129, 0)]


def _d256(rs, b, h, kv, s_q, s_k, dtype, cuda):
    q = _t(rs, (b, h, s_q, 256), dtype, cuda)
    k, v = _t(rs, (b, kv, s_k, 256), dtype, cuda), _t(rs, (b, kv, s_k, 256), dtype, cuda)
    return q, k, v, _t(rs, (b, h, s_q, 256), dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s_q,s_k,window", D256_SHAPES)
@pytest.mark.parametrize("config", list(fa.ATTENTION_SPACE.enumerate()), ids=str)
def test_flash_d256_every_forward_config(cuda, dtype, b, h, kv, s_q, s_k, window, config):
    """Every config of the forward space at d = 256: a legal one launches
    and matches the plain version; one the legality check refuses raises
    before any launch (no fallback)."""
    rs = np.random.RandomState(s_q + s_k + h)
    q, k, v, _ = _d256(rs, b, h, kv, s_q, s_k, dtype, cuda)
    kernels.reset_launch_counts()
    if fa.flash_attention.why_illegal(config, q, k, v) is not None:
        with pytest.raises(ValueError, match="not legal at d=256"):
            fa.flash_attention_cuda(q, k, v, causal=True, window=window, **config)
        assert kernels.launch_counts().get("flash_attention", 0) == 0
        return
    out, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=window, **config)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    _close(out, p_out, dtype)
    assert (lse - p_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s_q,s_k,window", D256_SHAPES)
@pytest.mark.parametrize("config", list(fa.ATTENTION_BWD_SPACE.enumerate()), ids=str)
def test_flash_d256_every_backward_config(cuda, dtype, b, h, kv, s_q, s_k, window, config):
    rs = np.random.RandomState(s_q + s_k + h + 1)
    q, k, v, do = _d256(rs, b, h, kv, s_q, s_k, dtype, cuda)
    o, lse = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    kernels.reset_launch_counts()
    if fa.flash_attention_bwd.why_illegal(config, do, q, k, v, o, lse) is not None:
        with pytest.raises(ValueError, match="not legal at d=256"):
            fa.flash_attention_bwd_cuda(do, q, k, v, o, lse, causal=True, window=window,
                                        **config)
        assert kernels.launch_counts().get("flash_attention_bwd", 0) == 0
        return
    grads = fa.flash_attention_bwd_cuda(do, q, k, v, o, lse, causal=True, window=window,
                                        **config)
    torch.cuda.synchronize()
    plain = fa.flash_attention_bwd_plain(do, q, k, v, o, lse, causal=True, window=window)
    for g, p in zip(grads, plain):
        _close(g, p, dtype)


def test_dispatch_plane_gradcheck_on_the_card(cuda):
    """The autograd plane of kernel-mode dispatch, in f32 on the card: each
    forward tunable's gradient through its backward kernels against the
    reference path's autograd gradient."""
    from repro_torch.core.runtime import dispatch, runtime

    rs = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda).requires_grad_()
    cases = [
        ("matmul", (t(24, 40), t(40, 56)), {}),
        ("rmsnorm", (t(2, 9, 48), t(48)), {"eps": 1e-6}),
        ("flash_attention", (t(1, 4, 40, 16), t(1, 2, 40, 16), t(1, 2, 40, 16)),
         {"causal": True, "window": 0}),
    ]
    for name, args, kw in cases:
        grads = {}
        for mode in ("kernel", "reference"):
            with runtime(mode=mode) as rt:
                out = dispatch(name, *args, **kw)
                ct = torch.from_numpy(np.random.RandomState(1).randn(*out.shape)
                                      .astype(np.float32)).to(cuda)
                grads[mode] = torch.autograd.grad(out, args, ct)
            if mode == "kernel":
                assert rt.telemetry.phases["bwd"]
        for gk, gr in zip(grads["kernel"], grads["reference"]):
            _close(gk, gr, torch.float32)
    logits = t(12, 300)
    labels = torch.from_numpy(rs.randint(0, 300, 12)).to(cuda)
    gk = torch.autograd.grad(dispatch("softmax_xent", logits, labels).sum(), logits)[0]
    with runtime(mode="reference"):
        gr = torch.autograd.grad(dispatch("softmax_xent", logits, labels).sum(), logits)[0]
    _close(gk, gr, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 896, 4864), (5, 100, 37), (33, 64, 130),
                                   (300, 896, 4864), (1, 40, 1000)])
@pytest.mark.parametrize("act", ["none", "gelu", "silu"])
@pytest.mark.parametrize("config", [None, {"bm": 16, "bn": 128, "bk": 64, "stages": 4, "splits": 2},
                                    {"bm": 128, "bn": 128, "bk": 64, "stages": 4, "splits": 1}])
def test_matmul_bias_act_kernel_matches_plain(cuda, dtype, m, k, n, act, config):
    rs = np.random.RandomState(m + k + n)
    x, w = _t(rs, (m, k), dtype, cuda), _t(rs, (k, n), dtype, cuda, k ** -0.5)
    b = _t(rs, (n,), dtype, cuda, 0.5)
    cfg = config or fu.matmul_bias_act.default_config(x, w, b)
    out = fu.matmul_bias_act_cuda(x, w, b, act=act, **cfg)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    _close(out, fu.matmul_bias_act_plain(x, w, b, act), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,n", [(8, 896, 151936), (5, 100, 37), (33, 64, 130),
                                   (17, 896, 1000), (1, 33, 65), (130, 896, 4864)])
@pytest.mark.parametrize("config", [None, {"bm": 16, "bn": 64, "bk": 64, "stages": 4, "splits": 2},
                                    {"bm": 64, "bn": 128, "bk": 64, "stages": 4, "splits": 1}])
def test_rmsnorm_matmul_kernel_matches_plain(cuda, dtype, m, d, n, config):
    rs = np.random.RandomState(m + d + n)
    x = _t(rs, (m, d), dtype, cuda)
    s = (1 + 0.1 * _t(rs, (d,), torch.float32, cuda)).to(dtype)
    w = _t(rs, (d, n), dtype, cuda, d ** -0.5)
    cfg = config or fu.rmsnorm_matmul.default_config(x, s, w)
    out = fu.rmsnorm_matmul_cuda(x, s, w, **cfg)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    _close(out, fu.rmsnorm_matmul_plain(x, s, w), dtype)


# rmsnorm_matmul on every route: the decode and tc routes' norm prologue
# (one and two consumer warpgroups, split-k on both), the k-sliced loops
# (bf16 at d = 100, whose rows TMA cannot address; fp32 at every width),
# and force_loop's. n = 520 is no multiple of a tile.
RMM_ROUTE_CONFIGS = {
    "decode": {"bm": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1},
    "decode_splitk": {"bm": 16, "bn": 128, "bk": 64, "stages": 3, "splits": 4},
    "tc64": {"bm": 64, "bn": 128, "bk": 64, "stages": 4, "splits": 1},
    "tc128": {"bm": 128, "bn": 256, "bk": 64, "stages": 3, "splits": 1},
    "tc_splitk": {"bm": 128, "bn": 128, "bk": 128, "stages": 3, "splits": 2},
    "loop": {"bm": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", (100, 896, 4096, 8192))
@pytest.mark.parametrize("m", (1, 8, 13, 16, 64, 200))
@pytest.mark.parametrize("name", list(RMM_ROUTE_CONFIGS))
def test_rmsnorm_matmul_routes_match_plain(cuda, dtype, d, m, name):
    n = 520
    cfg = RMM_ROUTE_CONFIGS[name]
    rs = np.random.RandomState(m + d + len(name))
    x = _t(rs, (m, d), dtype, cuda)
    s = (1 + 0.1 * _t(rs, (d,), torch.float32, cuda)).to(dtype)
    w = _t(rs, (d, n), dtype, cuda, d ** -0.5)
    force = name == "loop"
    p = fu.rmm_plan(x, s, w, cfg, force)
    if dtype == torch.float32:
        want = "simt"
    elif d == 100 or force:
        want = "wmma"
    else:
        want = "decode" if cfg["bm"] == 16 else "tc"
    assert p["route"] == want
    kernels.reset_launch_counts()
    out = fu.rmsnorm_matmul_cuda(x, s, w, **cfg, force_loop=force)
    again = fu.rmsnorm_matmul_cuda(x, s, w, **cfg, force_loop=force)
    torch.cuda.synchronize()
    counts = {"rmsnorm_matmul": 2, f"rmsnorm_matmul_{want}": 2}
    if want == "simt":
        counts["rmsnorm_matmul_simt_loop"] = 2
    if p["splits"] > 1:
        counts["rmsnorm_matmul_splitk"] = 2
    assert kernels.launch_counts() == counts
    assert out.dtype == dtype and out.shape == (m, n)
    _close(out, fu.rmsnorm_matmul_plain(x, s, w), dtype)
    assert torch.equal(out, again)        # split-k sums in a fixed order: bitwise equal


def test_rmsnorm_matmul_takes_the_loop_for_an_unaligned_scale(cuda):
    """A scale one element past an aligned base is no TMA operand: the
    k-sliced WMMA loop, whatever the config."""
    rs = np.random.RandomState(7)
    x, w = _t(rs, (70, 896), torch.bfloat16, cuda), _t(rs, (896, 520), torch.bfloat16, cuda)
    s = (1 + 0.1 * _t(rs, (897,), torch.float32, cuda)).to(torch.bfloat16)[1:]
    assert s.data_ptr() % 16
    for cfg in (RMM_ROUTE_CONFIGS["decode"], RMM_ROUTE_CONFIGS["tc128"]):
        kernels.reset_launch_counts()
        out = fu.rmsnorm_matmul_cuda(x, s, w, **cfg)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {"rmsnorm_matmul": 1, "rmsnorm_matmul_wmma": 1}
        _close(out, fu.rmsnorm_matmul_plain(x, s, w), torch.bfloat16)


def test_fused_wrappers_count_their_launches(cuda):
    kernels.reset_launch_counts()
    x, w = torch.randn(4, 64, device=cuda), torch.randn(64, 32, device=cuda)
    cfg = {"bm": 16, "bn": 64, "bk": 64, "stages": 4, "splits": 1}
    fu.matmul_bias_act(x, w, torch.zeros(32, device=cuda), act="silu", **cfg)
    fu.rmsnorm_matmul(x, torch.ones(64, device=cuda), w, **cfg)
    fu.matmul_bias_act_plain(x, w, torch.zeros(32, device=cuda), "silu")
    fu.rmsnorm_matmul_plain(x, torch.ones(64, device=cuda), w)
    assert kernels.launch_counts() == {**_route_counts("matmul_bias_act", x, w, cfg),
                                       "rmsnorm_matmul": 1, "rmsnorm_matmul_simt": 1,
                                       "rmsnorm_matmul_simt_loop": 1}
    assert kernels.launch_counts()["matmul_bias_act_simt"] == 1


# matmul_bias_act on every route of gemm.cuh: tc with one and two consumer
# warpgroups, decode, split-k on both, WMMA through an x whose base is not
# 16-byte aligned; fp32 takes SIMT (the row kernel up to 16 rows). k = 328
# is no multiple of a k slice; n = 37 and 130 read a weight stored
# transposed (its rows of k are aligned), n = 4864 a row-major one.
MBA_ROUTE_CONFIGS = {
    "tc64": {"bm": 64, "bn": 128, "bk": 64, "stages": 4, "splits": 1},
    "tc128": {"bm": 128, "bn": 256, "bk": 64, "stages": 3, "splits": 1},
    "decode": {"bm": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1},
    "splitk": {"bm": 16, "bn": 128, "bk": 64, "stages": 3, "splits": 2},
    "tc_splitk": {"bm": 128, "bn": 128, "bk": 64, "stages": 4, "splits": 4},
    "wmma": {"bm": 64, "bn": 128, "bk": 64, "stages": 4, "splits": 1},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "gelu", "silu"])
@pytest.mark.parametrize("m", (1, 8, 13, 16, 17, 64, 300))
@pytest.mark.parametrize("n", (37, 130, 4864))
@pytest.mark.parametrize("name", list(MBA_ROUTE_CONFIGS))
def test_matmul_bias_act_routes_match_plain(cuda, dtype, act, m, n, name):
    k = 328
    cfg = MBA_ROUTE_CONFIGS[name]
    rs = np.random.RandomState(m + n + len(name))
    if name == "wmma":          # an offset view: a base TMA cannot address
        x = _t(rs, (m * k + 1,), dtype, cuda)[1:].view(m, k)
    else:
        x = _t(rs, (m, k), dtype, cuda)
    w = (_t(rs, (k, n), dtype, cuda, k ** -0.5) if n == 4864
         else _t(rs, (n, k), dtype, cuda, k ** -0.5).T)
    # tc128 reads a bias one element past an aligned base (the tc epilogue's
    # element loads); the other routes an aligned one (bf16 pairs at even n)
    b = _t(rs, (n + 1,), dtype, cuda, 0.5)
    b = b[1:] if name == "tc128" else b[:n]
    if dtype == torch.float32:
        want = "simt"
    elif name == "wmma":
        want = "wmma"
    else:
        want = "decode" if cfg["bm"] == 16 else "tc"
    assert mm.plan(x, w, cfg)["route"] == want
    kernels.reset_launch_counts()
    out = fu.matmul_bias_act_cuda(x, w, b, act=act, **cfg)
    again = fu.matmul_bias_act_cuda(x, w, b, act=act, **cfg)
    torch.cuda.synchronize()
    want_counts = _route_counts("matmul_bias_act", x, w, cfg)
    assert kernels.launch_counts() == {key: 2 * v for key, v in want_counts.items()}
    assert out.dtype == dtype and out.shape == (m, n)
    _close(out, fu.matmul_bias_act_plain(x, w, b, act), dtype)
    assert torch.equal(out, again)        # split-k sums in a fixed order: bitwise equal


# Outputs of matmul and expert_gemm at a few shapes on each route, recorded
# (sha256 of the output's bytes, first 16 hex digits) from the gemm before it
# gained the epilogue (commit 93dbbb1, NVIDIA H100 80GB HBM3): a null epilogue
# must leave every bit as it was. The inputs come from numpy's seeded
# generator, so every run rebuilds them exactly.
def _null_epilogue_cases():
    """(name, kernel, dtype, shapes and layout, config) of each recorded case."""
    bf, f32 = torch.bfloat16, torch.float32
    tc = {"bm": 128, "bn": 256, "bk": 64, "stages": 3, "splits": 1}
    return [
        ("matmul_tc_bm128", "matmul", bf, (300, 328, 4864, False, False), tc),
        ("matmul_tc_bm64_transposed", "matmul", bf, (200, 896, 130, True, True),
         {"bm": 64, "bn": 128, "bk": 64, "stages": 4, "splits": 1}),
        ("matmul_tc_splitk", "matmul", bf, (2048, 8192, 136, False, True),
         {"bm": 128, "bn": 128, "bk": 64, "stages": 4, "splits": 4}),
        ("matmul_decode", "matmul", bf, (8, 896, 4864, False, False),
         {"bm": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1}),
        ("matmul_decode_splitk", "matmul", bf, (13, 4096, 1000, False, True),
         {"bm": 16, "bn": 128, "bk": 64, "stages": 3, "splits": 8}),
        ("matmul_wmma", "matmul", bf, (37, 100, 45, False, False), tc),
        ("matmul_simt", "matmul", f32, (300, 328, 200, False, False), tc),
        ("matmul_simt_rows_splitk", "matmul", f32, (8, 16384, 1024, False, False), tc),
        ("expert_gemm_decode", "expert_gemm", bf, (8, 2, 4096, 1024, False, False),
         {"bc": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1}),
        ("expert_gemm_tc_transposed", "expert_gemm", bf, (3, 40, 896, 520, True, False),
         {"bc": 128, "bn": 128, "bk": 64, "stages": 4, "splits": 2}),
    ]


def _null_epilogue_output(kernel, dtype, shape, cfg, device):
    if kernel == "matmul":
        m, k, n, ta, tb = shape
        rs = np.random.RandomState(m * 7 + k * 3 + n)
        x = _t(rs, (k, m) if ta else (m, k), dtype, device)
        w = _t(rs, (n, k) if tb else (k, n), dtype, device, k ** -0.5)
        return mm.matmul_cuda(x.T if ta else x, w.T if tb else w, **cfg)
    e, c, k, n, tx, tw = shape
    rs = np.random.RandomState(e + c * 7 + k * 3 + n)
    x = _t(rs, (e, k, c) if tx else (e, c, k), dtype, device)
    w = _t(rs, (e, n, k) if tw else (e, k, n), dtype, device, k ** -0.5)
    return mg.expert_gemm_cuda(x.transpose(1, 2) if tx else x, w.transpose(1, 2) if tw else w,
                               **cfg)


def _digest(y):
    import hashlib

    bits = y.contiguous().view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


def gemm_digests(device="cuda"):
    """{case: digest} of every recorded case on this checkout's kernels (how
    NULL_EPILOGUE_DIGESTS was made, on the kernels of that commit)."""
    return {name: _digest(_null_epilogue_output(kernel, dtype, shape, cfg, device))
            for name, kernel, dtype, shape, cfg in _null_epilogue_cases()}


NULL_EPILOGUE_DIGESTS = {
    "matmul_tc_bm128": "1e55b70076570558",
    "matmul_tc_bm64_transposed": "2a6dc5e26677caf2",
    "matmul_tc_splitk": "1af60bd2a6a4b7cb",
    "matmul_decode": "738866cfb55814b8",
    "matmul_decode_splitk": "50762bcc6fe62760",
    "matmul_wmma": "1b5b702e146d2691",
    "matmul_simt": "01cb9780a472865f",
    "matmul_simt_rows_splitk": "f2fa141be429a268",
    "expert_gemm_decode": "7e1c976ac0470272",
    "expert_gemm_tc_transposed": "1cc992f28a0b3e97",
}


@pytest.mark.parametrize("case", [c[0] for c in _null_epilogue_cases()])
def test_null_epilogue_leaves_matmul_and_expert_gemm_bit_equal(cuda, case):
    name, kernel, dtype, shape, cfg = next(c for c in _null_epilogue_cases() if c[0] == case)
    y = _null_epilogue_output(kernel, dtype, shape, cfg, cuda)
    again = _null_epilogue_output(kernel, dtype, shape, cfg, cuda)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert _digest(y) == NULL_EPILOGUE_DIGESTS[case]


# Outputs of matmul_bias_act on each route, recorded (as above) from the
# kernels before the norm prologue existed (commit 8723075, NVIDIA H100
# 80GB HBM3, 700 W; prologue_digests() run on that tree): the prologue is a
# template parameter of gemm.cuh's kernels that only rmsnorm_matmul
# instantiates, and must leave every bit of the other libraries as it was
# (matmul's and expert_gemm's are held by NULL_EPILOGUE_DIGESTS, on the same
# kernels).
def _null_prologue_cases():
    """(name, dtype, (m, k, n, w stored transposed), activation, config)."""
    bf, f32 = torch.bfloat16, torch.float32
    tc = {"bm": 128, "bn": 256, "bk": 64, "stages": 3, "splits": 1}
    return [
        ("mba_tc_bm128_silu", bf, (300, 328, 4864, False), "silu", tc),
        ("mba_tc_bm64_transposed_gelu", bf, (200, 896, 130, True), "gelu",
         {"bm": 64, "bn": 128, "bk": 64, "stages": 4, "splits": 1}),
        ("mba_tc_splitk_none", bf, (2048, 8192, 136, True), "none",
         {"bm": 128, "bn": 128, "bk": 64, "stages": 4, "splits": 4}),
        ("mba_decode_silu", bf, (8, 896, 4864, False), "silu",
         {"bm": 16, "bn": 64, "bk": 128, "stages": 4, "splits": 1}),
        ("mba_decode_splitk_gelu", bf, (13, 4096, 1000, True), "gelu",
         {"bm": 16, "bn": 128, "bk": 64, "stages": 3, "splits": 8}),
        ("mba_wmma_silu", bf, (37, 100, 45, False), "silu", tc),
        ("mba_simt_gelu", f32, (300, 328, 200, False), "gelu", tc),
        ("mba_simt_rows_silu", f32, (8, 4096, 1024, False), "silu", tc),
    ]


def _null_prologue_output(dtype, shape, act, cfg, device):
    m, k, n, tb = shape
    rs = np.random.RandomState(m * 7 + k * 3 + n + 1)
    x = _t(rs, (m, k), dtype, device)
    w = _t(rs, (n, k) if tb else (k, n), dtype, device, k ** -0.5)
    b = _t(rs, (n,), dtype, device, 0.5)
    return fu.matmul_bias_act_cuda(x, w.T if tb else w, b, act=act, **cfg)


def prologue_digests(device="cuda"):
    """{case: digest} of every matmul_bias_act case on this checkout's
    kernels (how NULL_PROLOGUE_DIGESTS was made, on the kernels of that
    commit)."""
    return {name: _digest(_null_prologue_output(dtype, shape, act, cfg, device))
            for name, dtype, shape, act, cfg in _null_prologue_cases()}


NULL_PROLOGUE_DIGESTS = {
    "mba_tc_bm128_silu": "ce9b807ae7fde9d9",
    "mba_tc_bm64_transposed_gelu": "eb5dda42d3a41eb7",
    "mba_tc_splitk_none": "d9115c0fa14f95ea",
    "mba_decode_silu": "c51b52312dbf279e",
    "mba_decode_splitk_gelu": "ee8f15a3f8550006",
    "mba_wmma_silu": "92205f282ee1e509",
    "mba_simt_gelu": "9c2ea2bdc12aa420",
    "mba_simt_rows_silu": "4eae56bc9add96e2",
}


@pytest.mark.parametrize("case", [c[0] for c in _null_prologue_cases()])
def test_null_prologue_leaves_matmul_bias_act_bit_equal(cuda, case):
    name, dtype, shape, act, cfg = next(c for c in _null_prologue_cases() if c[0] == case)
    y = _null_prologue_output(dtype, shape, act, cfg, cuda)
    again = _null_prologue_output(dtype, shape, act, cfg, cuda)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert _digest(y) == NULL_PROLOGUE_DIGESTS[case]


def test_wallclock_evaluator_on_the_card(cuda):
    """CUDA-event timing of a kernel variant behind the correctness gate; a
    ring too large for shared memory is a refused launch, pruned with its
    CUDA code; a wrong variant fails the gate."""
    from repro_torch.core.evaluate import REFUSED_LAUNCH_CODES, WallClockEvaluator

    rs = np.random.RandomState(0)
    x, s = _t(rs, (64, 896), torch.bfloat16, cuda), _t(rs, (896,), torch.bfloat16, cuda)
    w = _t(rs, (896, 512), torch.bfloat16, cuda, 896 ** -0.5)
    ref = fu.rmsnorm_matmul_plain(x, s, w)
    cfg = fu.rmsnorm_matmul.default_config(x, s, w)
    ev = WallClockEvaluator(repeats=3, warmup=1)
    ok = ev.evaluate(lambda *a: fu.rmsnorm_matmul_cuda(*a, **cfg), (x, s, w), ref)
    assert ok.ok and 0 < ok.objective < 1.0 and len(ok.meta["times"]) == 3
    # the tc route at 128 x 256 tiles in k slices of 128, a ring of 6: 576 KB
    big_cfg = {"bm": 128, "bn": 256, "bk": 128, "stages": 6, "splits": 1}
    big = ev.evaluate(lambda *a: fu.rmsnorm_matmul_cuda(*a, **big_cfg), (x, s, w), ref)
    assert not big.ok and big.error.startswith("refused launch")
    assert any(f"CUDA error {c})" in big.error for c in REFUSED_LAUNCH_CODES)
    bad = ev.evaluate(lambda *a: fu.rmsnorm_matmul_cuda(*a, **cfg) * 1.1, (x, s, w), ref)
    assert not bad.ok and bad.error == "correctness gate failed"
    # the card still runs after the refused launch
    again = fu.rmsnorm_matmul_cuda(x, s, w, **cfg)
    torch.cuda.synchronize()
    _close(again, ref, torch.bfloat16)


def test_fused_dispatch_gradients_on_the_card(cuda):
    """The fused tunables' backward plans (matmul, rmsnorm, rmsnorm_bwd
    dispatch sites) against the reference path's autograd gradients."""
    from repro_torch.core.runtime import dispatch, runtime

    rs = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda).requires_grad_()
    cases = [
        ("matmul_bias_act", (t(24, 40), t(40, 56), t(56)), {"act": "silu"}),
        ("matmul_bias_act", (t(2, 9, 40), t(40, 56), t(56)), {"act": "gelu"}),
        ("rmsnorm_matmul", (t(2, 9, 48), (1 + 0.1 * t(48)).detach().requires_grad_(),
                            t(48, 40)), {"eps": 1e-6}),
    ]
    for name, args, kw in cases:
        grads = {}
        for mode in ("kernel", "reference"):
            with runtime(mode=mode):
                out = dispatch(name, *args, **kw)
                ct = torch.from_numpy(np.random.RandomState(1).randn(*out.shape)
                                      .astype(np.float32)).to(cuda)
                grads[mode] = torch.autograd.grad(out, args, ct)
        for gk, gr in zip(grads["kernel"], grads["reference"]):
            _close(gk, gr, torch.float32)


# ---------------------------------------------------------------------------
# Selective scan: every legal config of both spaces on ragged shapes
# ---------------------------------------------------------------------------

SCAN_CONFIGS = list(ss.SSM_SCAN_SPACE.enumerate())
UPDATE_CONFIGS = list(ss.SSM_UPDATE_SPACE.enumerate())


def _ssm_inputs(rs, lead, di, ds, dtype, device):
    """The mixer's ranges: dt > 0 after softplus, A < 0, a nonzero carry."""
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return (f(rs.randn(*lead, di) * 0.5).to(dtype), f(np.abs(rs.randn(*lead, di)) * 0.1 + 0.01),
            f(rs.randn(*lead, ds) * 0.5), f(rs.randn(*lead, ds) * 0.5),
            f(-np.abs(rs.randn(di, ds)) - 0.1), f(rs.randn(lead[0], di, ds) * 0.3))


def _scan_matches_plain(args, config):
    """One launch of ``config`` on ``args``: its counters (the kernel and the
    loader the rule names), y and the final state against the plain version
    (fp32 on both sides: f32 tolerance, xc in either dtype, the plain version
    widening the same bf16 values), and a second launch bit for bit equal."""
    kernels.reset_launch_counts()
    y, hn = ss.ssm_scan_cuda(*args, **config)
    torch.cuda.synchronize()
    ld = ss.loader(*args[:4])
    assert kernels.launch_counts() == {"ssm_scan": 1, f"ssm_scan_{ld}": 1}
    p_y, p_h = ss.ssm_scan_plain(*args)
    assert y.dtype == hn.dtype == torch.float32
    _close(y, p_y, torch.float32)
    _close(hn, p_h, torch.float32)
    y2, hn2 = ss.ssm_scan_cuda(*args, **config)
    assert torch.equal(y, y2) and torch.equal(hn, hn2)
    return ld


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,di,ds", [(1, 37, 100, 16), (2, 129, 300, 16), (3, 1, 33, 4),
                                       (1, 64, 64, 7)])
@pytest.mark.parametrize("config", SCAN_CONFIGS, ids=ss.SSM_SCAN_SPACE.config_key)
def test_ssm_scan_kernel_matches_plain(cuda, dtype, b, s, di, ds, config):
    """Ragged shapes: d_inner no block_d divides, s shorter than a slice or
    not a multiple of it, 4 and 7 states, rows of every cp.async granule
    (bf16 d_inner 33: element copies) and TMA's (fp32 d_inner 100, 300)."""
    _scan_matches_plain(_ssm_inputs(np.random.RandomState(s + di), (b, s), di, ds, dtype, cuda),
                        config)


@pytest.mark.parametrize("di,want", [(16384, "tma"), (16380, "cpasync")])
@pytest.mark.parametrize("config", SCAN_CONFIGS, ids=ss.SSM_SCAN_SPACE.config_key)
def test_ssm_scan_kernel_at_the_hybrids_width(cuda, di, want, config):
    """Jamba's d_inner in bf16 (TMA) and a ragged prefill's 16380 (32,760-byte
    rows: cp.async), over a few slices of every config."""
    args = _ssm_inputs(np.random.RandomState(di), (1, 40), di, 16, torch.bfloat16, cuda)
    assert _scan_matches_plain(args, config) == want


def test_ssm_scan_kernel_reads_views_one_element_off(cuda):
    """xc and dt one element past an aligned base: the cp.async loader in
    its narrowest granules (2-byte element copies for bf16 xc)."""
    xc, dt, B, C, A, h0 = _ssm_inputs(np.random.RandomState(3), (2, 50), 256, 16,
                                      torch.bfloat16, cuda)
    off = lambda t: torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(
        t.shape).copy_(t)
    args = (off(xc), off(dt), B, C, A, h0)
    cfg = ss.ssm_scan.default_config(*args)
    assert _scan_matches_plain(args, cfg) == "cpasync"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,di,ds", [(8, 16384, 16), (3, 100, 16), (1, 33, 5)])
@pytest.mark.parametrize("config", UPDATE_CONFIGS, ids=ss.SSM_UPDATE_SPACE.config_key)
def test_ssm_update_kernel_matches_plain(cuda, dtype, b, di, ds, config):
    args = _ssm_inputs(np.random.RandomState(b + di), (b,), di, ds, dtype, cuda)
    y, hn = ss.ssm_update_cuda(*args, **config)
    torch.cuda.synchronize()
    p_y, p_h = ss.ssm_update_plain(*args)
    _close(y, p_y, torch.float32)
    _close(hn, p_h, torch.float32)


def test_ssm_update_unaligned_rows_match_plain(cuda):
    """B, C and the state as contiguous views 4 bytes past an aligned base:
    the kernel takes its scalar path there, its 16-byte one otherwise."""
    xc, dt, B, C, A, h = _ssm_inputs(np.random.RandomState(1), (3,), 100, 16, torch.float32,
                                     cuda)
    shifted = lambda t: torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)
    args = (xc, dt, shifted(B), shifted(C), A, shifted(h))
    assert all(a.is_contiguous() for a in args) and args[2].data_ptr() % 16 == 4
    y, hn = ss.ssm_update_cuda(*args, block_b=2, block_d=32, lanes=4)
    torch.cuda.synchronize()
    p_y, p_h = ss.ssm_update_plain(*args)
    _close(y, p_y, torch.float32)
    _close(hn, p_h, torch.float32)


def _shifted(t, device):
    """A contiguous copy of t one element past a 16-byte aligned base."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=device)[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("di", [16380, 100])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("config", UPDATE_CONFIGS, ids=ss.SSM_UPDATE_SPACE.config_key)
def test_ssm_update_every_config_on_ragged_rows(cuda, b, di, aligned, config):
    """Every config of the space at the pool's row counts (one, a ragged
    three, eight) over a d_inner no block_d divides, the 16-byte path and
    (B, C, the state and xc one element off) the element path: y and
    h_new within the f32 tolerance (y sums over the lanes in another order),
    two launches bit-equal."""
    args = _ssm_inputs(np.random.RandomState(b + di), (b,), di, 16, torch.bfloat16, cuda)
    if not aligned:
        args = tuple(_shifted(a, cuda) if i in (0, 2, 3, 5) else a for i, a in enumerate(args))
        assert args[5].data_ptr() % 16 and args[2].data_ptr() % 16
    y, hn = ss.ssm_update_cuda(*args, **config)
    y2, hn2 = ss.ssm_update_cuda(*args, **config)
    torch.cuda.synchronize()
    p_y, p_h = ss.ssm_update_plain(*args)
    _close(y, p_y, torch.float32)
    _close(hn, p_h, torch.float32)
    assert torch.equal(y, y2) and torch.equal(hn, hn2)


@pytest.mark.parametrize("di,want", [(256, "tma"), (250, "cpasync")])
def test_ssm_scan_kernel_mode_gradient_matches_plain_autograd(cuda, di, want):
    """A kernel-mode dispatch of the scan on the card, differentiated: the
    forward launches the kernel (on the loader its rows take), the backward
    plan dispatches ssm_scan_bwd; every gradient, xc's in bf16, against
    autograd through the plain version (f32 tolerance; bf16's for xc)."""
    import repro_torch

    args = _ssm_inputs(np.random.RandomState(di), (2, 45), di, 16, torch.bfloat16, cuda)
    assert ss.loader(*args[:4]) == want
    rs = np.random.RandomState(1)
    ct_y = torch.from_numpy(rs.randn(2, 45, di).astype(np.float32)).to(cuda)
    ct_h = torch.from_numpy(rs.randn(2, di, 16).astype(np.float32)).to(cuda)
    leaves = [a.clone().requires_grad_() for a in args]
    kernels.reset_launch_counts()
    with repro_torch.runtime(mode="kernel") as rt:
        y, h = repro_torch.dispatch("ssm_scan", *leaves)
        got = torch.autograd.grad((y, h), leaves, (ct_y, ct_h))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"ssm_scan": 1, f"ssm_scan_{want}": 1}
    assert any(k.startswith("ssm_scan_bwd|")
               for k in rt.telemetry.snapshot()["by_key_phase"]["bwd"])
    plain = [a.clone().requires_grad_() for a in args]
    p_y, p_h = ss.ssm_scan_plain(*plain)
    wants = torch.autograd.grad((p_y, p_h), plain, (ct_y, ct_h))
    assert got[0].dtype == torch.bfloat16
    for g, w in zip(got, wants):
        _close(g, w, g.dtype)


@pytest.mark.parametrize("b,s,di", [(2, 300, 512), (1, 77, 250)])
def test_ssm_scan_bwd_on_the_card_matches_the_oracle(cuda, b, s, di):
    """The backward tunable (torch code) on card tensors at its heuristic
    chunk and at 8 and 512, against the autograd oracle (f32 tolerance;
    the oracle's d_xc is bf16, so bf16's there)."""
    from repro_torch.kernels import ref

    args = _ssm_inputs(np.random.RandomState(s), (b, s), di, 16, torch.bfloat16, cuda)
    rs = np.random.RandomState(2)
    cts = (torch.from_numpy(rs.randn(b, s, di).astype(np.float32)).to(cuda),
           torch.from_numpy(rs.randn(b, di, 16).astype(np.float32)).to(cuda))
    wants = ref.ssm_scan_bwd(*cts, *args)
    for cfg in (ss.ssm_scan_bwd.default_config(*cts, *args), {"chunk": 8}, {"chunk": 512}):
        got = ss.ssm_scan_bwd(*cts, *args, **cfg)
        assert all(g.is_cuda for g in got)
        for g, w in zip(got, wants):
            _close(g, w, w.dtype)


def test_ssm_wrappers_count_only_kernel_launches(cuda):
    args = _ssm_inputs(np.random.RandomState(0), (1, 9), 64, 16, torch.float32, cuda)
    kernels.reset_launch_counts()
    ss.ssm_scan(*args)
    ss.ssm_scan_plain(*args)
    ss.ssm_update(*(a[:, 0] if a.dim() == 3 and i < 4 else a for i, a in enumerate(args)))
    ss.ssm_scan(*(a.cpu() for a in args))
    assert kernels.launch_counts() == {"ssm_scan": 1, "ssm_scan_tma": 1, "ssm_update": 1}


def test_reduced_hybrid_on_card_matches_cpu(cuda):
    """Reduced Jamba without experts (16 layers, f32): a prefill at an exact
    ragged length and two decode steps on the card against the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig

    cfg = dataclasses.replace(get_config("jamba_1_5_large").reduced(), num_experts=0,
                              experts_per_token=0)
    params = lm.init_params(cfg, seed=0, device="cpu")
    to = lambda t: t.to(cuda) if isinstance(t, torch.Tensor) else (
        {k: to(v) for k, v in t.items()} if isinstance(t, dict) else type(t)(to(v) for v in t))
    on_card = to(params)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 29)))
    run = RunConfig(q_chunk=16, k_chunk=16)
    kernels.reset_launch_counts()
    logits = {}
    with torch.inference_mode():
        for name, p, dev in (("gpu", on_card, cuda), ("cpu", params, "cpu")):
            lg, caches = lm.prefill(p, {"tokens": toks.to(dev)}, cfg, run, cache_len=48)
            out = [lg]
            for step in range(2):
                lg, caches = lm.decode_step(p, torch.tensor([[step + 3]], device=dev), caches,
                                            torch.tensor([29 + step], device=dev), cfg, run)
                out.append(lg)
            logits[name] = torch.cat(out).cpu()
    assert kernels.launch_counts()["ssm_scan"] == 14
    assert kernels.launch_counts()["ssm_update"] == 28
    # 16 layers of fp32 sums in another order: 1e-4 of max|logit|
    err = (logits["gpu"] - logits["cpu"]).abs().max().item()
    assert err <= 1e-4 * logits["cpu"].abs().max().item(), err


EGEMM_CONFIGS = [None, {"bc": 16, "bn": 128, "bk": 128, "stages": 3, "splits": 4},
                 {"bc": 128, "bn": 128, "bk": 64, "stages": 4, "splits": 2}]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,k,n", [(8, 2, 4096, 1024), (3, 37, 100, 130), (4, 7, 5, 9),
                                     (2, 12, 16, 8), (1, 33, 64, 130), (8, 40, 896, 512)])
@pytest.mark.parametrize("config", EGEMM_CONFIGS)
def test_expert_gemm_kernel_matches_plain(cuda, dtype, e, c, k, n, config):
    rs = np.random.RandomState(e + c + k + n)
    x, w = _t(rs, (e, c, k), dtype, cuda), _t(rs, (e, k, n), dtype, cuda, k ** -0.5)
    cfg = config or mg.expert_gemm.default_config(x, w)
    kernels.reset_launch_counts()
    out = mg.expert_gemm_cuda(x, w, **cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == _route_counts("expert_gemm", x, w, cfg)
    assert out.dtype == dtype and out.shape == (e, c, n)
    _close(out, mg.expert_gemm_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["ct@wT", "xT@ct", "broadcast_x"])
@pytest.mark.parametrize("e,c,k,n", [(8, 40, 896, 520), (3, 37, 100, 130), (2, 2, 64, 33)])
@pytest.mark.parametrize("config", EGEMM_CONFIGS)
def test_expert_gemm_kernel_reads_transposed_operands(cuda, dtype, form, e, c, k, n, config):
    """The backward's swapaxes views, read in place: dx = ct[e,c,n] @
    swapaxes(w)[e,n,k] and dw = swapaxes(x)[e,k,c] @ ct[e,c,n]; and the
    dense dispatch's operand broadcast over the experts (stride 0)."""
    rs = np.random.RandomState(e * c + n)
    if form == "ct@wT":
        a = _t(rs, (e, c, n), dtype, cuda)
        b = _t(rs, (e, k, n), dtype, cuda, n ** -0.5).transpose(1, 2)
    elif form == "xT@ct":
        a = _t(rs, (e, c, k), dtype, cuda).transpose(1, 2)
        b = _t(rs, (e, c, n), dtype, cuda, c ** -0.5)
    else:
        a = _t(rs, (c, k), dtype, cuda)[None].expand(e, c, k)
        b = _t(rs, (e, k, n), dtype, cuda, k ** -0.5)
    cfg = config or mg.expert_gemm.default_config(a, b)
    kernels.reset_launch_counts()
    out = mg.expert_gemm_cuda(a, b, **cfg)
    torch.cuda.synchronize()
    want = _route_counts("expert_gemm", a, b, cfg)
    assert want.get("expert_gemm_transposed", 0) == int(form != "broadcast_x")
    assert kernels.launch_counts() == want
    _close(out, mg.expert_gemm_plain(a, b), dtype)


EGEMM_ROUTE_CONFIGS = [None, {"bc": 16, "bn": 64, "bk": 128, "stages": 3, "splits": 2},
                       {"bc": 64, "bn": 256, "bk": 64, "stages": 3, "splits": 1}]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["x@w", "ct@wT", "xT@ct", "broadcast_x"])
@pytest.mark.parametrize("c", ROUTE_ROWS)
@pytest.mark.parametrize("config", EGEMM_ROUTE_CONFIGS)
def test_expert_gemm_routes_match_plain(cuda, dtype, form, c, config):
    """Every route at every decode and first prefill capacity, on the
    backward's swapaxes views and a broadcast x (expert stride 0, a 2-D
    tensor map), over 3 experts with k = 136 and n = 200 ragged."""
    e, k, n = 3, 136, 200
    rs = np.random.RandomState(c + len(form))
    if form == "xT@ct":
        a = _t(rs, (e, k, c), dtype, cuda).transpose(1, 2)
    elif form == "broadcast_x":
        a = _t(rs, (c, k), dtype, cuda)[None].expand(e, c, k)
    else:
        a = _t(rs, (e, c, k), dtype, cuda)
    b = (_t(rs, (e, n, k), dtype, cuda, k ** -0.5).transpose(1, 2) if form == "ct@wT"
         else _t(rs, (e, k, n), dtype, cuda, k ** -0.5))
    cfg = config or mg.expert_gemm.default_config(a, b)
    # the transposed x of a capacity 2 to 15 but 8 has a leading dim and an
    # expert stride TMA cannot take: WMMA
    if dtype == torch.float32:
        want = "simt"
    elif form == "xT@ct" and c > 1 and c % 8:
        want = "wmma"
    else:
        want = "decode" if cfg["bc"] == 16 else "tc"
    kernels.reset_launch_counts()
    out = mg.expert_gemm_cuda(a, b, **cfg)
    again = mg.expert_gemm_cuda(a, b, **cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["expert_gemm"] == 2 and counts[f"expert_gemm_{want}"] == 2
    _close(out, mg.expert_gemm_plain(a, b), dtype)
    assert torch.equal(out, again)


def test_expert_gemm_wrapper_counts_and_raises(cuda):
    x, w = torch.randn(2, 5, 16, device=cuda), torch.randn(2, 16, 8, device=cuda)
    kernels.reset_launch_counts()
    mg.expert_gemm(x, w)
    mg.expert_gemm_plain(x, w)
    mg.expert_gemm(x.cpu(), w.cpu())
    assert kernels.launch_counts() == _route_counts("expert_gemm", x, w,
                                                    mg.expert_gemm.default_config(x, w))
    with pytest.raises(ValueError):
        mg.expert_gemm(x, torch.randn(2, 16, 16, device=cuda)[:, :, ::2])


def test_reduced_mixtral_on_card_matches_cpu(cuda):
    """Reduced Mixtral-8x7B (2 layers, 4 experts top-2, f32): a bucketed
    prefill and two decode steps on the card against the CPU, every expert
    gemm through the kernel (3 a layer a call)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig

    cfg = get_config("mixtral_8x7b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    to = lambda t: t.to(cuda) if isinstance(t, torch.Tensor) else (
        {k: to(v) for k, v in t.items()} if isinstance(t, dict) else type(t)(to(v) for v in t))
    on_card = to(params)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 32)))
    run = RunConfig(q_chunk=16, k_chunk=16)
    kernels.reset_launch_counts()
    logits = {}
    with torch.inference_mode():
        for name, p, dev in (("gpu", on_card, cuda), ("cpu", params, "cpu")):
            lg, caches = lm.prefill(p, {"tokens": toks.to(dev)}, cfg, run, cache_len=48,
                                    true_len=29)
            out = [lg]
            for step in range(2):
                lg, caches = lm.decode_step(p, torch.tensor([[step + 3]], device=dev), caches,
                                            torch.tensor([29 + step], device=dev), cfg, run)
                out.append(lg)
            logits[name] = torch.cat(out).cpu()
    assert kernels.launch_counts()["expert_gemm"] == 3 * cfg.num_layers * 3
    # 2 layers of fp32 sums in another order, routes equal: 1e-4 of max|logit|
    err = (logits["gpu"] - logits["cpu"]).abs().max().item()
    assert err <= 1e-4 * logits["cpu"].abs().max().item(), err
