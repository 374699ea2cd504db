"""Blocked matmul: the ``matmul`` tunable and its CUDA kernels.

Replaces the TPU kernel ``repro/kernels/matmul.py:_matmul_kernel``
(``matmul_pallas``): ``[m, k] @ [k, n]`` with fp32 accumulation and the
output in ``x.dtype``. The CUDA source is ``csrc/matmul.cu`` over
``csrc/gemm.cuh`` (shared with ``expert_gemm`` and ``matmul_bias_act``),
whose headers say what bounds each regime on an H100 and what the design
does about it.

Routes (:func:`route`, a pure rule on dtype, strides, alignment and the
config's ``bm``; never chosen by catching a failure):

* ``tc`` -- bf16, ``bm`` 64 or 128: ``wgmma`` fed by TMA through a ring of
  shared-memory stages, one or two consumer warpgroups a CTA;
* ``decode`` -- bf16, ``bm`` 16: the swap-AB kernel, ``C^T = B^T A^T``, 64
  weight columns per ``wgmma`` M and 16 rows of ``x`` its N. The heuristic
  takes it for ``m <= 16`` (:data:`DECODE_ROWS`), where the gemm streams the
  weight; a tuned record may take it for more rows (16 a CTA row);
* ``wmma`` -- bf16 operands TMA cannot address (a base, leading dimension
  or batch stride that is not a multiple of 16 bytes): the first port's
  WMMA tile loop, at :func:`wmma_tiles` whatever the config;
* ``simt`` -- fp32 (the hybrid's ``dt_proj`` and ``out_proj``; full fp32, no
  TF32, as the reference), on the SIMT cores at :func:`simt_tiles` whatever
  the config: a row kernel for decode rows, else 8 x 16 register tiles a
  thread in 128 x 256 CTA tiles fed by a cp.async ring, each
  operand copied in the granule :func:`simt_granules` names. Each launch
  also counts its kernel: ``<name>_simt_rows``, ``<name>_simt_tile``, or
  ``<name>_simt_loop`` for the first port's loop that ``force_loop``
  reaches.

Knobs (the tensor-core routes' launch parameters, under the JAX package's
names plus two): ``bm`` (16: the decode route; 64 or 128: one or two
consumer warpgroups), ``bn`` the CTA's output columns, ``bk`` the k slice
of one ring stage (one or two 64-element swizzle panels), ``stages`` the
ring's depth, ``splits`` the k ranges that separate CTAs sum into an fp32
workspace before a second kernel adds them in a fixed order (deterministic;
:func:`split_k` cuts k into whole slices). Their limits are the H100's:
227 KB of shared memory a block (:func:`smem_bytes`), at most 288 threads
(two consumer warpgroups and the producer warp), and an accumulator of at
most 128 fp32 registers a thread (64 x 256 a warpgroup).

Training differentiates it by the backward plan :func:`_matmul_bwd`:
``dx = ct @ w^T`` and ``dw = x^T @ ct``, both ``matmul`` dispatch sites
themselves. Every route reads each operand in the layout in which it is
stored (row-major or transposed, with its own leading dimension; the
tensor-core routes through the descriptors' transpose bits), so the
transposed views are never copied.

``out="float32"`` (a call kwarg, keyed ``o32``) returns bf16 operands'
product in fp32, unrounded: the tc and decode routes write their raw fp32
partial sums to the workspace they write split-k partials to, with no C
and no sum kernel, and the wrapper adds the splits in order. A
tensor-parallel rank's row-parallel projection takes it, so that the
ranks' partial products are summed in fp32 and rounded once, as one
device's product is. Its backward is the usual one on the cotangent in the
operands' dtype.

On a CPU tensor the wrapper runs :func:`matmul_plain`, the kernel's
function in plain PyTorch; on a CUDA tensor it launches a kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import Constraint, DispatchSpec, ParamSpace, gridmodel, tunable
from ..core.params import EnumParam
from ..core.platform import H100_SXM
from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"tc": 0, "decode": 1, "wmma": 2, "simt": 3}     # gemm.cuh's kernel codes
ROWS_CODE = 4               # the simt route's fp32 decode-row kernel
LOOP_CODE = 5               # the first port's fp32 tile loop (force_loop)
DECODE_ROWS = 16            # the decode route's N: rows of x a CTA
MAX_THREADS = 288           # two consumer warpgroups and the producer warp
MAX_ACC = 128               # fp32 accumulator registers a consumer thread
SPLIT_TARGET = 9 * H100_SXM.sm_count // 10   # CTAs a split-k grid aims for: a wave
LONG_K = 8192               # the k from which the heuristics split k


def _threads(c) -> int:
    """Threads of one tensor-core CTA: 128 a consumer warpgroup (one on the
    decode route), 32 for the producer warp."""
    return 128 * max(1, c["bm"] // 64) + 32


def _acc_regs(c) -> int:
    """fp32 accumulator registers a consumer thread: m64 x bn over 128
    threads on the tc route; bn / 64 m64n16 tiles on the decode route."""
    return c["bn"] // 8 if c["bm"] == DECODE_ROWS else c["bn"] // 2


def smem_bytes(c) -> int:
    """Shared memory of one tensor-core CTA (mirrors gemm.cuh's smem_bytes):
    1024 bytes to align the ring for the 128-byte swizzle, ``stages``
    stages of A's and B's k slices (reused by the epilogue's staged output
    tile when that is larger), a full and an empty barrier a stage."""
    bm, bn, bk, st = c["bm"], c["bn"], c["bk"], c["stages"]
    if bm == DECODE_ROWS:
        stage, out = (bn + DECODE_ROWS) * bk * 2, DECODE_ROWS * (bn + 4) * 4
    else:
        stage, out = (bm + bn) * bk * 2, bm * (bn + 8) * 2
    return 1024 + max(st * stage, out) + 16 * st


def loop_smem_bytes(t, dtype_bytes: int) -> int:
    """Shared memory of one WMMA (2) or SIMT (4) CTA (mirrors gemm.cuh's
    loop_smem_bytes): both staged tiles padded on both sides."""
    bm, bn, bk = t["bm"], t["bn"], t["bk"]
    if dtype_bytes == 2:
        return max(((bm + 8) * (bk + 8) + (bk + 8) * (bn + 8)) * 2, bm * (bn + 4) * 4)
    return ((bm + 4) * (bk + 4) + (bk + 4) * (bn + 4)) * 4


def loop_threads(t) -> int:
    """Threads of one WMMA or SIMT CTA: a warp per 16x32 (bm = 16) or 32x32
    output sub-tile."""
    fm = 1 if t["bm"] == 16 else 2
    return 32 * (t["bm"] // (16 * fm)) * (t["bn"] // 32)


# The tunables over MATMUL_SPACE: a config must launch for each of them (the
# norm prologue adds its scale slices to the ring).
GEMM_TUNABLES = ("matmul", "matmul_bias_act", "rmsnorm_matmul")

MATMUL_SPACE = ParamSpace(
    [
        EnumParam("bm", (16, 64, 128)),
        EnumParam("bn", (64, 128, 256)),
        EnumParam("bk", (64, 128)),
        EnumParam("stages", (2, 3, 4, 5, 6)),
        EnumParam("splits", (1, 2, 4, 8, 16)),
    ],
    [
        Constraint(gridmodel.LaunchLimit(GEMM_TUNABLES, ("smem",)),
                   "ring and staged output exceed the 227 KB of shared memory a block may use"),
        Constraint(gridmodel.LaunchLimit(GEMM_TUNABLES, ("threads",)),
                   "CTA exceeds two consumer warpgroups or 128 accumulator registers a thread"),
    ],
)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(k: int, bk: int, splits: int):
    """(kps, splits): the k range cut into ``splits`` ranges of ``kps``
    whole bk slices each, the last one shorter where the slices do not
    divide; fewer splits where k has fewer slices, so no split is empty.
    Split s covers slices [s * kps, min((s + 1) * kps, slices))."""
    slices = max(1, _cdiv(k, bk))
    kps = _cdiv(slices, max(1, min(splits, slices)))
    return kps, _cdiv(slices, kps)


def _splits_for(tiles: int, slices: int, target: int = SPLIT_TARGET, min_slices: int = 8,
                max_splits: int = 16) -> int:
    """The fewest splits (a power of two, at most ``max_splits``) that
    bring ``tiles`` output tiles to ``target`` CTAs, each split keeping at
    least ``min_slices`` k slices (a shorter range costs more in the second
    launch and the workspace than it saves)."""
    s = 1
    while s < max_splits and tiles * s < target and slices >= min_slices * 2 * s:
        s *= 2
    return s


def gemm_heuristic(rows: int, n: int, k: int, batch: int = 1) -> dict:
    """The tensor-core config for ``batch`` products [rows, k] @ [k, n].

    Decode rows (<= 16) take the decode route: 64 weight columns a CTA, so
    the grid is wide, in k slices of 128 (16 KB of weight a stage) through a
    ring of 4, two CTAs an SM. Prefill rows take 128 x 256 tiles (64-row
    bands up to 64 rows, 128 columns where n is no wider) in k slices of 64
    through a ring of 3 (144 KB, a CTA an SM).

    When the output tiles do not fill nine tenths of a wave of the 132 SMs
    (:data:`SPLIT_TARGET`): a long k (at least :data:`LONG_K`) splits over
    k, each split keeping 8 k slices (the train step's unembed dx, 64 tiles
    over k = 151,936, in two; its dw of the k/v projection, 7 tiles over k =
    8192, in 16); a shorter one takes 128-column tiles instead, since a
    split's fp32 workspace and second launch then cost more than the idle
    SMs (the qwen2_0_5b backward's [2048,4864] @ [4864,896]: 0.0493 ms at
    128 x 128 against 0.1067 at 128 x 256 in two splits, chip_smoke.py,
    NVIDIA H100 80GB HBM3, 700 W). Decode rows split only over a long k for
    the same reason: at decode the host's launch cost is what a split adds
    (PERF.md §6)."""
    if rows <= DECODE_ROWS:
        cfg = {"bm": DECODE_ROWS, "bn": 64, "bk": 128, "stages": 4}
        tiles = _cdiv(n, 64) * batch
    else:
        bm, bn = (128 if rows > 64 else 64), (256 if n > 128 else 128)
        tiles = _cdiv(rows, bm) * _cdiv(n, bn) * batch
        if bn == 256 and tiles < SPLIT_TARGET and k < LONG_K:
            bn, tiles = 128, _cdiv(rows, bm) * _cdiv(n, 128) * batch
        cfg = {"bm": bm, "bn": bn, "bk": 64, "stages": 3 if bn == 256 else 4}
    cfg["splits"] = _splits_for(tiles, _cdiv(k, cfg["bk"])) if k >= LONG_K else 1
    return cfg


ROWS_COLS, ROWS_KC = 512, 64     # gemm.cuh's fp32 decode-row kernel: columns a CTA, k slice
ROWS_THREADS, SIMT_THREADS = 128, 256    # threads of its row and register-tile kernels
# gemm.cuh's simt kernel: its one tile and its shared memory (the ring
# of k-major A and B slices, rows padded by 4 floats)
SIMT_TILE = {"bm": 128, "bn": 256, "bk": 32, "stages": 3}
SIMT_SMEM = SIMT_TILE["stages"] * SIMT_TILE["bk"] * (SIMT_TILE["bm"] + SIMT_TILE["bn"] + 8) * 4


def simt_tiles(rows: int, n: int, k: int, batch: int = 1) -> dict:
    """The fp32 route's one rule, whatever the config. Decode rows run
    gemm.cuh's row kernel: 512 columns a CTA (4 a thread), k in slices of
    64, split over k until the grid holds four CTAs an SM (the product is a
    read of the weight, and each thread keeps its loads along k in flight).
    More rows run the register-tiled kernel: 128 x 256 output tiles of 256
    threads (an 8 x 16 tile each), k in slices of 32 through a ring of 3,
    one CTA an SM (255 registers a thread, 147 KB of shared memory). When
    its tiles do not fill that wave of 132 and k is long (:data:`LONG_K`),
    it splits over k, each split at least 16 slices: a short prefill's
    ``out_proj`` (256 rows over k = 16,384: 64 tiles) in 4."""
    if rows <= DECODE_ROWS:
        return {"bm": DECODE_ROWS, "bn": ROWS_COLS, "bk": ROWS_KC, "stages": 1,
                "splits": _splits_for(_cdiv(n, ROWS_COLS) * batch, _cdiv(k, ROWS_KC),
                                      4 * H100_SXM.sm_count, min_slices=1, max_splits=32)}
    tiles = _cdiv(rows, SIMT_TILE["bm"]) * _cdiv(n, SIMT_TILE["bn"]) * batch
    splits = (_splits_for(tiles, _cdiv(k, SIMT_TILE["bk"]), H100_SXM.sm_count, min_slices=16)
              if k >= LONG_K else 1)
    return dict(SIMT_TILE, splits=splits)


def _granule(addr_mod16: int, ld: int, stride: int) -> int:
    for g in (16, 8, 4):
        if addr_mod16 % g == 0 and ld * 4 % g == 0 and stride * 4 % g == 0:
            return g
    return 0


def simt_granules(x: torch.Tensor, w: torch.Tensor):
    """The cp.async granule in bytes (16, 8 or 4) in which the simt kernel
    copies each fp32 operand into its k-major shared tile: an operand stored
    along M or N (a transposed x, a row-major w) as it is stored, in the
    widest granule its base, leading dimension and batch stride all divide;
    one stored along k (a row-major x, a transposed w) element by element (4),
    transposed on its way in. gemm.cuh's launch_simt holds the same rule."""
    (ta, lda, sa), (tb, ldb, sb) = operand(x), operand(w)
    ga = _granule(x.data_ptr() % 16, lda, sa) if ta else 4
    gb = 4 if tb else _granule(w.data_ptr() % 16, ldb, sb)
    return ga, gb


def wmma_tiles(rows: int) -> dict:
    """The WMMA route's one rule, whatever the config: the first port's
    heuristic (one 16-row tile with a deep k slice for decode rows, 64 x 64
    x 64 from 64 rows, 32-row tiles between), also the tiles of the fp32
    tile loop when a call forces it."""
    if rows <= DECODE_ROWS:
        return {"bm": 16, "bn": 64, "bk": 128, "splits": 1}
    return {"bm": 64 if rows >= 64 else 32, "bn": 64, "bk": 64, "splits": 1}


def _matmul_heuristic(x, w):
    """:func:`gemm_heuristic` at the call's shape (the fp32 and WMMA
    routes take their own tiles and ignore it)."""
    return gemm_heuristic(x.shape[0], w.shape[1], x.shape[1])


def _matmul_canon(x, w):
    """Flatten leading dims to rows: [..., k] @ [k, n]. A 2-D operand keeps
    its layout (the backward's transposed views reach the kernel as they
    are stored)."""
    if x.dim() == 2:
        return (x, w), lambda out: out
    lead = x.shape[:-1]
    return ((x.reshape(-1, x.shape[-1]), w),
            lambda out: out.reshape(*lead, out.shape[-1]))


def _matmul_bwd(ct, x, w, out: str = "", **kwargs):
    """Backward plan: dL/dx = ct [m,n] @ w^T [n,k] and dL/dw = x^T [k,m] @
    ct [m,n], each a ``matmul`` dispatch site with its own database key (the
    keys of ``repro.kernels.matmul._matmul_bwd``). ``dp_dims`` names the
    token dim of the transposed operand for sharded keying in the JAX
    package; on one device it changes nothing. An fp32-out product's
    cotangent is taken in the operands' dtype, so its gradients are the
    usual product's."""
    from ..core.runtime import dispatch

    del out
    ct = ct.to(x.dtype)
    dx = dispatch("matmul", ct, w.T, **kwargs)
    dw = dispatch("matmul", x.T, ct, dp_dims={0: 1, 1: 0}, **kwargs)
    return dx, dw


def _layout(shape, stride):
    r, c = shape
    s0, s1 = stride
    if (c == 1 or s1 == 1) and (r == 1 or s0 >= c):
        return False, (s0 if r > 1 else c)
    if (r == 1 or s0 == 1) and (c == 1 or s1 >= r):
        return True, (s1 if c > 1 else r)
    raise ValueError(f"matmul kernel takes row-major or transposed operands, got shape "
                     f"{tuple(shape)} with strides {tuple(stride)}")


def layout(t: torch.Tensor):
    """(transposed, leading dim) of a 2-D operand as the kernel reads it:
    row-major (element (r, c) at r*ld + c) or transposed (at c*ld + r).
    Raises for any other strides."""
    return _layout(t.shape, t.stride())


def _operand(shape, stride):
    if len(shape) == 2:
        return (*_layout(shape, stride), 0)
    return (*_layout(shape[1:], stride[1:]), stride[0] if shape[0] > 1 else 0)


def operand(t: torch.Tensor):
    """(transposed, leading dim, batch stride) of a 2-D operand (stride 0)
    or a 3-D one (each matrix as :func:`layout` reads it, the matrices
    ``stride(0)`` elements apart; 0 for a broadcast or a single matrix)."""
    return _operand(t.shape, t.stride())


def _desc(t: torch.Tensor):
    """What the routing rule reads of an operand: shape, strides and whether
    its base is 16-byte aligned."""
    return tuple(t.shape), tuple(t.stride()), t.data_ptr() % 16 == 0


def _route(bf16: bool, xd, wd, bm) -> str:
    if not bf16:
        return "simt"
    (_, lda, sa), (_, ldb, sb) = _operand(*xd[:2]), _operand(*wd[:2])
    # TMA addresses an operand whose base, leading dimension and batch
    # stride are multiples of 16 bytes (bf16: 8 elements)
    if xd[0][-1] == 0 or not (xd[2] and wd[2] and lda % 8 == 0 and ldb % 8 == 0
                              and sa % 8 == 0 and sb % 8 == 0):
        return "wmma"
    if bm is None:
        return "decode" if xd[0][-2] <= DECODE_ROWS else "tc"
    return "decode" if bm == DECODE_ROWS else "tc"


def route(x: torch.Tensor, w: torch.Tensor, bm=None) -> str:
    """The kernel a call takes: ``simt`` for fp32; ``wmma`` for bf16
    operands TMA cannot address (or k = 0); else ``decode`` when the config's
    ``bm`` is 16 and ``tc`` for 64 or 128. Without a config, the heuristic's
    pick: ``decode`` for at most :data:`DECODE_ROWS` rows. Shared by
    ``expert_gemm`` (3-D operands) and ``matmul_bias_act``."""
    return _route(x.dtype == torch.bfloat16, _desc(x), _desc(w), bm)


def route_tiles(r: str, rows: int, n: int, k: int, batch: int, cfg: dict) -> dict:
    """The launch of route ``r`` (not the first port's loop): its tiles,
    ring depth, the kernel's code and name, and the split-k partition. The
    one place the wrapper (:func:`plan`) and the launch models
    (:func:`gemm_models`) take them from."""
    code, kernel = ROUTES[r], r
    if r == "simt":
        t = simt_tiles(rows, n, k, batch)
        code, kernel = (ROWS_CODE, "rows") if t["bm"] == DECODE_ROWS else (code, "tile")
    elif r == "wmma":
        t = dict(wmma_tiles(rows), stages=1)
    else:
        t = {key: cfg[key] for key in ("bm", "bn", "bk", "stages", "splits")}
    kps, splits = split_k(k, t["bk"], t["splits"])
    return dict(t, route=r, code=code, kernel=kernel, kps=kps, splits=splits)


@functools.lru_cache(maxsize=4096)
def _plan(bf16: bool, xd, wd, cfg, force_loop: bool) -> dict:
    cfg = dict(cfg)
    (xs, _, _), (ws, _, _) = xd, wd
    rows, k, n = xs[-2], xs[-1], ws[-1]
    batch = xs[0] if len(xs) == 3 else 1
    if force_loop:
        r = "wmma" if bf16 else "simt"
        t, code = dict(wmma_tiles(rows), stages=1), ROUTES["wmma"] if bf16 else LOOP_CODE
        kps, splits = split_k(k, t["bk"], t["splits"])
        return dict(t, route=r, code=code, kernel="loop", kps=kps, splits=splits)
    return route_tiles(_route(bf16, xd, wd, cfg["bm"]), rows, n, k, batch, cfg)


def plan(x, w, cfg, force_loop: bool = False) -> dict:
    """The launch of one call (read only): its route, the kernel's code and
    name (``kernel``: the route, or on the fp32 route ``rows``, ``tile`` or
    ``loop``), tiles, ring depth and split-k partition (``kps`` slices a split,
    ``splits`` of them). ``force_loop`` takes the first port's tile loop
    (WMMA in bf16, SIMT in fp32) at its heuristic's tiles, whatever the rule
    says. Cached on what the rule reads, so a decode step's repeated shapes
    pay one dict lookup."""
    return _plan(x.dtype == torch.bfloat16, _desc(x), _desc(w), tuple(sorted(cfg.items())),
                 force_loop)


# ---------------------------------------------------------------------------
# Launch models (core/gridmodel.py): the launches of one call, from the same
# route rule, tiles and shared-memory functions the wrapper uses
# ---------------------------------------------------------------------------

GEMM_KERNELS = {"tc": "gemm_tc", "decode": "gemm_decode", "wmma": "gemm_wmma",
                "rows": "gemm_simt_rows", "tile": "gemm_simt"}


def shape_route(bf16: bool, rows: int, n: int, k: int, bm: int) -> str:
    """:func:`route` for contiguous, 16-byte aligned operands of these
    shapes: a row-major x's leading dim is k and w's is n, and TMA needs
    both a multiple of 8 bf16 elements."""
    if not bf16:
        return "simt"
    if k == 0 or k % 8 or n % 8:
        return "wmma"
    return "decode" if bm == DECODE_ROWS else "tc"


def gemm_models(cfg: dict, rows: int, n: int, k: int, batch: int, dtype: str,
                w_batched: bool = False, extra_bytes: float = 0.0,
                epilogue_flops: float = 0.0, smem=None) -> tuple:
    """The launches of ``batch`` products [rows, k] @ [k, n] at ``cfg``:
    the route's kernel and, over split k, the kernel that sums the fp32
    partials (the splits are the partial kernel's declared reduction).
    ``smem`` replaces the route's shared memory (a prologue's),
    ``extra_bytes`` and ``epilogue_flops`` add a bias or a norm's traffic
    and work. Shared by ``matmul``, ``matmul_bias_act``, ``rmsnorm_matmul``
    and ``expert_gemm``, as their kernels share gemm.cuh."""
    bf16 = dtype == "bfloat16"
    es = 2 if bf16 else 4
    p = route_tiles(shape_route(bf16, rows, n, k, cfg["bm"]), rows, n, k, batch, cfg)
    r, splits = p["route"], p["splits"]
    bm, bn, bk = p["bm"], p["bn"], p["bk"]
    red = ("split",) if splits > 1 else ()
    mt, nt = _cdiv(rows, bm), _cdiv(n, bn)
    if r == "simt" and p["kernel"] == "rows":
        mt = 1
    axes = ("m", "n", "batch", "split")
    grid = (mt, nt, batch, splits)
    out = gridmodel.OutputModel("c", (batch, rows, n), (1, bm, bn),
                                lambda i, j, b, s: (b, i, j), reduce=red)
    traffic = es * (batch * rows * k + (batch if w_batched else 1) * k * n
                    + (0 if splits > 1 else batch * rows * n)) + extra_bytes
    flops = 2.0 * batch * mt * bm * nt * bn * _cdiv(k, bk) * bk + epilogue_flops
    common = dict(route=r, grid=grid, axes=axes, outputs=(out,), dtype=dtype, flops=flops,
                  bytes=traffic, workspace=4.0 * splits * batch * rows * n if splits > 1 else 0.0,
                  uniform=True, template=(bm, bn, bk, p["stages"]))
    if r == "tc":
        # the dimension with fewer tiles runs fastest (gemm.cuh's launch_tc)
        gx, gy = (mt, nt) if mt <= nt else (nt, mt)
        model = gridmodel.LaunchModel(
            GEMM_KERNELS["tc"], cuda_grid=(gx, gy, batch * splits),
            threads=_threads(cfg), smem=smem_bytes(cfg) if smem is None else smem,
            mma=("wgmma", bm, bn, bk), max_threads=MAX_THREADS, acc_regs=_acc_regs(cfg),
            max_acc_regs=MAX_ACC, peak="bf16", **common)
    elif r == "decode":
        model = gridmodel.LaunchModel(
            GEMM_KERNELS["decode"], cuda_grid=(nt, mt, batch * splits), threads=_threads(cfg),
            smem=smem_bytes(cfg) if smem is None else smem, mma=("wgmma", bn, DECODE_ROWS, bk),
            max_threads=MAX_THREADS, acc_regs=_acc_regs(cfg), max_acc_regs=MAX_ACC,
            peak="bf16", **common)
    elif r == "wmma":
        model = gridmodel.LaunchModel(
            GEMM_KERNELS["wmma"], cuda_grid=(nt, mt, batch * splits), threads=loop_threads(p),
            smem=loop_smem_bytes(p, 2) if smem is None else smem, mma=("wmma", bm, bn, bk),
            max_threads=512, peak="bf16", **common)
    elif p["kernel"] == "rows":
        model = gridmodel.LaunchModel(GEMM_KERNELS["rows"], cuda_grid=(nt, 1, batch * splits),
                                      threads=ROWS_THREADS, smem=0, **common)
    else:
        model = gridmodel.LaunchModel(GEMM_KERNELS["tile"], cuda_grid=(nt, mt, batch * splits),
                                      threads=SIMT_THREADS, smem=SIMT_SMEM, **common)
    if splits == 1:
        return (model,)
    count = batch * rows * n
    blocks = min(_cdiv(count, 256), 4096)
    total = gridmodel.LaunchModel(
        "gemm_splitk_sum", route=r, grid=(blocks,), axes=("block",), cuda_grid=(blocks, 1, 1),
        threads=256, outputs=(gridmodel.OutputModel("c", (count,)),), dtype=dtype,
        flops=float(count * splits), bytes=float(es * count))
    return model, total


def _matmul_model(cfg, shapes, dtypes, **_):
    (xs, ws) = shapes[:2]
    rows = math.prod(xs[:-1])
    if xs[-1] != ws[0]:
        return None
    return gemm_models(cfg, rows, ws[1], xs[-1], 1, dtypes[0])


def count_launch(name: str, p: dict, transposed: bool) -> None:
    """A launch of ``name`` on route p["route"] (one count each: the kernel,
    its route, the fp32 route's kernel, and transposed operands or split-k
    where they apply)."""
    _build.LAUNCHES[name] += 1
    _build.LAUNCHES[f"{name}_{p['route']}"] += 1
    if p["route"] == "simt":
        _build.LAUNCHES[f"{name}_simt_{p['kernel']}"] += 1
    if transposed:
        _build.LAUNCHES[f"{name}_transposed"] += 1
    if p["splits"] > 1:
        _build.LAUNCHES[f"{name}_splitk"] += 1


def workspace(p: dict, batch: int, m: int, n: int, device):
    """The fp32 [splits, batch, m, n] partial sums of a split-k launch."""
    if p["splits"] == 1:
        return None
    return torch.empty((p["splits"], batch, m, n), dtype=torch.float32, device=device)


def _out_dtype(x: torch.Tensor, out: str) -> torch.dtype:
    if out not in ("", "float32"):
        raise ValueError(f"matmul out={out!r}: '' (the operands' dtype) or 'float32'")
    return torch.float32 if out else x.dtype


def matmul_plain(x: torch.Tensor, w: torch.Tensor, out: str = "") -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 accumulation, cast (to
    the operands' dtype, or kept in fp32 for ``out="float32"``)."""
    return torch.matmul(x.float(), w.float()).to(_out_dtype(x, out))


def matmul_cuda(x: torch.Tensor, w: torch.Tensor, *, bm: int, bn: int, bk: int, stages: int,
                splits: int, force_loop: bool = False, out: str = "") -> torch.Tensor:
    """Launch csrc/matmul.cu on CUDA tensors; either operand may be a
    transposed view. ``force_loop`` runs the first port's tile loop whatever
    the rule says (a before-and-after of the same call). ``out="float32"``:
    bf16 operands' product unrounded, in fp32 (the module docstring)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul takes [m,k] @ [k,n], got {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"matmul kernel takes matching f32 or bf16 operands, got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    (ta, lda), (tb, ldb) = layout(x), layout(w)
    m, k = x.shape
    n = w.shape[1]
    p = plan(x, w, dict(bm=bm, bn=bn, bk=bk, stages=stages, splits=splits), force_loop)
    raw = _out_dtype(x, out) != x.dtype          # fp32 out of bf16 operands
    if raw and p["route"] not in ("tc", "decode"):
        raise ValueError(f"matmul out=float32 runs on the tc and decode routes, not "
                         f"{p['route']}")
    c = None if raw else torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = (torch.empty((p["splits"], 1, m, n), dtype=torch.float32, device=x.device) if raw
          else workspace(p, 1, m, n, x.device))
    fn = _build.entry("matmul", "repro_matmul",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), None if c is None else c.data_ptr(),
             None if ws is None else ws.data_ptr(),
             m, n, k, int(ta), int(tb), lda, ldb, _DTYPES[x.dtype], p["code"], p["bm"],
             p["bn"], p["bk"], p["stages"], p["splits"], p["kps"], _build.stream_ptr(x.device))
    _build.check("matmul", err, f"matmul {m}x{k}x{n} ta={ta} tb={tb} {p}")
    count_launch("matmul", p, ta or tb)
    if not raw:
        return c
    _build.LAUNCHES["matmul_fp32_out"] += 1
    acc = ws[0, 0]
    for s in range(1, p["splits"]):          # the splits in order, as the sum kernel adds them
        acc = acc + ws[s, 0]
    return acc


@tunable(
    "matmul",
    space=MATMUL_SPACE,
    reference=ref.matmul,
    heuristic=_matmul_heuristic,
    dispatch=DispatchSpec(canonicalize=_matmul_canon, vjp="dispatch", bwd=_matmul_bwd,
                          key_extra=lambda kw: "o32" if kw.get("out") else ""),
)
def matmul(x, w, *, bm: int, bn: int, bk: int, stages: int, splits: int, out: str = ""):
    if x.is_cuda:
        return matmul_cuda(x, w, bm=bm, bn=bn, bk=bk, stages=stages, splits=splits, out=out)
    if x.device.type == "cpu":
        return matmul_plain(x, w, out)
    raise _build.KernelUnavailable(f"matmul has no kernel for device {x.device}")


# The nominal shapes the space is judged at: a production-scale bf16 gemm,
# where every config takes its own route.
NOMINAL = ((4096, 4096), (4096, 4096))
gridmodel.register_launch_model("matmul", _matmul_model, space=MATMUL_SPACE, nominal=NOMINAL)
