"""Row RMSNorm: the ``rmsnorm`` tunable and its CUDA kernel.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:_rmsnorm_kernel``
(``rmsnorm_pallas``): one read of x, an fp32 sum of squares, the output and
the per-row fp32 inverse rms. The weight multiplies in fp32 before the
cast, as the TPU kernel does; ``ref.rmsnorm`` casts first, so in bf16 the
two differ by one rounding, and :func:`rmsnorm_plain` follows the kernel.

The work is one row reduction plus an elementwise pass, bound by bytes;
the CUDA source is ``csrc/rmsnorm.cu``: 16-byte accesses, the row held in
registers between its sum of squares and its output (a team of warps a
wide row), the weight read once a CTA. The knob ``block_rows`` is the
number of rows a CTA takes (at most 32); the CTA's teams walk them in turn,
so neither the row width nor the knob is bound by the thread limit.

Its backward plan dispatches ``rmsnorm_bwd`` (``csrc/rmsnorm_bwd.cu``,
replacing ``repro/kernels/rmsnorm.py:_rmsnorm_bwd_kernel``): dx and dw from
the forward's saved inverse rms, over the same knob space, also bound by
bytes and built the same way: ct and x read once into registers, the
weight once a CTA, and each thread's fp32 dw partial of its columns kept in
registers across the rows its team walks, summed over the CTA's teams once
and over the CTAs by a second small kernel, both in a fixed order. Here
``block_rows`` is the teams a CTA holds, and :func:`rmsnorm_bwd_ctas` the
CTAs (the first port held a ``[block_rows, d]`` fp32 accumulator in
shared memory, which refused d = 8192 at 8 rows; no shared memory scales
with ``block_rows x d`` now, so every config runs at every width).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import Constraint, DispatchSpec, ParamSpace, PowerOfTwoParam, tunable
from ..core.platform import H100_SXM
from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

RMSNORM_SPACE = ParamSpace(
    [PowerOfTwoParam("block_rows", 1, 32)],
    [
        Constraint(lambda c: 32 * c["block_rows"] <= H100_SXM.max_threads_per_block,
                   "one warp per row: block_rows exceeds 1024 threads"),
    ],
)


def _rmsnorm_heuristic(x, w):
    """Eight rows (256 threads) a CTA, fewer when that leaves SMs idle."""
    rows = x.shape[0]
    br = 8
    while br > 1 and -(-rows // br) < H100_SXM.sm_count:
        br //= 2
    return {"block_rows": br}


def _rmsnorm_canon(x, weight):
    """Flatten [..., d] -> [rows, d]; reshape the output back."""
    shape = x.shape
    return (x.reshape(-1, shape[-1]).contiguous(), weight), lambda out: out.reshape(shape)


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """The kernel's function in plain PyTorch: (out, invrms[rows] fp32)."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * r) * weight.float()).to(x.dtype), r[:, 0]


_RMSNORM_ARGTYPES = ([ctypes.c_void_p] * 4
                     + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, *, block_rows: int,
                 eps: float = 1e-6):
    """Launch csrc/rmsnorm.cu on CUDA tensors: (out, invrms). Called once a
    norm at decode, where its host time sets the pace: the checks read
    attributes only and the argument types are built once."""
    if x.dim() != 2 or weight.dim() != 1 or weight.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm takes [rows,d] and [d], got {tuple(x.shape)}, {tuple(weight.shape)}")
    code = _DTYPES.get(x.dtype)
    if code is None or weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes matching f32 or bf16 tensors, got {x.dtype}, {weight.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous tensors only")
    if x.device != weight.device:
        raise ValueError(f"tensors on {x.device} and {weight.device}")
    rows, d = x.shape
    out = torch.empty_like(x)
    invrms = torch.empty(rows, dtype=torch.float32, device=x.device)
    fn = _build.entry("rmsnorm", "repro_rmsnorm", _RMSNORM_ARGTYPES)
    err = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), invrms.data_ptr(), rows, d, eps,
             code, block_rows, _build.stream_ptr(x.device))
    if err:
        _build.check("rmsnorm", err, f"rmsnorm {rows}x{d} block_rows={block_rows}")
    _build.LAUNCHES["rmsnorm"] += 1
    return out, invrms


def _rmsnorm_bwd_plan(ct, x, weight, y, invrms, **kwargs):
    """Backward plan: one ``rmsnorm_bwd`` dispatch site, handed the saved
    inverse rms instead of re-deriving it (``repro``'s plan of the same
    name). The output ``y`` is not needed."""
    from ..core.runtime import dispatch

    del y
    return dispatch("rmsnorm_bwd", ct, x, weight, invrms, **kwargs)


@tunable(
    "rmsnorm",
    space=RMSNORM_SPACE,
    reference=ref.rmsnorm_res,
    heuristic=_rmsnorm_heuristic,
    dispatch=DispatchSpec(reference=ref.rmsnorm, canonicalize=_rmsnorm_canon,
                          vjp="dispatch", bwd=_rmsnorm_bwd_plan, residuals=1),
)
def rmsnorm(x, weight, *, block_rows: int, eps: float = 1e-6):
    if x.is_cuda:
        return rmsnorm_cuda(x, weight, block_rows=block_rows, eps=eps)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    raise _build.KernelUnavailable(f"rmsnorm has no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# Backward: dx and dw from the saved inverse rms
# ---------------------------------------------------------------------------


def rmsnorm_bwd_plain(ct, x, weight, invrms, eps: float = 1e-6):
    """The backward kernel's function in plain PyTorch: (dx, dw), fp32 math
    from the saved inverse rms, dx in x's dtype and dw in the weight's."""
    del eps
    cf, xf = ct.float(), x.float()
    r = invrms.float()[:, None]
    g = cf * weight.float()
    dot = (g * xf).sum(dim=-1, keepdim=True)
    dx = g * r - xf * r ** 3 * (dot / x.shape[-1])
    dw = (cf * (xf * r)).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


MAX_WARPS = 16          # warps a CTA (csrc/rmsnorm_bwd.cu)


def rmsnorm_bwd_team(d: int, itemsize: int):
    """(warps a row's team, whether the row stays in registers, 16-byte
    vectors a thread holds): 2 vectors a thread for rows of up to 8 such
    warps, 4 above; at most :data:`MAX_WARPS` warps (mirrors ``Team`` in
    csrc/rmsnorm_bwd.cu)."""
    vecs = -(-d // (16 // itemsize))
    nv = 2 if -(-vecs // 64) <= 8 else 4
    w = -(-vecs // (32 * nv))
    resident = w <= MAX_WARPS
    return (max(w, 1) if resident else MAX_WARPS), resident, nv


def rmsnorm_bwd_teams(block_rows: int, d: int, itemsize: int) -> int:
    """Teams of one CTA: ``block_rows``, as many as 16 warps hold."""
    return min(block_rows, MAX_WARPS // rmsnorm_bwd_team(d, itemsize)[0])


def rmsnorm_bwd_smem_bytes(block_rows: int, d: int, itemsize: int = 2) -> int:
    """Dynamic shared memory of one pass-1 CTA: its teams' fp32 dw partials,
    summed once at the end (mirrors repro_rmsnorm_bwd_smem_bytes). At most
    64 KB: teams x d never passes 16 warps' registers' worth of columns."""
    resident = rmsnorm_bwd_team(d, itemsize)[1]
    teams = rmsnorm_bwd_teams(block_rows, d, itemsize)
    return teams * d * 4 if resident and teams > 1 else 0


@functools.lru_cache(maxsize=1024)
def rmsnorm_bwd_ctas(rows: int, d: int, itemsize: int, block_rows: int,
                     sm_count: int = H100_SXM.sm_count) -> int:
    """CTAs of pass 1, and rows of the fp32 dw partials: 512 threads an SM,
    fewer where the rows give each team less than one row. Cached: a train
    step asks for the same few shapes 49 times."""
    if rows <= 0:
        return 0
    warps = rmsnorm_bwd_team(d, itemsize)[0]
    teams = rmsnorm_bwd_teams(block_rows, d, itemsize)
    return min(-(-rows // teams), sm_count * (MAX_WARPS // (warps * teams)))


_RMSNORM_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def rmsnorm_bwd_cuda(ct, x, weight, invrms, *, block_rows: int, eps: float = 1e-6):
    """Launch csrc/rmsnorm_bwd.cu on CUDA tensors: (dx, dw). One C call a
    launch, the CTA count computed here."""
    del eps
    if x.dim() != 2 or ct.shape != x.shape or weight.shape != (x.shape[1],) \
            or invrms.shape != (x.shape[0],):
        raise ValueError(f"rmsnorm_bwd takes ct, x [rows,d], w [d], invrms [rows]; got "
                         f"{tuple(ct.shape)}, {tuple(x.shape)}, {tuple(weight.shape)}, "
                         f"{tuple(invrms.shape)}")
    code = _DTYPES.get(x.dtype)
    if code is None or not (ct.dtype == x.dtype == weight.dtype) \
            or invrms.dtype != torch.float32:
        raise TypeError(f"rmsnorm_bwd kernel takes matching f32 or bf16 ct/x/w and fp32 "
                        f"invrms, got {ct.dtype}, {x.dtype}, {weight.dtype}, {invrms.dtype}")
    if not (ct.is_contiguous() and x.is_contiguous() and weight.is_contiguous()
            and invrms.is_contiguous()):
        raise ValueError("rmsnorm_bwd kernel takes contiguous tensors only")
    if not (ct.device == x.device == weight.device == invrms.device):
        raise ValueError("rmsnorm_bwd tensors on different devices")
    rows, d = x.shape
    if d < 1 or not 1 <= block_rows <= 32:
        raise ValueError(f"rmsnorm_bwd: d={d}, block_rows={block_rows}")
    ctas = rmsnorm_bwd_ctas(rows, d, x.element_size(), block_rows)
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    partial = torch.empty((max(ctas, 1), d), dtype=torch.float32, device=x.device)
    fn = _build.entry("rmsnorm_bwd", "repro_rmsnorm_bwd", _RMSNORM_BWD_ARGTYPES)
    err = fn(ct.data_ptr(), x.data_ptr(), weight.data_ptr(), invrms.data_ptr(), dx.data_ptr(),
             dw.data_ptr(), partial.data_ptr(), rows, d, code, block_rows, ctas,
             _build.stream_ptr(x.device))
    if err:
        _build.check("rmsnorm_bwd", err, f"rmsnorm_bwd {rows}x{d} block_rows={block_rows}")
    _build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw


def _rmsnorm_bwd_heuristic(ct, x, weight, invrms):
    """The forward's, at most four teams a CTA: at [8192, 896] that is 264
    CTAs of four 2-warp teams rather than 132 of eight (chip_smoke.py times
    the two side by side)."""
    return {"block_rows": min(4, _rmsnorm_heuristic(x, weight)["block_rows"])}


@tunable(
    "rmsnorm_bwd",
    space=RMSNORM_SPACE,
    reference=ref.rmsnorm_bwd,
    heuristic=_rmsnorm_bwd_heuristic,
    # vjp="reference": the oracle is differentiable torch, so grad-of-grad
    # differentiates through this gradient site.
    dispatch=DispatchSpec(data_parallel_args=(0, 1, 3), vjp="reference"),
)
def rmsnorm_bwd(ct, x, weight, invrms, *, block_rows: int, eps: float = 1e-6):
    if x.is_cuda:
        return rmsnorm_bwd_cuda(ct, x, weight, invrms, block_rows=block_rows, eps=eps)
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(ct, x, weight, invrms, eps)
    raise _build.KernelUnavailable(f"rmsnorm_bwd has no kernel for device {x.device}")
