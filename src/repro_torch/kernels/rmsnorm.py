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
the forward's saved inverse rms, over the same knob space.
"""
from __future__ import annotations

import ctypes

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
    raise RuntimeError(f"rmsnorm has no kernel for device {x.device}")


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


def rmsnorm_bwd_smem_bytes(block_rows: int, d: int) -> int:
    """Shared memory of one pass-1 CTA: a [block_rows, d] fp32 accumulator."""
    return block_rows * d * 4


def rmsnorm_bwd_cuda(ct, x, weight, invrms, *, block_rows: int, eps: float = 1e-6):
    """Launch csrc/rmsnorm_bwd.cu on CUDA tensors: (dx, dw)."""
    del eps
    if x.dim() != 2 or ct.shape != x.shape or weight.shape != (x.shape[1],) \
            or invrms.shape != (x.shape[0],):
        raise ValueError(f"rmsnorm_bwd takes ct, x [rows,d], w [d], invrms [rows]; got "
                         f"{tuple(ct.shape)}, {tuple(x.shape)}, {tuple(weight.shape)}, "
                         f"{tuple(invrms.shape)}")
    if not (ct.dtype == x.dtype == weight.dtype) or x.dtype not in _DTYPES \
            or invrms.dtype != torch.float32:
        raise TypeError(f"rmsnorm_bwd kernel takes matching f32 or bf16 ct/x/w and fp32 "
                        f"invrms, got {ct.dtype}, {x.dtype}, {weight.dtype}, {invrms.dtype}")
    if not all(t.is_contiguous() for t in (ct, x, weight, invrms)):
        raise ValueError("rmsnorm_bwd kernel takes contiguous tensors only")
    if not (ct.device == x.device == weight.device == invrms.device):
        raise ValueError("rmsnorm_bwd tensors on different devices")
    rows, d = x.shape
    if rmsnorm_bwd_smem_bytes(block_rows, d) > H100_SXM.smem_per_block:
        raise ValueError(f"rmsnorm_bwd: block_rows={block_rows} x d={d} fp32 accumulator "
                         f"exceeds {H100_SXM.smem_per_block} B of shared memory")
    ctas_fn = _build.entry("rmsnorm_bwd", "repro_rmsnorm_bwd_ctas", [ctypes.c_int] * 2)
    ctas = ctas_fn(rows, block_rows) if rows > 0 else 0
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    partial = torch.empty((max(ctas, 1), d), dtype=torch.float32, device=x.device)
    fn = _build.entry("rmsnorm_bwd", "repro_rmsnorm_bwd",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(ct.data_ptr(), x.data_ptr(), weight.data_ptr(), invrms.data_ptr(), dx.data_ptr(),
             dw.data_ptr(), partial.data_ptr(), rows, d, _DTYPES[x.dtype], block_rows,
             _build.stream_ptr(x.device))
    _build.check("rmsnorm_bwd", err, f"rmsnorm_bwd {rows}x{d} block_rows={block_rows}")
    _build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw


def _rmsnorm_bwd_heuristic(ct, x, weight, invrms):
    return _rmsnorm_heuristic(x, weight)


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
    raise RuntimeError(f"rmsnorm_bwd has no kernel for device {x.device}")
