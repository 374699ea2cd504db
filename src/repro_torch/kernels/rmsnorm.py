"""Row RMSNorm: the ``rmsnorm`` tunable and its CUDA kernel.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:_rmsnorm_kernel``
(``rmsnorm_pallas``): one read of x, an fp32 sum of squares, the output and
the per-row fp32 inverse rms. The weight multiplies in fp32 before the
cast, as the TPU kernel does; ``ref.rmsnorm`` casts first, so in bf16 the
two differ by one rounding, and :func:`rmsnorm_plain` follows the kernel.

The work is one row reduction plus an elementwise pass, bound by bytes;
the CUDA source is ``csrc/rmsnorm.cu``. The knob ``block_rows`` is the
number of rows (one warp each) a CTA takes, so at most 32 under the
1024-thread limit; no row is staged in shared memory, so the row width
sets no limit.
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


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, *, block_rows: int,
                 eps: float = 1e-6):
    """Launch csrc/rmsnorm.cu on CUDA tensors: (out, invrms)."""
    if x.dim() != 2 or weight.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes [rows,d] and [d], got {tuple(x.shape)}, {tuple(weight.shape)}")
    if x.dtype != weight.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes matching f32 or bf16 tensors, got {x.dtype}, {weight.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous tensors only")
    if x.device != weight.device:
        raise ValueError(f"tensors on {x.device} and {weight.device}")
    rows, d = x.shape
    out = torch.empty_like(x)
    invrms = torch.empty((rows,), dtype=torch.float32, device=x.device)
    fn = _build.entry("rmsnorm", "repro_rmsnorm",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), invrms.data_ptr(), rows, d,
             float(eps), _DTYPES[x.dtype], block_rows, _build.stream_ptr(x.device))
    _build.check("rmsnorm", err, f"rmsnorm {rows}x{d} block_rows={block_rows}")
    _build.LAUNCHES["rmsnorm"] += 1
    return out, invrms


@tunable(
    "rmsnorm",
    space=RMSNORM_SPACE,
    reference=ref.rmsnorm_res,
    heuristic=_rmsnorm_heuristic,
    dispatch=DispatchSpec(reference=ref.rmsnorm, canonicalize=_rmsnorm_canon,
                          residuals=1),
)
def rmsnorm(x, weight, *, block_rows: int, eps: float = 1e-6):
    if x.is_cuda:
        return rmsnorm_cuda(x, weight, block_rows=block_rows, eps=eps)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    raise RuntimeError(f"rmsnorm has no kernel for device {x.device}")
