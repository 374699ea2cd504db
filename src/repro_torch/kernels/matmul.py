"""Blocked matmul: the ``matmul`` tunable and its CUDA kernel.

Replaces the TPU kernel ``repro/kernels/matmul.py:_matmul_kernel``
(``matmul_pallas``): ``[m, k] @ [k, n]`` with fp32 accumulation and the
output in ``x.dtype``. The CUDA source is ``csrc/matmul.cu``, whose header
says what bounds it on an H100 and what its design does about that.

The knobs are the kernel's launch parameters: ``(bm, bn)`` is the CTA's
output tile and ``bk`` the k slice staged in shared memory per step. Their
limits come from the H100, not from the TPU's VMEM: at most 512 threads a
CTA (one warp per 16x32 or 32x32 sub-tile, under ``__launch_bounds__``) and
at most 227 KB of shared memory a block.

On a CPU tensor the wrapper runs :func:`matmul_plain`, the kernel's
function in plain PyTorch; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import Constraint, DispatchSpec, ParamSpace, PowerOfTwoParam, tunable
from ..core.platform import H100_SXM
from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_THREADS = 512


def _threads(c) -> int:
    fm = 1 if c["bm"] == 16 else 2
    return 32 * (c["bm"] // (16 * fm)) * (c["bn"] // 32)


def smem_bytes(c, dtype_bytes: int) -> int:
    """Shared memory of one CTA (mirrors repro_matmul_smem_bytes)."""
    bm, bn, bk = c["bm"], c["bn"], c["bk"]
    if dtype_bytes == 2:
        return max((bm * (bk + 8) + bk * (bn + 8)) * 2, bm * (bn + 4) * 4)
    return (bm * (bk + 4) + bk * (bn + 4)) * 4


MATMUL_SPACE = ParamSpace(
    [
        PowerOfTwoParam("bm", 16, 256),
        PowerOfTwoParam("bn", 32, 256),
        PowerOfTwoParam("bk", 16, 128),
    ],
    [
        Constraint(lambda c: _threads(c) <= MAX_THREADS,
                   "CTA exceeds 512 threads (one warp per 32x32 output sub-tile)"),
        Constraint(lambda c: max(smem_bytes(c, 2), smem_bytes(c, 4))
                   <= H100_SXM.smem_per_block,
                   "CTA tile exceeds the 227 KB of shared memory a block may use"),
    ],
)


def _matmul_heuristic(x, w):
    """Decode rows (m <= 16) run one 16-row tile with a deep k slice: each
    k step costs a round trip to device memory, so fewer, larger steps win
    there. Larger m takes 64x64x64 tiles, which beat 128x32x32 at every
    prefill shape of qwen2_0_5b on an H100 SXM (chip_smoke.py)."""
    if x.shape[0] <= 16:
        return {"bm": 16, "bn": 64, "bk": 128}
    return {"bm": 64 if x.shape[0] >= 64 else 32, "bn": 64, "bk": 64}


def _matmul_canon(x, w):
    """Flatten leading dims to rows: [..., k] @ [k, n], row-major."""
    if x.dim() == 2:
        return (x.contiguous(), w), lambda out: out
    lead = x.shape[:-1]
    return ((x.reshape(-1, x.shape[-1]).contiguous(), w),
            lambda out: out.reshape(*lead, out.shape[-1]))


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 accumulation, cast."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def matmul_cuda(x: torch.Tensor, w: torch.Tensor, *, bm: int, bn: int, bk: int) -> torch.Tensor:
    """Launch csrc/matmul.cu on CUDA tensors."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul takes [m,k] @ [k,n], got {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"matmul kernel takes matching f32 or bf16 operands, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul kernel takes row-major contiguous operands only")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = _build.entry("matmul", "repro_matmul",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, _DTYPES[x.dtype],
             bm, bn, bk, _build.stream_ptr(x.device))
    _build.check("matmul", err, f"matmul {m}x{k}x{n} bm={bm} bn={bn} bk={bk}")
    _build.LAUNCHES["matmul"] += 1
    return out


@tunable(
    "matmul",
    space=MATMUL_SPACE,
    reference=ref.matmul,
    heuristic=_matmul_heuristic,
    dispatch=DispatchSpec(canonicalize=_matmul_canon),
)
def matmul(x, w, *, bm: int, bn: int, bk: int):
    if x.is_cuda:
        return matmul_cuda(x, w, bm=bm, bn=bn, bk=bk)
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    raise RuntimeError(f"matmul has no kernel for device {x.device}")
