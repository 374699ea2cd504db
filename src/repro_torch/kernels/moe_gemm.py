"""Grouped expert gemm: the ``expert_gemm`` tunable and its CUDA kernel,
the MoE dispatch site keyed on (experts x capacity x hidden).

Replaces the TPU kernel ``repro/kernels/moe_gemm.py:_expert_gemm_kernel``
(``expert_gemm_pallas``): ``[e, c, k] @ [e, k, n]`` with fp32 accumulation
and the output in ``x.dtype``, one product per expert. The CUDA source is
``csrc/expert_gemm.cu``, whose header says what bounds it on an H100 and
what its design does about that; its tile loop is ``csrc/gemm.cuh``,
shared with ``matmul``.

The knobs are the kernel's launch parameters: ``(bc, bn)`` is the CTA's
tile of one expert's output and ``bk`` the k slice staged in shared memory
per step. Their limits come from the H100, not from the TPU's VMEM: at
most 512 threads a CTA (one warp per 16x32 or 32x32 sub-tile, under
``__launch_bounds__``) and at most 227 KB of shared memory a block, the
tile loop's own, as for ``matmul``.

Training differentiates it by the backward plan :func:`_expert_gemm_bwd`:
``dx = ct @ swapaxes(w)`` and ``dw = swapaxes(x) @ ct``, both
``expert_gemm`` dispatch sites with their own database keys. The kernel
reads each operand with its expert stride and its layout (row-major or
transposed), so the swapaxes views are never copied.

On a CPU tensor the wrapper runs :func:`expert_gemm_plain`, the kernel's
function in plain PyTorch; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import Constraint, DispatchSpec, ParamSpace, PowerOfTwoParam, tunable
from ..core.platform import H100_SXM
from . import _build, ref
from . import matmul as mm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _tile(c):
    """An expert_gemm config as the shared tile loop's (matmul's) knobs."""
    return {"bm": c["bc"], "bn": c["bn"], "bk": c["bk"]}


# matmul's space under the JAX package's knob names.
EXPERT_GEMM_SPACE = ParamSpace(
    [
        PowerOfTwoParam("bc", 16, 256),
        PowerOfTwoParam("bn", 32, 256),
        PowerOfTwoParam("bk", 16, 128),
    ],
    [
        Constraint(lambda c: mm._threads(_tile(c)) <= mm.MAX_THREADS,
                   "CTA exceeds 512 threads (one warp per 32x32 output sub-tile)"),
        Constraint(lambda c: max(mm.smem_bytes(_tile(c), 2), mm.smem_bytes(_tile(c), 4))
                   <= H100_SXM.smem_per_block,
                   "CTA tile exceeds the 227 KB of shared memory a block may use"),
    ],
)


def _expert_gemm_heuristic(x, w):
    """Decode capacities (c <= 16; c = 2 for 8 slots, top-2 of 8 experts)
    run one 16-row tile with a deep k slice: the gemm is a weight read,
    and fewer, larger k steps stream it better. Larger c takes matmul's
    prefill tiles, 64x64x64 (32 rows below 64)."""
    c = x.shape[1]
    if c <= 16:
        return {"bc": 16, "bn": 64, "bk": 128}
    return {"bc": 64 if c >= 64 else 32, "bn": 64, "bk": 64}


def _expert_gemm_example():
    rs = np.random.RandomState(0)
    t = lambda *shape: torch.from_numpy(rs.randn(*shape).astype(np.float32))
    return (t(2, 12, 16), t(2, 16, 8)), {}


def _expert_gemm_bwd(ct, x, w, **kwargs):
    """Backward plan: dL/dx = ct [e,c,n] @ swapaxes(w) [e,n,k] and dL/dw =
    swapaxes(x) [e,k,c] @ ct [e,c,n], each an ``expert_gemm`` dispatch site
    with its own database key (the keys of
    ``repro.kernels.moe_gemm._expert_gemm_bwd``)."""
    from ..core.runtime import dispatch

    dx = dispatch("expert_gemm", ct, w.transpose(1, 2), **kwargs)
    dw = dispatch("expert_gemm", x.transpose(1, 2), ct, **kwargs)
    return dx, dw


def expert_layout(t: torch.Tensor):
    """(transposed, leading dim, expert stride) of a 3-D operand as the
    kernel reads it: each expert's matrix row-major or transposed (see
    :func:`~repro_torch.kernels.matmul.layout`), the experts ``stride(0)``
    elements apart (0 for a broadcast operand). Raises for other strides."""
    tr, ld = mm.layout(t[0])
    return tr, ld, (t.stride(0) if t.shape[0] > 1 else 0)


def expert_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 accumulation, cast."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def expert_gemm_cuda(x: torch.Tensor, w: torch.Tensor, *, bc: int, bn: int,
                     bk: int) -> torch.Tensor:
    """Launch csrc/expert_gemm.cu on CUDA tensors; either operand may be a
    transposed (swapaxes) view or broadcast over the experts."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"expert_gemm takes [e,c,k] @ [e,k,n], got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"expert_gemm kernel takes matching f32 or bf16 operands, got "
                        f"{x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    e, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    (tx, ldx, sx), (tw, ldw, sw) = expert_layout(x), expert_layout(w)
    fn = _build.entry("expert_gemm", "repro_expert_gemm",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, n, k, int(tx), int(tw), ldx, ldw,
             sx, sw, _DTYPES[x.dtype], bc, bn, bk, _build.stream_ptr(x.device))
    _build.check("expert_gemm", err, f"expert_gemm {e}x{c}x{k}x{n} tx={tx} tw={tw} bc={bc} "
                 f"bn={bn} bk={bk}")
    _build.LAUNCHES["expert_gemm"] += 1
    if tx or tw:
        _build.LAUNCHES["expert_gemm_transposed"] += 1
    return out


@tunable(
    "expert_gemm",
    space=EXPERT_GEMM_SPACE,
    reference=ref.expert_gemm,
    heuristic=_expert_gemm_heuristic,
    dispatch=DispatchSpec(example=_expert_gemm_example, data_parallel_args=(),
                          vjp="dispatch", bwd=_expert_gemm_bwd),
)
def expert_gemm(x, w, *, bc: int, bn: int, bk: int):
    if x.is_cuda:
        return expert_gemm_cuda(x, w, bc=bc, bn=bn, bk=bk)
    if x.device.type == "cpu":
        return expert_gemm_plain(x, w)
    raise RuntimeError(f"expert_gemm has no kernel for device {x.device}")
