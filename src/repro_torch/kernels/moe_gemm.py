"""Grouped expert gemm: the ``expert_gemm`` tunable and its CUDA kernels,
the MoE dispatch site keyed on (experts x capacity x hidden).

Replaces the TPU kernel ``repro/kernels/moe_gemm.py:_expert_gemm_kernel``
(``expert_gemm_pallas``): ``[e, c, k] @ [e, k, n]`` with fp32 accumulation
and the output in ``x.dtype``, one product per expert. The CUDA source is
``csrc/expert_gemm.cu``, whose header says what bounds it on an H100 and
what its design does about that; its kernels are ``csrc/gemm.cuh``'s,
shared with ``matmul``, the expert a product of the batch.

Routes and knobs are ``matmul``'s (:func:`~repro_torch.kernels.matmul.route`
on 3-D operands; :data:`~repro_torch.kernels.matmul.MATMUL_SPACE`'s limits)
under the JAX package's name ``bc`` for the row knob: ``bc`` 16 is the
swap-AB decode route (the heuristic's pick at decode capacities, c <= 16;
c = 2 for 8 slots, top-2 of 8 experts), 64 or 128 the ``wgmma`` route with
one or two consumer warpgroups; ``bn``, ``bk``, ``stages`` and ``splits``
as for ``matmul``. bf16 operands that TMA cannot address (the transposed
``x`` of a ragged capacity such as c = 37, whose expert stride is not a
multiple of 16 bytes) take the WMMA route; fp32 the SIMT route.

Training differentiates it by the backward plan :func:`_expert_gemm_bwd`:
``dx = ct @ swapaxes(w)`` and ``dw = swapaxes(x) @ ct``, both
``expert_gemm`` dispatch sites with their own database keys. The kernels
read each operand with its expert stride and its layout (row-major or
transposed), so the swapaxes views are never copied.

On a CPU tensor the wrapper runs :func:`expert_gemm_plain`, the kernel's
function in plain PyTorch; on a CUDA tensor it launches a kernel or
raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import Constraint, DispatchSpec, Param, ParamSpace, tunable
from . import _build, ref
from . import matmul as mm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _tile(c):
    """An expert_gemm config as matmul's knobs."""
    return {"bm": c["bc"], **{k: c[k] for k in ("bn", "bk", "stages", "splits")}}


# matmul's space under the JAX package's knob names.
EXPERT_GEMM_SPACE = ParamSpace(
    [Param("bc", mm.MATMUL_SPACE["bm"].choices)]
    + [mm.MATMUL_SPACE[k] for k in ("bn", "bk", "stages", "splits")],
    [Constraint(lambda c, con=con: con(_tile(c)), con.reason)
     for con in mm.MATMUL_SPACE.constraints],
)


def _expert_gemm_heuristic(x, w):
    """matmul's heuristic over the e experts' products (so its split-k
    counts the experts' tiles): decode capacities take the decode route,
    prefill ones 128 x 128 tiles."""
    e, c, k = x.shape
    cfg = mm.gemm_heuristic(c, w.shape[2], k, e)
    return {"bc": cfg.pop("bm"), **cfg}


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
    kernels read it: each expert's matrix row-major or transposed (see
    :func:`~repro_torch.kernels.matmul.layout`), the experts ``stride(0)``
    elements apart (0 for a broadcast operand). Raises for other strides."""
    return mm.operand(t)


def expert_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 accumulation, cast."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def expert_gemm_cuda(x: torch.Tensor, w: torch.Tensor, *, bc: int, bn: int, bk: int,
                     stages: int, splits: int, force_loop: bool = False) -> torch.Tensor:
    """Launch csrc/expert_gemm.cu on CUDA tensors; either operand may be a
    transposed (swapaxes) view or broadcast over the experts.
    ``force_loop`` runs the first port's tile loop whatever the rule says."""
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
    p = mm.plan(x, w, dict(bm=bc, bn=bn, bk=bk, stages=stages, splits=splits), force_loop)
    ws = mm.workspace(p, e, c, n, x.device)
    fn = _build.entry("expert_gemm", "repro_expert_gemm",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4
                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
             e, c, n, k, int(tx), int(tw), ldx, ldw, sx, sw, _DTYPES[x.dtype],
             p["code"], p["bm"], p["bn"], p["bk"], p["stages"], p["splits"],
             p["kps"], _build.stream_ptr(x.device))
    _build.check("expert_gemm", err, f"expert_gemm {e}x{c}x{k}x{n} tx={tx} tw={tw} {p}")
    mm.count_launch("expert_gemm", p, tx or tw)
    return out


@tunable(
    "expert_gemm",
    space=EXPERT_GEMM_SPACE,
    reference=ref.expert_gemm,
    heuristic=_expert_gemm_heuristic,
    dispatch=DispatchSpec(example=_expert_gemm_example, data_parallel_args=(),
                          vjp="dispatch", bwd=_expert_gemm_bwd),
)
def expert_gemm(x, w, *, bc: int, bn: int, bk: int, stages: int, splits: int):
    if x.is_cuda:
        return expert_gemm_cuda(x, w, bc=bc, bn=bn, bk=bk, stages=stages, splits=splits)
    if x.device.type == "cpu":
        return expert_gemm_plain(x, w)
    raise _build.KernelUnavailable(f"expert_gemm has no kernel for device {x.device}")
