"""Fused-epilogue tunables: ``matmul_bias_act`` and ``rmsnorm_matmul``.

Replace the TPU kernels ``repro/kernels/fused.py:_mba_kernel``
(``matmul_bias_act_pallas``) and ``_rmm_kernel``
(``rmsnorm_matmul_pallas``):

* ``matmul_bias_act`` -- ``act(x @ w + b)``: a gemm whose epilogue adds the
  bias and applies the activation (none, gelu in its tanh form, silu) to
  the fp32 accumulator, so the [m, n] pre-activation never round-trips
  through device memory. CUDA source ``csrc/matmul_bias_act.cu``, a thin
  entry over ``csrc/gemm.cuh``: ``matmul``'s kernels, routes, knob space
  (:data:`~.matmul.MATMUL_SPACE`), heuristic and split-k partition, with
  the epilogue on every route.
* ``rmsnorm_matmul`` -- ``rmsnorm(x, scale) @ w``: the same gemm with a
  norm prologue on x. CUDA source ``csrc/rmsnorm_matmul.cu``, a thin entry
  over ``csrc/gemm.cuh``'s tensor-core routes (decode, tc, split-k) on
  ``matmul``'s space, heuristic and route rule: each CTA computes its rows'
  inverse rms and normalises each k slice of x in shared memory before
  ``wgmma`` reads it, so every width launches. bf16 operands TMA cannot
  address and fp32 run a k-sliced loop of the same file
  (:func:`rmm_plan`). Each launch counts its route as ``matmul`` does
  (``rmsnorm_matmul_decode``, ``_tc``, ``_wmma``, ``_simt``, ``_splitk``).

Model sites take these only where the tuning database holds an exact record
for the call (``runtime.fusion_wins``); everywhere else they keep their
unfused dispatches. The backward plans decompose onto the ``matmul``,
``rmsnorm`` and ``rmsnorm_bwd`` dispatch sites, so the unfused records
serve the gradients.

On a CPU tensor each wrapper runs its plain version, which follows the
kernel's arithmetic and cast order; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import DispatchSpec, tunable
from . import _build, ref
from . import matmul as mm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {"none": 0, "gelu": 1, "silu": 2}


def _check_2d(name: str, *ts):
    if any(t.dim() != 2 for t in ts):
        raise ValueError(f"{name} takes 2-D operands, got {[tuple(t.shape) for t in ts]}")


def _check_common(name: str, *ts):
    dtype, device = ts[0].dtype, ts[0].device
    if dtype not in _DTYPES or any(t.dtype != dtype for t in ts):
        raise TypeError(f"{name} kernel takes matching f32 or bf16 tensors, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.device != device for t in ts):
        raise ValueError(f"{name} tensors on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} kernel takes contiguous tensors only")


# ---------------------------------------------------------------------------
# matmul_bias_act: the gemm with a bias + activation epilogue
# ---------------------------------------------------------------------------

def _mba_heuristic(x, w, b):
    """matmul's rule (:func:`~.matmul.gemm_heuristic`) at the call's shape:
    the decode route for at most 16 rows, the tc route's tiles above."""
    return mm.gemm_heuristic(x.shape[0], w.shape[1], x.shape[1])


def _mba_canon(x, w, b):
    """Flatten leading dims to rows, as matmul's canonicalisation does."""
    if x.dim() == 2:
        return (x, w, b), lambda out: out
    lead = x.shape[:-1]
    return ((x.reshape(-1, x.shape[-1]), w, b),
            lambda out: out.reshape(*lead, out.shape[-1]))


def _mba_bwd(ct, x, w, b, act: str = "none", **kwargs):
    """Backward plan, decomposed onto ``matmul`` dispatch sites: the
    pre-activation the fused forward never stored is one matmul dispatch
    again, the epilogue's cotangent g = act'(h) * ct is plain torch, and dx,
    dw are the transposed-operand gemms (``repro``'s ``_mba_bwd``)."""
    from ..core.runtime import dispatch

    if act == "none":
        g = ct
    else:
        h = dispatch("matmul", x, w) + b
        g = ref.vjp(lambda hh: ref.apply_act(hh.float(), act), (h,), ct.float())[0]
        g = g.to(ct.dtype)
    dx = dispatch("matmul", g, w.T, **kwargs)
    dw = dispatch("matmul", x.T, g, dp_dims={0: 1, 1: 0}, **kwargs)
    db = g.sum(dim=0).to(b.dtype)
    return dx, dw, db


def matmul_bias_act_plain(x, w, b, act: str = "none"):
    """The kernel's function in plain PyTorch: fp32 product, bias and
    activation in fp32, one cast."""
    return ref.matmul_bias_act(x, w, b, act)


_MBA_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def matmul_bias_act_cuda(x, w, b, *, bm: int, bn: int, bk: int, stages: int, splits: int,
                         act: str = "none", force_loop: bool = False):
    """Launch csrc/matmul_bias_act.cu on CUDA tensors, on the route
    :func:`~.matmul.plan` gives the call; either operand may be a
    transposed view. ``force_loop`` runs the first port's tile loop whatever
    the rule says (a before-and-after of the same call)."""
    _check_2d("matmul_bias_act", x, w)
    if x.shape[1] != w.shape[0] or b.shape != (w.shape[1],):
        raise ValueError(f"matmul_bias_act takes [m,k] @ [k,n] + [n], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if act not in ACTS:
        raise ValueError(f"unknown fused activation {act!r}")
    if not (x.dtype == w.dtype == b.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"matmul_bias_act kernel takes matching f32 or bf16 tensors, got "
                        f"{[x.dtype, w.dtype, b.dtype]}")
    if not (x.device == w.device == b.device):
        raise ValueError("matmul_bias_act tensors on different devices")
    if not b.is_contiguous():
        raise ValueError("matmul_bias_act takes a contiguous bias")
    (ta, lda), (tb, ldb) = mm.layout(x), mm.layout(w)
    m, k = x.shape
    n = w.shape[1]
    p = mm.plan(x, w, dict(bm=bm, bn=bn, bk=bk, stages=stages, splits=splits), force_loop)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = mm.workspace(p, 1, m, n, x.device)
    fn = _build.entry("matmul_bias_act", "repro_matmul_bias_act", _MBA_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), m, n, k, int(ta), int(tb), lda, ldb,
             _DTYPES[x.dtype], ACTS[act], p["code"], p["bm"], p["bn"], p["bk"], p["stages"],
             p["splits"], p["kps"], _build.stream_ptr(x.device))
    _build.check("matmul_bias_act", err,
                 f"matmul_bias_act {m}x{k}x{n} act={act} ta={ta} tb={tb} {p}")
    mm.count_launch("matmul_bias_act", p, ta or tb)
    return out


@tunable(
    "matmul_bias_act",
    space=mm.MATMUL_SPACE,
    reference=ref.matmul_bias_act,
    heuristic=_mba_heuristic,
    dispatch=DispatchSpec(
        # Same shapes, another epilogue: a record of its own.
        key_extra=lambda kw: f"a{kw.get('act', 'none')}",
        canonicalize=_mba_canon,
        vjp="dispatch",
        bwd=_mba_bwd,
    ),
)
def matmul_bias_act(x, w, b, *, bm: int, bn: int, bk: int, stages: int, splits: int,
                    act: str = "none"):
    if x.is_cuda:
        return matmul_bias_act_cuda(x, w, b, bm=bm, bn=bn, bk=bk, stages=stages,
                                    splits=splits, act=act)
    if x.device.type == "cpu":
        return matmul_bias_act_plain(x, w, b, act)
    raise _build.KernelUnavailable(f"matmul_bias_act has no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# rmsnorm_matmul: the norm as the gemm's prologue
# ---------------------------------------------------------------------------

def _rmm_heuristic(x, scale, w):
    """matmul's rule (:func:`~.matmul.gemm_heuristic`) at the call's rows,
    width and vocabulary: the decode route for at most 16 rows, the tc
    route's tiles above."""
    m = 1
    for s in x.shape[:-1]:
        m *= int(s)
    return mm.gemm_heuristic(m, w.shape[1], x.shape[-1])


def _rmm_canon(x, scale, w):
    """Flatten leading dims to rows: [..., d] -> [rows, d]."""
    if x.dim() == 2:
        return (x, scale, w), lambda out: out
    lead = x.shape[:-1]
    return ((x.reshape(-1, x.shape[-1]), scale, w),
            lambda out: out.reshape(*lead, out.shape[-1]))


def _rmm_bwd(ct, x, scale, w, eps: float = 1e-6, **kwargs):
    """Backward plan, decomposed onto the ``rmsnorm``, ``matmul`` and
    ``rmsnorm_bwd`` dispatch sites (``repro``'s ``_rmm_bwd``): the
    normalised rows are one rmsnorm dispatch again, the projection's
    gradients are transposed-operand gemms, and the norm's gradient goes
    through rmsnorm_bwd with the inverse rms rebuilt from x."""
    from ..core.runtime import dispatch

    xn = dispatch("rmsnorm", x, scale, eps=eps)
    d_xn = dispatch("matmul", ct, w.T, **kwargs)
    dw = dispatch("matmul", xn.T, ct, dp_dims={0: 1, 1: 0}, **kwargs)
    xf = x.float()
    invrms = torch.rsqrt((xf * xf).mean(dim=-1) + eps)
    dx, dscale = dispatch("rmsnorm_bwd", d_xn, x, scale, invrms, **kwargs)
    return dx, dscale, dw


def rmsnorm_matmul_plain(x, scale, w, eps: float = 1e-6):
    """The kernel's function in plain PyTorch, in its cast order."""
    return ref.rmsnorm_matmul(x, scale, w, eps)


_RMM_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
                 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def rmm_plan(x, scale, w, cfg, force_loop: bool = False) -> dict:
    """The launch of one call: :func:`~.matmul.plan`'s route and tiles for
    x and w, the scale being a TMA operand of the tensor-core routes too
    (its base a multiple of 16 bytes). fp32, a scale TMA cannot address and
    ``force_loop`` take the k-sliced loop of ``csrc/rmsnorm_matmul.cu`` at
    :func:`~.matmul.wmma_tiles` (route ``wmma`` in bf16, ``simt`` in fp32):
    the prologue exists on the tensor-core routes only."""
    loop = force_loop or x.dtype == torch.float32 or scale.data_ptr() % 16 != 0
    return mm.plan(x, w, cfg, loop)


def prologue_smem_bytes(c) -> int:
    """Shared memory of one tensor-core CTA with the norm prologue (mirrors
    gemm.cuh's norm_smem and decode_norm_smem): the tc route's is matmul's
    plus a scale slice a stage from a 128-byte boundary; the decode route's
    persistent kernel keeps C's staged tile apart from its ring."""
    bn, bk, st = c["bn"], c["bk"], c["stages"]
    norm = 128 + st * bk * 2
    if c["bm"] == mm.DECODE_ROWS:
        return 1024 + st * (bn + mm.DECODE_ROWS) * bk * 2 + norm + mm.DECODE_ROWS * (bn + 4) * 4
    return mm.smem_bytes(c) + norm


def rmsnorm_matmul_cuda(x, scale, w, *, bm: int, bn: int, bk: int, stages: int, splits: int,
                        eps: float = 1e-6, force_loop: bool = False):
    """Launch csrc/rmsnorm_matmul.cu on CUDA tensors, on the route
    :func:`rmm_plan` gives the call. ``force_loop`` runs the k-sliced loop
    whatever the rule says (a before-and-after of the same call)."""
    _check_2d("rmsnorm_matmul", x, w)
    if x.shape[1] != w.shape[0] or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_matmul takes [m,d], [d], [d,n], got {tuple(x.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(w.shape)}")
    _check_common("rmsnorm_matmul", x, scale, w)
    m, d = x.shape
    n = w.shape[1]
    p = rmm_plan(x, scale, w, dict(bm=bm, bn=bn, bk=bk, stages=stages, splits=splits),
                 force_loop)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = mm.workspace(p, 1, m, n, x.device)
    fn = _build.entry("rmsnorm_matmul", "repro_rmsnorm_matmul", _RMM_ARGTYPES)
    err = fn(x.data_ptr(), scale.data_ptr(), w.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), m, n, d, float(eps), _DTYPES[x.dtype],
             p["code"], p["bm"], p["bn"], p["bk"], p["stages"], p["splits"], p["kps"],
             _build.stream_ptr(x.device))
    _build.check("rmsnorm_matmul", err, f"rmsnorm_matmul {m}x{d}x{n} {p}")
    mm.count_launch("rmsnorm_matmul", p, False)
    return out


@tunable(
    "rmsnorm_matmul",
    space=mm.MATMUL_SPACE,
    reference=ref.rmsnorm_matmul,
    heuristic=_rmm_heuristic,
    dispatch=DispatchSpec(canonicalize=_rmm_canon, vjp="dispatch", bwd=_rmm_bwd),
)
def rmsnorm_matmul(x, scale, w, *, bm: int, bn: int, bk: int, stages: int, splits: int,
                   eps: float = 1e-6):
    if x.is_cuda:
        return rmsnorm_matmul_cuda(x, scale, w, bm=bm, bn=bn, bk=bk, stages=stages,
                                   splits=splits, eps=eps)
    if x.device.type == "cpu":
        return rmsnorm_matmul_plain(x, scale, w, eps)
    raise _build.KernelUnavailable(f"rmsnorm_matmul has no kernel for device {x.device}")
