"""Softmax cross entropy over large vocabularies: the ``softmax_xent`` and
``softmax_xent_bwd`` tunables and their CUDA kernels.

Replaces the TPU kernels ``repro/kernels/xent.py:_xent_kernel``
(``softmax_xent_pallas``) and ``_xent_bwd_kernel``
(``softmax_xent_bwd_pallas``). The forward streams the logits once with an
online logsumexp and gathers the label logit on the way, returning the
per-row loss and the fp32 lse; the backward is one streaming pass from that
saved lse, ``(exp(x - lse) - onehot(label)) * ct`` in the logits' dtype.
The CUDA source is ``csrc/xent.cu``, whose header says what bounds both
kernels and what the design does about it.

The knobs are launch parameters shared by both kernels: ``block_rows`` is
the number of rows (one warp each) a CTA takes, and ``block_v`` the
vocabulary columns a warp covers in one step. The forward holds ``block_v
/ 32`` values a lane in registers, so ``block_v`` is at most 2048 (about
128 registers a thread), and a CTA at most 16 warps: at 32 warps the
1,024 threads would need more than an SM's 65,536 registers and the
launch is refused.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import DispatchSpec, ParamSpace, PowerOfTwoParam, tunable
from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABELS = (torch.int32, torch.int64)

XENT_SPACE = ParamSpace([
    PowerOfTwoParam("block_rows", 1, 16),
    PowerOfTwoParam("block_v", 256, 2048),
])


def _xent_heuristic(logits, labels):
    """Four rows (128 threads) a CTA; the widest step that the row fills
    (2048 columns, 64 registers a lane, at the 151,936-word vocabulary)."""
    vocab = logits.shape[1]
    bv = 256
    while bv < 2048 and bv < vocab:
        bv *= 2
    return {"block_rows": 4, "block_v": bv}


def _check(logits, labels):
    if logits.dim() != 2 or labels.shape != (logits.shape[0],):
        raise ValueError(f"softmax_xent takes logits [rows, vocab] and labels [rows], got "
                         f"{tuple(logits.shape)}, {tuple(labels.shape)}")
    if labels.dtype not in _LABELS:
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")


def softmax_xent_plain(logits, labels):
    """The forward kernel's function in plain PyTorch: (loss, lse), fp32;
    a label off the row contributes a label logit of 0, as on the TPU."""
    _check(logits, labels)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    lab = labels.long()
    hit = (lab >= 0) & (lab < lf.shape[1])
    ll = lf.gather(-1, lab.clamp(0, lf.shape[1] - 1)[:, None])[:, 0]
    return lse - torch.where(hit, ll, torch.zeros_like(ll)), lse


def softmax_xent_cuda(logits, labels, *, block_rows: int, block_v: int):
    """Launch the forward of csrc/xent.cu on CUDA tensors: (loss, lse)."""
    _check(logits, labels)
    if logits.dtype not in _DTYPES:
        raise TypeError(f"softmax_xent kernel takes f32 or bf16 logits, got {logits.dtype}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("softmax_xent kernel takes contiguous logits and labels only")
    if logits.device != labels.device:
        raise ValueError(f"logits on {logits.device}, labels on {labels.device}")
    rows, vocab = logits.shape
    lab = labels.long()
    loss = torch.empty((rows,), dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    fn = _build.entry("xent", "repro_softmax_xent",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(logits.data_ptr(), lab.data_ptr(), loss.data_ptr(), lse.data_ptr(), rows, vocab,
             _DTYPES[logits.dtype], block_rows, block_v, _build.stream_ptr(logits.device))
    _build.check("xent", err, f"softmax_xent {rows}x{vocab} block_rows={block_rows} "
                              f"block_v={block_v}")
    _build.LAUNCHES["softmax_xent"] += 1
    return loss, lse


def _xent_bwd_plan(ct, logits, labels, loss, lse, **kwargs):
    """Backward plan: d_logits is one ``softmax_xent_bwd`` dispatch site
    handed the saved lse; labels carry no gradient."""
    from ..core.runtime import dispatch

    del loss
    return dispatch("softmax_xent_bwd", ct, logits, labels, lse, **kwargs), None


@tunable(
    "softmax_xent",
    space=XENT_SPACE,
    reference=ref.softmax_xent_res,
    heuristic=_xent_heuristic,
    # logits and labels both lead with the token-row dim.
    dispatch=DispatchSpec(reference=ref.softmax_xent, data_parallel_args=(0, 1),
                          vjp="dispatch", bwd=_xent_bwd_plan, residuals=1),
)
def softmax_xent(logits, labels, *, block_rows: int, block_v: int):
    if logits.is_cuda:
        return softmax_xent_cuda(logits, labels, block_rows=block_rows, block_v=block_v)
    if logits.device.type == "cpu":
        return softmax_xent_plain(logits, labels)
    raise _build.KernelUnavailable(f"softmax_xent has no kernel for device {logits.device}")


# ---------------------------------------------------------------------------
# Backward: d_logits = (softmax - onehot(label)) * ct, one streaming pass
# ---------------------------------------------------------------------------


def _check_bwd(ct, logits, labels, lse):
    _check(logits, labels)
    rows = logits.shape[0]
    if ct.shape != (rows,) or lse.shape != (rows,):
        raise ValueError(f"softmax_xent_bwd takes ct and lse [rows], got {tuple(ct.shape)}, "
                         f"{tuple(lse.shape)} for {rows} rows")


def softmax_xent_bwd_plain(ct, logits, labels, lse):
    """The backward kernel's function in plain PyTorch, in the logits' dtype."""
    _check_bwd(ct, logits, labels, lse)
    lf = logits.float()
    cols = torch.arange(lf.shape[1], device=lf.device)
    hit = (cols[None, :] == labels.long()[:, None]).float()
    return ((torch.exp(lf - lse.float()[:, None]) - hit) * ct.float()[:, None]).to(logits.dtype)


def softmax_xent_bwd_cuda(ct, logits, labels, lse, *, block_rows: int, block_v: int):
    """Launch the backward of csrc/xent.cu on CUDA tensors: d_logits."""
    _check_bwd(ct, logits, labels, lse)
    if logits.dtype not in _DTYPES or ct.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError(f"softmax_xent_bwd kernel takes f32 or bf16 logits and fp32 ct, lse; "
                        f"got {logits.dtype}, {ct.dtype}, {lse.dtype}")
    if not all(t.is_contiguous() for t in (ct, logits, labels, lse)):
        raise ValueError("softmax_xent_bwd kernel takes contiguous tensors only")
    if not (ct.device == logits.device == labels.device == lse.device):
        raise ValueError("softmax_xent_bwd tensors on different devices")
    rows, vocab = logits.shape
    lab = labels.long()
    dl = torch.empty_like(logits)
    fn = _build.entry("xent", "repro_softmax_xent_bwd",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(ct.data_ptr(), logits.data_ptr(), lab.data_ptr(), lse.data_ptr(), dl.data_ptr(),
             rows, vocab, _DTYPES[logits.dtype], block_rows, block_v,
             _build.stream_ptr(logits.device))
    _build.check("xent", err, f"softmax_xent_bwd {rows}x{vocab} block_rows={block_rows} "
                              f"block_v={block_v}")
    _build.LAUNCHES["softmax_xent_bwd"] += 1
    return dl


def _xent_bwd_heuristic(ct, logits, labels, lse):
    return _xent_heuristic(logits, labels)


@tunable(
    "softmax_xent_bwd",
    space=XENT_SPACE,
    reference=ref.softmax_xent_bwd,
    heuristic=_xent_bwd_heuristic,
    # vjp="reference": the oracle is differentiable torch (grad-of-grad).
    dispatch=DispatchSpec(data_parallel_args=(0, 1, 2, 3), vjp="reference"),
)
def softmax_xent_bwd(ct, logits, labels, lse, *, block_rows: int, block_v: int):
    if logits.is_cuda:
        return softmax_xent_bwd_cuda(ct, logits, labels, lse, block_rows=block_rows,
                                     block_v=block_v)
    if logits.device.type == "cpu":
        return softmax_xent_bwd_plain(ct, logits, labels, lse)
    raise _build.KernelUnavailable(f"softmax_xent_bwd has no kernel for device {logits.device}")
