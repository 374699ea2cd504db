"""Reference implementations in plain PyTorch: the Reference tier.

Same math as ``repro.kernels.ref``: ``dispatch`` runs these in reference
mode. Each kernel module also keeps a plain version of its own kernel,
which follows the kernel's arithmetic where it differs from these (rmsnorm
multiplies by the weight before the cast there, after it here).

The backward oracles (``*_bwd``) are the autograd VJPs of the forward
oracles, called with the cotangent first, so a forward and its backward
cannot drift apart. Each is differentiable again where grad mode is on and
an input requires grad (grad-of-grad through a dispatched gradient site).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[m, k] @ [k, n] -> [m, n], fp32 accumulation, output in x.dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _invrms(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps), cast to x.dtype, then * weight."""
    return (x.float() * _invrms(x, eps)).to(x.dtype) * weight


def rmsnorm_res(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """:func:`rmsnorm` plus its per-row inverse rms ([rows] fp32)."""
    r = _invrms(x, eps)
    return (x.float() * r).to(x.dtype) * weight, r[..., 0]


def _scores(q, k, causal: bool, scale: Optional[float], window: int):
    b, h, s_q, d = q.shape
    kv, s_k = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"heads {h} not a multiple of kv heads {kv}")
    scale = scale if scale is not None else d ** -0.5
    k = k.repeat_interleave(h // kv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal or window:
        q_idx = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
        k_idx = torch.arange(s_k, device=q.device)[None, :]
        mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_idx >= k_idx
        if window:
            mask &= (q_idx - k_idx) < window
        s = s.masked_fill(~mask, float("-inf"))
    return s


def attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
              window: int = 0) -> torch.Tensor:
    """GQA attention, q [b,h,s_q,d], k/v [b,kv,s_k,d]; q aligned to the end of k."""
    s = _scores(q, k, causal, scale, window)
    p = torch.softmax(s, dim=-1)
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_res(q, k, v, causal: bool = True, scale: Optional[float] = None,
                  window: int = 0):
    """:func:`attention` plus its per-query logsumexp ([b, h, s_q] fp32)."""
    s = _scores(q, k, causal, scale, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype), lse


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy: [r, v], [r] -> [r] (fp32)."""
    return softmax_xent_res(logits, labels)[0]


def softmax_xent_res(logits: torch.Tensor, labels: torch.Tensor):
    """:func:`softmax_xent` plus its per-row logsumexp ([r] fp32)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = lf.gather(-1, labels.long()[:, None])[:, 0]
    return lse - label_logit, lse


def vjp(fn: Callable, primals: Sequence[torch.Tensor], ct):
    """Gradients of ``fn(*primals)`` against the cotangent(s) ``ct``, one per
    primal (``None`` for a primal that is not floating point).

    The result carries a graph (so it can be differentiated again) exactly
    when grad mode is on and a primal or a cotangent requires grad.
    """
    cts = ct if isinstance(ct, (tuple, list)) else (ct,)
    create = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*primals, *cts) if isinstance(t, torch.Tensor))
    with torch.enable_grad():
        ins = [p if (create and p.requires_grad) or not p.is_floating_point()
               else p.detach().requires_grad_() for p in primals]
        out = fn(*ins)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        diff = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(outs, diff, cts, create_graph=create,
                                         allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in ins)


def rmsnorm_bwd(ct: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                invrms: Optional[torch.Tensor] = None, eps: float = 1e-6):
    """VJP of :func:`rmsnorm`: (d_x, d_weight). ``invrms`` is the residual
    the kernel consumes; the oracle re-derives everything from x."""
    del invrms
    return vjp(lambda xx, ww: rmsnorm(xx, ww, eps), (x, weight), ct)


def attention_bwd(ct, q, k, v, o=None, lse=None, causal: bool = True,
                  scale: Optional[float] = None, window: int = 0):
    """VJP of :func:`attention`: (d_q, d_k, d_v). ``o`` and ``lse`` are the
    residuals the kernel consumes; the oracle recomputes from (q, k, v)."""
    del o, lse
    return vjp(lambda qq, kk, vv: attention(qq, kk, vv, causal=causal, scale=scale,
                                            window=window), (q, k, v), ct)


def softmax_xent_bwd(ct: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor,
                     lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """VJP of :func:`softmax_xent` with respect to the logits: (softmax -
    onehot) * ct. Labels carry no gradient; ``lse`` is the kernel's
    residual, which the oracle recomputes."""
    del lse
    return vjp(lambda ll: softmax_xent(ll, labels), (logits,), ct)[0]
