"""Reference implementations in plain PyTorch: the Reference tier.

Same math as ``repro.kernels.ref``: ``dispatch`` runs these in reference
mode. Each kernel module also keeps a plain version of its own kernel,
which follows the kernel's arithmetic where it differs from these (rmsnorm
multiplies by the weight before the cast there, after it here).
"""
from __future__ import annotations

from typing import Optional

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
