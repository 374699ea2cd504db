"""Flash attention (causal / sliding-window, GQA): the ``flash_attention``
tunable and its CUDA kernel.

Replaces the TPU kernel ``repro/kernels/attention.py:_flash_kernel``
(``flash_attention_pallas``): q ``[b,h,s_q,d]``, k/v ``[b,kv,s_k,d]``, q
positions aligned to the end of k, fully-masked K tiles skipped, online
softmax in fp32, the output plus the fp32 logsumexp ``[b,h,s_q]``. The
CUDA source is ``csrc/flash_attention.cu``, whose header says what bounds
it and what its design does about that.

The knobs are launch parameters: ``block_q`` is the q tile of one CTA and
``block_k`` the k tile of its inner loop. Both tiles live in shared memory
as fp32, so the limit is the H100's 227 KB a block at the widest head the
kernel takes (d = 128). Unlike the TPU kernel, s_q and s_k need not divide
into blocks: the kernel masks its ragged edge.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..core import Constraint, DispatchSpec, ParamSpace, PowerOfTwoParam, tunable
from ..core.platform import H100_SXM
from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30        # as the TPU kernel: no nan from (-inf) - (-inf)
FLASH_WARPS = 4
MAX_HEAD_DIM = 128


def smem_bytes(c, d: int = MAX_HEAD_DIM) -> int:
    """Shared memory of one CTA (mirrors repro_flash_smem_bytes)."""
    bq, bk = c["block_q"], c["block_k"]
    return (2 * bq * d + 2 * bk * (d + 1) + FLASH_WARPS * bk + 2 * bq) * 4


ATTENTION_SPACE = ParamSpace(
    [
        PowerOfTwoParam("block_q", 16, 128),
        PowerOfTwoParam("block_k", 32, 256),
    ],
    [
        Constraint(lambda c: smem_bytes(c) <= H100_SXM.smem_per_block,
                   "q, o, k and v tiles exceed 227 KB of shared memory at d=128"),
    ],
)


def _attn_heuristic(q, k, v):
    """32-row q tiles (16 for the shortest prompts) and 128-key k tiles:
    twice the CTAs of 64-row tiles, each warp with fewer rows in turn
    (about half the time of 64x64 tiles at s=256 on an H100 SXM,
    chip_smoke.py)."""
    return {"block_q": 16 if q.shape[2] <= 16 else 32, "block_k": 128}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None):
    """The kernel's function in plain PyTorch: (out, lse) with -1e30 masking."""
    b, h, s_q, d = q.shape
    kv, s_k = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kr = k.float().repeat_interleave(h // kv, dim=1)
    vr = v.float().repeat_interleave(h // kv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if causal or window > 0:
        q_idx = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
        k_idx = torch.arange(s_k, device=q.device)[None, :]
        mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_idx >= k_idx
        if window > 0:
            mask &= (q_idx - k_idx) < window
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr) / denom[..., None]
    return out.to(q.dtype), m[..., 0] + torch.log(denom)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [b,h,s,d], k/v [b,kv,s,d]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"mismatched q {tuple(q.shape)} and k {tuple(k.shape)}")


def flash_attention_cuda(q, k, v, *, block_q: int, block_k: int, causal: bool = True,
                         window: int = 0, scale: Optional[float] = None):
    """Launch csrc/flash_attention.cu on CUDA tensors: (out, lse)."""
    _check(q, k, v)
    b, h, s_q, d = q.shape
    kvh, s_k = k.shape[1], k.shape[2]
    if d < 16 or d > MAX_HEAD_DIM or d & (d - 1):
        raise ValueError(f"head_dim must be a power of two in [16, 128], got {d}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes matching f32 or bf16 q/k/v, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q, k, v only")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention", "repro_flash_attention",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             b, h, kvh, s_q, s_k, d, float(scale), int(bool(causal)), int(window),
             _DTYPES[q.dtype], block_q, block_k, _build.stream_ptr(q.device))
    _build.check("flash_attention", err, f"flash_attention q{tuple(q.shape)} k{tuple(k.shape)} "
                           f"block_q={block_q} block_k={block_k}")
    _build.LAUNCHES["flash_attention"] += 1
    return out, lse


@tunable(
    "flash_attention",
    space=ATTENTION_SPACE,
    reference=functools.partial(ref.attention_res, causal=True),
    heuristic=_attn_heuristic,
    dispatch=DispatchSpec(
        reference=ref.attention,
        # Same shapes, different masking semantics => distinct db records.
        key_extra=lambda kw: f"c{kw.get('causal', True)}w{kw.get('window', 0)}",
        data_parallel_args=(0, 1, 2),
        residuals=1,
    ),
)
def flash_attention(q, k, v, *, block_q: int, block_k: int, causal: bool = True,
                    window: int = 0, scale: Optional[float] = None):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, block_q=block_q, block_k=block_k,
                                    causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    raise RuntimeError(f"flash_attention has no kernel for device {q.device}")
