"""Flash attention (causal / sliding-window, GQA): the ``flash_attention``
tunable and its CUDA kernel.

Replaces the TPU kernel ``repro/kernels/attention.py:_flash_kernel``
(``flash_attention_pallas``): q ``[b,h,s_q,d]``, k/v ``[b,kv,s_k,d]``, q
positions aligned to the end of k, fully-masked K tiles skipped, online
softmax in fp32, the output plus the fp32 logsumexp ``[b,h,s_q]``. The
CUDA source is ``csrc/flash_attention.cu``, whose header says what bounds
it and what its design does about that.

bf16 runs on the tensor cores (``wgmma``, fed by TMA through a ring of
shared-memory stages on mbarriers; ``csrc/flash_common.cuh``), which only
``sm_90a`` has. fp32 runs the SIMT kernels under their own entry points,
chosen by dtype: ``wgmma`` has no fp32 operands, and TF32 would break the
fp32 card tests and gradient checks.

The knobs are the bf16 kernels' launch parameters. Forward: ``block_q``,
the q rows of one CTA (64 per consumer warpgroup), ``block_k``, the keys
of a streamed k/v tile, and ``stages``, the depth of the ring. Every
config of the space fits the H100's 227 KB of shared memory a block up to
d = 128 (:data:`SPACE_HEAD_DIM`); at d = 256 (PaliGemma's heads) only the
64-key tiles do, and the tunable's ``legal`` check (:func:`fwd_illegal`)
refuses the others for such a call, so the tuner prunes them before a
trial and no tier resolves to one. Unlike the TPU kernel, s_q and s_k need
not divide into blocks: the tensor maps read zeros past the edge and the
kernel masks it. The fp32 SIMT route runs its own tiles whatever the
config (:func:`simt_tiles`: 64 x 64, 32 x 32 at d = 256).

Its backward plan dispatches ``flash_attention_bwd`` (``csrc/
flash_attention_bwd.cu``, replacing ``repro/kernels/attention.py:
_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``): dq, dk and dv from the
forward's saved output and lse, in two passes with no atomics, the dk/dv
pass summing each kv head's group of q heads inside the CTA.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..core import Constraint, DispatchSpec, ParamSpace, PowerOfTwoParam, tunable
from ..core.params import EnumParam
from ..core.platform import H100_SXM
from . import _build, ref

_NEG_INF = -1e30        # as the TPU kernel: no nan from (-inf) - (-inf)
FLASH_WARPS = 4         # warps of a SIMT CTA
HEAD_DIMS = (16, 32, 64, 128, 256)
# The widest head at which every config of the two spaces fits one block;
# above it the legality checks prune the configs that do not.
SPACE_HEAD_DIM = 128
SMEM = H100_SXM.smem_per_block


def simt_tiles(d: int) -> dict:
    """The fp32 SIMT kernels' tiles at head dim ``d``, whatever the config:
    the largest square tile whose forward and both backward CTAs fit one
    block (tests/test_torch_flash_space.py): 64 x 64 up to d = 128, 32 x 32
    at d = 256 (64 x 64 would need 258 KB)."""
    t = 64 if d <= SPACE_HEAD_DIM else 32
    return {"block_q": t, "block_k": t}


def smem_bytes(c, d: int) -> int:
    """Shared memory of one bf16 forward CTA (mirrors ``Fwd::SMEM`` in
    csrc/flash_attention.cu): the q tile, ``stages`` k and v tiles, 2 *
    stages + 1 barriers and 1024 bytes to align the tiles for the 128-byte
    swizzle."""
    bq, bk, st = c["block_q"], c["block_k"], c["stages"]
    return 1024 + bq * d * 2 + 2 * st * bk * d * 2 + 8 * (2 * st + 1)


def simt_smem_bytes(c, d: int) -> int:
    """Shared memory of one fp32 SIMT forward CTA (mirrors
    repro_flash_simt_smem_bytes)."""
    bq, bk = c["block_q"], c["block_k"]
    return (2 * bq * d + 2 * bk * (d + 1) + FLASH_WARPS * bk + 2 * bq) * 4


ATTENTION_SPACE = ParamSpace(
    [
        PowerOfTwoParam("block_q", 64, 128),
        PowerOfTwoParam("block_k", 64, 128),
        EnumParam("stages", (2, 3)),
    ],
    [
        Constraint(lambda c: smem_bytes(c, SPACE_HEAD_DIM) <= SMEM,
                   "bf16 q tile, k/v ring and barriers exceed 227 KB of shared memory at d=128"),
    ],
)


def fwd_illegal(c, q, k, v) -> Optional[str]:
    """Why the bf16 forward cannot run config ``c`` at this call's head dim
    (its CTA past 227 KB: at d = 256 every 128-key tile, and 128 x 64 with
    three stages), or None. fp32 runs :func:`simt_tiles`, so every config
    is legal there."""
    d = q.shape[-1]
    if q.dtype != torch.float32 and smem_bytes(c, d) > SMEM:
        return f"bf16 forward tiles {c} need {smem_bytes(c, d)} B of shared memory at d={d}"
    return None


def _attn_heuristic(q, k, v):
    """64-row q tiles and 64-key tiles in a ring of two stages: one consumer
    warpgroup a CTA, whose small shared memory (at most 83 KB at d = 128)
    lets two or more CTAs share an SM, so one CTA's softmax overlaps
    another's products. It beat 128 x 64 tiles with three stages at every
    main-path shape (Jamba's s = 2048: 0.1861 against 0.2226 ms; Mixtral's
    windowed s = 8192: 0.9145 against 1.0376; chip_smoke.py, H100 SXM)."""
    return {"block_q": 64, "block_k": 64, "stages": 2}


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


def _check_cuda(ts, what: str) -> None:
    dtype = ts[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != dtype for t in ts):
        raise TypeError(f"{what} kernel takes matching f32 or bf16 tensors, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} kernel takes contiguous tensors only")
    if not all(t.device == ts[0].device for t in ts):
        raise ValueError(f"{what} tensors on different devices")
    if dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what} kernel's tensor maps need 16-byte aligned tensors")


def _check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {d}")


def flash_attention_cuda(q, k, v, *, block_q: int, block_k: int, stages: int = 2,
                         causal: bool = True, window: int = 0, scale: Optional[float] = None):
    """Launch csrc/flash_attention.cu on CUDA tensors: (out, lse). bf16 runs
    the tensor-core kernel at the config's tiles (a config not legal at the
    head dim raises); fp32 the SIMT kernel at :func:`simt_tiles`, chosen by
    dtype (never on a failure)."""
    _check(q, k, v)
    _check_cuda((q, k, v), "flash")
    b, h, s_q, d = q.shape
    kvh, s_k = k.shape[1], k.shape[2]
    _check_head_dim(d)
    scale = scale if scale is not None else d ** -0.5
    cfg = {"block_q": block_q, "block_k": block_k, "stages": stages}
    why = ATTENTION_SPACE.why_invalid(cfg) or fwd_illegal(cfg, q, k, v)
    if why:
        raise ValueError(f"flash config {cfg} is not legal at d={d}: {why}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    dims = (b, h, kvh, s_q, s_k, d, float(scale), int(bool(causal)), int(window))
    head = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
    if q.dtype == torch.bfloat16:
        fn = _build.entry("flash_attention", "repro_flash_attention",
                          head + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        err = fn(*ptrs, *dims, block_q, block_k, stages, _build.stream_ptr(q.device))
    else:
        cfg = simt_tiles(d)
        fn = _build.entry("flash_attention", "repro_flash_attention_f32",
                          head + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        err = fn(*ptrs, *dims, cfg["block_q"], cfg["block_k"], _build.stream_ptr(q.device))
    _build.check("flash_attention", err, f"flash_attention {q.dtype} q{tuple(q.shape)} "
                 f"k{tuple(k.shape)} {cfg}")
    _build.LAUNCHES["flash_attention"] += 1
    return out, lse


def _attn_key_extra(kw) -> str:
    """Same shapes, different masking semantics => distinct db records."""
    return f"c{kw.get('causal', True)}w{kw.get('window', 0)}"


def _flash_bwd_plan(ct, q, k, v, o, lse, **kwargs):
    """Backward plan: one ``flash_attention_bwd`` dispatch site (dq, dk, dv
    together), handed the forward's output and lse: no recompute pass."""
    from ..core.runtime import dispatch

    return dispatch("flash_attention_bwd", ct, q, k, v, o, lse, **kwargs)


@tunable(
    "flash_attention",
    space=ATTENTION_SPACE,
    reference=functools.partial(ref.attention_res, causal=True),
    heuristic=_attn_heuristic,
    legal=fwd_illegal,
    dispatch=DispatchSpec(
        reference=ref.attention,
        key_extra=_attn_key_extra,
        data_parallel_args=(0, 1, 2),
        vjp="dispatch",
        bwd=_flash_bwd_plan,
        residuals=1,
    ),
)
def flash_attention(q, k, v, *, block_q: int, block_k: int, stages: int = 2,
                    causal: bool = True, window: int = 0, scale: Optional[float] = None):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, block_q=block_q, block_k=block_k, stages=stages,
                                    causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    raise _build.KernelUnavailable(f"flash_attention has no kernel for device {q.device}")


# ---------------------------------------------------------------------------
# Backward: dq, dk, dv from the saved (o, lse)
# ---------------------------------------------------------------------------


BWD_TILE = 64        # rows of a streamed tile: k in the dq pass, q in the dk/dv pass
BWD_STAGES = 2       # depth of the backward's ring


def bwd_smem_bytes(c, d: int) -> int:
    """Shared memory of the larger of the two bf16 backward CTAs (mirrors
    ``BwdDq::SMEM`` and ``BwdDkv::SMEM`` in csrc/flash_attention_bwd.cu):
    the dq pass holds q and do tiles of ``block_q`` rows and a ring of
    64-key k and v tiles; the dk/dv pass k and v tiles of ``block_k`` keys
    and a ring of 64-row q and do tiles, each with 64 lse and delta values."""
    fixed, tile = 1024 + 8 * (1 + 2 * BWD_STAGES), BWD_TILE * d * 2
    dq = fixed + 2 * c["block_q"] * d * 2 + 2 * BWD_STAGES * tile
    dkv = fixed + 2 * c["block_k"] * d * 2 + BWD_STAGES * (2 * tile + 512)
    return max(dq, dkv)


def simt_bwd_smem_bytes(c, d: int) -> int:
    """Shared memory of the larger of the two fp32 SIMT backward CTAs
    (mirrors repro_flash_bwd_dq_simt_smem_bytes and
    repro_flash_bwd_dkv_simt_smem_bytes)."""
    bq, bk = c["block_q"], c["block_k"]
    dq = 3 * bq * (d + 1) + 2 * bk * (d + 1) + FLASH_WARPS * bk
    dkv = 4 * bk * (d + 1) + 2 * bq * (d + 1) + 2 * bq + 2 * FLASH_WARPS * bq
    return max(dq, dkv) * 4


# block_q is the dq pass's q tile (64 rows per consumer warpgroup), block_k
# the dk/dv pass's k tile (64 keys per consumer warpgroup); each pass
# streams the other operand in 64-row tiles, which bounds the registers of
# its accumulators (dq, or dk and dv) at d = 128; at d = 256 the dk/dv pass
# takes half of the columns a CTA (csrc/flash_attention_bwd.cu).
ATTENTION_BWD_SPACE = ParamSpace(
    [
        PowerOfTwoParam("block_q", 64, 128),
        PowerOfTwoParam("block_k", 64, 128),
    ],
    [
        Constraint(lambda c: bwd_smem_bytes(c, SPACE_HEAD_DIM) <= SMEM,
                   "bf16 backward tiles, rings and barriers exceed 227 KB of shared memory "
                   "at d=128"),
    ],
)


def bwd_illegal(c, ct, q, k, v, o, lse) -> Optional[str]:
    """Why the bf16 backward cannot run config ``c`` at this call's head
    dim (either pass's CTA past 227 KB: at d = 256 all but 64 x 64), or
    None; fp32 runs :func:`simt_tiles`."""
    d = q.shape[-1]
    if q.dtype != torch.float32 and bwd_smem_bytes(c, d) > SMEM:
        return f"bf16 backward tiles {c} need {bwd_smem_bytes(c, d)} B of shared memory at d={d}"
    return None


def _attn_bwd_heuristic(ct, q, k, v, o, lse):
    """64-row q tiles in the dq pass (Jamba's widths: 0.9220 against 0.9498
    ms with 128; chip_smoke.py, H100 SXM); in the dk/dv pass 128-key tiles
    up to d = 64 and 64-key tiles above, where the dk and dv accumulators of
    two warpgroups exceed the registers of a 288-thread CTA (168 a thread):
    ptxas spills them and serializes the wgmmas (chip_smoke.py's build
    report). At d = 256, 64 x 64 is the one config that fits."""
    return {"block_q": 64, "block_k": 128 if q.shape[-1] <= 64 else 64}


def flash_attention_bwd_plain(ct, q, k, v, o, lse, *, causal: bool = True, window: int = 0,
                              scale: Optional[float] = None):
    """The backward kernel's function in plain PyTorch: (dq, dk, dv) from the
    saved (o, lse), masked scores at -1e30, GQA group-summed."""
    b, h, s_q, d = q.shape
    kv, s_k = k.shape[1], k.shape[2]
    group = h // kv
    scale = scale if scale is not None else d ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), ct.float()
    kr = kf.repeat_interleave(group, dim=1)
    vr = vf.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    if causal or window > 0:
        q_idx = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
        k_idx = torch.arange(s_k, device=q.device)[None, :]
        mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_idx >= k_idx
        if window > 0:
            mask &= (q_idx - k_idx) < window
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse.float()[..., None])
    delta = (dof * o.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, kv, group, s_k, d).sum(2)
    dv = dv.reshape(b, kv, group, s_k, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_cuda(ct, q, k, v, o, lse, *, block_q: int, block_k: int,
                             causal: bool = True, window: int = 0,
                             scale: Optional[float] = None):
    """Launch csrc/flash_attention_bwd.cu on CUDA tensors: (dq, dk, dv). bf16
    runs the tensor-core passes at the config's tiles (a config not legal at
    the head dim raises); fp32 the SIMT passes at :func:`simt_tiles`,
    chosen by dtype. delta = rowsum(do * o) is one
    fp32 torch reduction here, as it is a jnp reduction outside the Pallas
    kernels."""
    _check(q, k, v)
    b, h, s_q, d = q.shape
    kvh, s_k = k.shape[1], k.shape[2]
    if ct.shape != q.shape or o.shape != q.shape or lse.shape != (b, h, s_q):
        raise ValueError(f"flash_attention_bwd takes ct and o like q {tuple(q.shape)} and lse "
                         f"[b,h,s_q]; got {tuple(ct.shape)}, {tuple(o.shape)}, {tuple(lse.shape)}")
    _check_cuda((ct, q, k, v), "flash bwd")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError(f"flash bwd kernel takes a contiguous fp32 lse, got {lse.dtype}")
    if not all(t.device == q.device for t in (o, lse)):
        raise ValueError("flash bwd tensors on different devices")
    _check_head_dim(d)
    scale = scale if scale is not None else d ** -0.5
    cfg = {"block_q": block_q, "block_k": block_k}
    why = ATTENTION_BWD_SPACE.why_invalid(cfg) or bwd_illegal(cfg, ct, q, k, v, o, lse)
    if why:
        raise ValueError(f"flash bwd config {cfg} is not legal at d={d}: {why}")
    delta = (ct.float() * o.float()).sum(-1)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.dtype == torch.bfloat16:
        symbol = "repro_flash_attention_bwd"
    else:
        cfg = simt_tiles(d)
        symbol = "repro_flash_attention_bwd_f32"
    fn = _build.entry("flash_attention_bwd", symbol,
                      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float]
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ct.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, h, kvh, s_q, s_k, d, float(scale), int(bool(causal)), int(window),
             cfg["block_q"], cfg["block_k"], _build.stream_ptr(q.device))
    _build.check("flash_attention_bwd", err,
                 f"flash_attention_bwd {q.dtype} q{tuple(q.shape)} k{tuple(k.shape)} {cfg}")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


@tunable(
    "flash_attention_bwd",
    space=ATTENTION_BWD_SPACE,
    reference=ref.attention_bwd,
    heuristic=_attn_bwd_heuristic,
    legal=bwd_illegal,
    dispatch=DispatchSpec(
        key_extra=_attn_key_extra,
        # ct, q, k, v, o, lse all lead with the batch dim.
        data_parallel_args=(0, 1, 2, 3, 4, 5),
        # vjp="reference": grad-of-grad differentiates through this site.
        vjp="reference",
    ),
)
def flash_attention_bwd(ct, q, k, v, o, lse, *, block_q: int, block_k: int,
                        causal: bool = True, window: int = 0, scale: Optional[float] = None):
    if q.is_cuda:
        return flash_attention_bwd_cuda(ct, q, k, v, o, lse, block_q=block_q, block_k=block_k,
                                        causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_bwd_plain(ct, q, k, v, o, lse, causal=causal, window=window,
                                         scale=scale)
    raise _build.KernelUnavailable(f"flash_attention_bwd has no kernel for device {q.device}")
