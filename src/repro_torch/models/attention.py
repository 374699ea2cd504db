"""Attention layers: GQA with RoPE and QKV bias, full or sliding window, KV
caches.

Two paths, same math, as in ``repro.models.attention``:
  * ``dispatch("flash_attention")`` — the CUDA kernel through the runtime
    (its plain version on CPU tensors), taken by prefill in kernel mode;
  * :func:`chunked_attention` — plain PyTorch online softmax over K/V
    chunks: the reference-mode prefill and the decode path (decode is plain
    tensor code in the JAX package too, not a kernel).

Cache layout is the JAX package's: ``[b, clen, kv, hd]`` per layer; full
attention writes row ``pos``, window layers write ``pos % window``. Decode
writes the new row into the cache tensor in place (the pool is allocated
once; copying it per token would move the whole cache every step).

On a tensor axis of several ranks each rank computes the heads of its
``tensor_parallel.head_plan``, read from its q and k weights' cuts: q, k
and v column-parallel from one entry of the layer's input into the model
region, a projection whose cut splits a head gathered whole by
``sharding.constrain_heads`` before the head split, the kv heads its
queries read taken from whole k and v (which then enter the model region
themselves: each rank's queries give part of their gradient), and ``o``
row-parallel. Its cache holds the kv heads its attention takes.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core import runtime as rt
from ..distributed import sharding as shd
from ..distributed import tensor_parallel as tp
from .layers import Axes, Params, apply_rope, dense, dense_axes, dense_init

NEG_INF = -1e30


def attention_init(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype, device, qkv_bias: bool = False) -> Params:
    return {
        "q": dense_init(gen, d_model, n_heads * head_dim, dtype, device, qkv_bias),
        "k": dense_init(gen, d_model, n_kv * head_dim, dtype, device, qkv_bias),
        "v": dense_init(gen, d_model, n_kv * head_dim, dtype, device, qkv_bias),
        "o": dense_init(gen, n_heads * head_dim, d_model, dtype, device),
    }


def attention_axes(qkv_bias: bool = False) -> Axes:
    return {"q": dense_axes("d_model", "heads", qkv_bias),
            "k": dense_axes("d_model", "kv_heads", qkv_bias),
            "v": dense_axes("d_model", "kv_heads", qkv_bias),
            "o": dense_axes("heads", "d_model")}


# repro: allow-raw(this IS the attn_chunks tunable body — the plain torch flash-equivalent reference; its q/k chunk sizes are the registry knobs)
def chunked_attention(
    q: torch.Tensor,        # [b, h, s_q, d]
    k: torch.Tensor,        # [b, kv, s_k, d]
    v: torch.Tensor,        # [b, kv, s_k, d]
    *,
    causal: bool,
    window: int = 0,
    scale: Optional[float] = None,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    kv_valid_len: Optional[torch.Tensor] = None,  # scalar or [b]: mask k >= this
) -> torch.Tensor:
    b, h, s_q, d = q.shape
    kv, s_k = k.shape[1], k.shape[2]
    group = h // kv
    scale = scale if scale is not None else d ** -0.5
    q_chunk, k_chunk = min(q_chunk, s_q), min(k_chunk, s_k)
    pq, pk = (-s_q) % q_chunk, (-s_k) % k_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, pk))
    sq_p, sk_p = q.shape[2], k.shape[2]
    q_off = s_k - s_q       # q occupies the end of the k axis
    dev = q.device
    qg = q.reshape(b, kv, group, sq_p, d)
    vl = None if kv_valid_len is None else torch.as_tensor(kv_valid_len, device=dev)
    outs = []
    for qi in range(sq_p // q_chunk):
        qc = qg[:, :, :, qi * q_chunk:(qi + 1) * q_chunk].float()
        q_ids = qi * q_chunk + torch.arange(q_chunk, device=dev) + q_off
        m = torch.full((b, kv, group, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kv, group, q_chunk), device=dev)
        acc = torch.zeros((b, kv, group, q_chunk, d), device=dev)
        for ki in range(sk_p // k_chunk):
            kc = k[:, :, ki * k_chunk:(ki + 1) * k_chunk].float()
            vc = v[:, :, ki * k_chunk:(ki + 1) * k_chunk].float()
            s = torch.einsum("bkgqd,bkcd->bkgqc", qc, kc) * scale
            k_ids = ki * k_chunk + torch.arange(k_chunk, device=dev)
            mask = (k_ids < s_k)[None, :].expand(q_chunk, k_chunk)
            if causal:
                mask = mask & (q_ids[:, None] >= k_ids[None, :])
            if window > 0:
                mask = mask & ((q_ids[:, None] - k_ids[None, :]) < window)
            full = mask[None, None, None]
            if vl is not None:
                if vl.dim() == 0:
                    full = full & (k_ids[None, :] < vl)[None, None, None]
                else:
                    # per-sequence valid length: each slot at its own position
                    full = full & (k_ids[None, :] < vl[:, None])[:, None, None, None, :]
            s = torch.where(full, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, vc)
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.cat(outs, dim=3).reshape(b, h, sq_p, d)[:, :, :s_q]
    return out.to(q.dtype)


def _attend(q, k, v, *, causal, window, use_kernel, kv_valid_len=None,
            q_chunk=512, k_chunk=1024):
    plain = functools.partial(chunked_attention, q_chunk=q_chunk, k_chunk=k_chunk)
    if use_kernel and rt.current_runtime().kernel_mode_active and kv_valid_len is None:
        # where flash takes the reference tier (a quarantined bucket), this
        # site computes what reference mode computes here
        return rt.dispatch("flash_attention", q, k, v, causal=causal, window=window,
                           reference=plain)
    return plain(q, k, v, causal=causal, window=window, kv_valid_len=kv_valid_len)


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _rank_qkv(p: Params, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int):
    """(q, k, v) as [b, s, heads, hd] of the heads this rank computes, and
    its head plan (all heads on one rank)."""
    plan = tp.attention_plan(p, n_heads, n_kv)
    xc = tp.copy_to_model(x) if plan.q_sharded else x
    q = dense(p["q"], xc)
    q = shd.constrain_heads(q, n_heads, -1, full=n_heads * head_dim)
    kv = []
    for name in ("k", "v"):
        t = dense(p[name], xc if plan.kv_sharded else x)
        t = shd.constrain_heads(t, n_kv, -1, full=n_kv * head_dim)
        if plan.kv_pick is not None:
            # whole k/v, of which the rank's queries read some heads
            t = _split_heads(tp.copy_to_model(t), n_kv, head_dim)
            idx = torch.tensor(plan.kv_pick, dtype=torch.long, device=t.device)
            t = t.index_select(2, idx).reshape(t.shape[0], t.shape[1], -1)
        kv.append(t)
    return (_split_heads(q, plan.q_n, head_dim), _split_heads(kv[0], plan.kv_n, head_dim),
            _split_heads(kv[1], plan.kv_n, head_dim), plan)


def _rank_out(p: Params, y: torch.Tensor, plan) -> torch.Tensor:
    """``o`` over the attention output [b, s, q heads * hd]: row-parallel on
    a cut ``o``, on the rank's slice of a whole output where the cut split a
    head."""
    if plan.o_slice:
        y = tp.scatter_to_model(y, -1)
    return dense(p["o"], y)


def attention_forward(
    p: Params,
    x: torch.Tensor,            # [b, s, d_model]
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    window: int = 0,
    positions: Optional[torch.Tensor] = None,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    return_cache: bool = False,
    cache_len: Optional[int] = None,
    true_len: Optional[int] = None,    # prefill: real prompt length (s may be right-padded)
):
    """Prefill forward. Returns y or (y, cache).

    ``true_len`` supports bucketed (right-padded) prefill: causality keeps
    pads out of real positions, and window caches are filled ring-aligned
    from real positions so decode continues at position ``true_len``.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v, plan = _rank_qkv(p, x, n_heads, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    y = _attend(qh, kh, vh, causal=True, window=window, use_kernel=True,
                q_chunk=q_chunk, k_chunk=k_chunk)
    out = _rank_out(p, y.transpose(1, 2).reshape(b, s, plan.q_n * head_dim), plan)
    if not return_cache:
        return out
    clen = cache_len or s
    if window > 0:
        clen = min(clen, window)
        if true_len is not None:
            # slot j holds the largest real position p < true_len with
            # p % clen == j; slots for p < 0 are zeroed
            last = int(true_len) - 1
            j = torch.arange(clen, device=x.device)
            pidx = last - torch.remainder(last - j, clen)
            ok = (pidx >= 0)[None, :, None, None]
            pc = pidx.clamp(0, s - 1)
            zero = torch.zeros((), dtype=k.dtype, device=x.device)
            return out, {"k": torch.where(ok, k[:, pc], zero),
                         "v": torch.where(ok, v[:, pc], zero)}
        if s >= clen:
            k_tail = torch.roll(k[:, -clen:], s % clen, dims=1)
            v_tail = torch.roll(v[:, -clen:], s % clen, dims=1)
        else:
            k_tail = F.pad(k, (0, 0, 0, 0, 0, clen - s))
            v_tail = F.pad(v, (0, 0, 0, 0, 0, clen - s))
        return out, {"k": k_tail, "v": v_tail}
    pad = clen - s
    return out, {"k": F.pad(k, (0, 0, 0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, 0, 0, pad))}


def attention_cache_shape(batch: int, cache_len: int, n_kv: int, head_dim: int,
                          window: int):
    """One layer's cache: ``n_kv`` is the kv heads the rank's attention
    takes (``HeadPlan.kv_n``; all of them on one rank)."""
    clen = min(cache_len, window) if window > 0 else cache_len
    return (batch, clen, n_kv, head_dim)


def attention_decode(
    p: Params,
    x: torch.Tensor,                # [b, 1, d_model]
    cache: Dict[str, torch.Tensor],
    pos: torch.Tensor,              # int scalar or [b]: absolute position per row
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    window: int = 0,
    k_chunk: int = 1024,
):
    """One-token decode against a cache, written in place. Returns (y, cache).

    ``pos`` may be a vector: in the slot-pool engine every cache row is an
    independent sequence at its own position, so RoPE, the write slot and
    the validity mask are per row.
    """
    b = x.shape[0]
    q, k, v, plan = _rank_qkv(p, x, n_heads, n_kv, head_dim)
    n_heads, n_kv = plan.q_n, plan.kv_n
    posv = torch.as_tensor(pos, device=x.device).expand(b)
    q = apply_rope(q, posv[:, None], rope_theta)
    k = apply_rope(k, posv[:, None], rope_theta)

    ck, cv = cache["k"], cache["v"]
    clen = ck.shape[1]
    slot = torch.remainder(posv, clen) if window > 0 else posv
    rows = torch.arange(b, device=x.device)
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)

    qh = q.transpose(1, 2)
    kh, vh = ck.transpose(1, 2), cv.transpose(1, 2)
    # repro: allow-raw(single-token decode over the rolling window cache — [b,h,1,window] scores are cache-layout-bound, below any kernel tile floor)
    if window > 0:
        # rolling cache: every slot is within the window; mask unwritten ones
        valid = torch.arange(clen, device=x.device)[None, :] <= posv[:, None]
        s = torch.einsum(
            "bkgqd,bkcd->bkgqc",
            qh.reshape(b, n_kv, n_heads // n_kv, 1, head_dim).float(), kh.float(),
        ) * (head_dim ** -0.5)
        s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG_INF))
        y = torch.einsum("bkgqc,bkcd->bkgqd", torch.softmax(s, dim=-1), vh.float())
        y = y.reshape(b, n_heads, 1, head_dim).to(x.dtype)
    else:
        y = chunked_attention(qh, kh, vh, causal=False, k_chunk=k_chunk,
                              kv_valid_len=posv + 1)
    y = y.transpose(1, 2).reshape(b, 1, n_heads * head_dim)
    return _rank_out(p, y, plan), cache
