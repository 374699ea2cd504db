"""Shared layer primitives: init, dense, norm, SwiGLU FFN, RoPE, embeddings.

Parameters are plain dicts of tensors with the JAX package's names and
layouts: a dense weight is ``[d_in, d_out]`` (not ``nn.Linear``'s
``[out, in]``), so the matmul kernel and its database keys see the same
operands in both packages. Each ``*_init`` has an ``*_axes`` beside it:
the same tree with every leaf's *logical* dim names (``("d_model",
"ff")``), the names the JAX package's inits return and the sharding solver
(:mod:`repro_torch.distributed.sharding`) reads.

On a tensor axis of several ranks a leaf may be this rank's piece of the
global tensor, tagged by ``distributed.tensor_parallel.shard_params``; the
layers read the tag. A dense weight cut on its output dim runs
column-parallel: its input is the caller's, entered into the model region
once (``tensor_parallel.copy_to_model``) for every projection that shares
it, and its output is the rank's columns. One cut on its input dim runs
row-parallel: the rank's partial product, in fp32 (``matmul``'s
``out="float32"``), is summed over the ranks (``reduce_from_model``) and
rounded once, as one device's product is, before the bias. A table cut on its vocabulary rows
is looked up vocab-parallel; an unembed cut on its vocabulary columns gives
the rank's columns of the logits.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..core.runtime import dispatch, fusion_wins
from ..distributed import tensor_parallel as tp

Params = Dict[str, Any]
Axes = Dict[str, Any]


def _init(gen: torch.Generator, shape, dtype, device, scale: Optional[float] = None):
    """Normal init with the JAX package's scales (``layers._init``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0] if len(shape) > 1 else 1.0)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, bias: bool = False) -> Params:
    p: Params = {"w": _init(gen, (d_in, d_out), dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_axes(in_axis: str, out_axis: str, bias: bool = False) -> Axes:
    a: Axes = {"w": (in_axis, out_axis)}
    if bias:
        a["b"] = (out_axis,)
    return a


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b): the projection gemm goes through the ``matmul`` dispatch.
    A weight cut on its input dim (row-parallel) sums the ranks' partial
    products, then adds the bias; one cut on its output dim gives the
    rank's columns (its input entered by the caller)."""
    if tp.shard_dim(p["w"]) == 0:
        y = row_parallel(x, p["w"])
        return y + p["b"] if "b" in p else y
    if "b" in p and fusion_wins("matmul_bias_act", x, p["w"], p["b"]):
        return dispatch("matmul_bias_act", x, p["w"], p["b"])
    y = dispatch("matmul", x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for a weight cut on its input dim: the rank's partial product
    in fp32, summed over the tensor axis in fp32 and rounded once to x's
    dtype."""
    return tp.reduce_from_model(dispatch("matmul", x, w, out="float32")).to(x.dtype)


def norm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def norm_axes() -> Axes:
    return {"scale": ("d_model",)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return dispatch("rmsnorm", x, p["scale"], eps=eps)


def rmsnorm_dense(pn: Params, pd: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm(x) through a dense layer: the final-norm -> unembed pair
    (the rank's columns for a weight cut on its output dim)."""
    if tp.shard_dim(pd["w"]) == 1:
        x = tp.copy_to_model(x)
    if "b" not in pd and fusion_wins("rmsnorm_matmul", x, pn["scale"], pd["w"], eps=eps):
        return dispatch("rmsnorm_matmul", x, pn["scale"], pd["w"], eps=eps)
    return dense(pd, rmsnorm(pn, x, eps))


FFN_KINDS = ("swiglu", "geglu", "gelu", "relu2")


def ffn_init(gen, d: int, ff: int, kind: str, dtype, device) -> Params:
    if kind in ("swiglu", "geglu"):
        return {
            "wg": _init(gen, (d, ff), dtype, device),
            "wu": _init(gen, (d, ff), dtype, device),
            "wd": _init(gen, (ff, d), dtype, device, scale=1.0 / math.sqrt(ff)),
        }
    if kind in ("gelu", "relu2"):
        return {
            "wu": _init(gen, (d, ff), dtype, device),
            "wd": _init(gen, (ff, d), dtype, device, scale=1.0 / math.sqrt(ff)),
        }
    raise ValueError(f"unknown ffn kind {kind!r}")


def ffn_axes(kind: str) -> Axes:
    a = {"wu": ("d_model", "ff"), "wd": ("ff", "d_model")}
    if kind in ("swiglu", "geglu"):
        a["wg"] = ("d_model", "ff")
    return a


def _act_matmul(x: torch.Tensor, w: torch.Tensor, act: str) -> torch.Tensor:
    """act(x @ w): the fused ``matmul_bias_act`` dispatch (with a zero bias)
    where the database holds a record for this site, else the matmul
    dispatch followed by the activation (gelu in its tanh form)."""
    zb = torch.zeros((w.shape[-1],), dtype=x.dtype, device=x.device)
    if fusion_wins("matmul_bias_act", x, w, zb, act=act):
        return dispatch("matmul_bias_act", x, w, zb, act=act)
    y = dispatch("matmul", x, w)
    return F.silu(y) if act == "silu" else F.gelu(y, approximate="tanh")


def ffn_apply(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN; with its ff dim cut over the tensor axis, the up
    projections column-parallel and the down projection row-parallel."""
    if tp.shard_dim(p["wu"]) == 1:
        x = tp.copy_to_model(x)
    mm = lambda a, w: dispatch("matmul", a, w)
    if kind == "swiglu":
        h = _act_matmul(x, p["wg"], "silu") * mm(x, p["wu"])
    elif kind == "geglu":
        h = _act_matmul(x, p["wg"], "gelu") * mm(x, p["wu"])
    elif kind == "gelu":
        h = _act_matmul(x, p["wu"], "gelu")
    elif kind == "relu2":
        h = F.relu(mm(x, p["wu"]))
        h = h * h
    else:
        raise ValueError(kind)
    return row_parallel(h, p["wd"]) if tp.shard_dim(p["wd"]) == 0 else mm(h, p["wd"])


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE in fp32. x: [..., s, heads, hd]; positions: [s] or
    broadcastable (e.g. [b, 1])."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs       # [..., s, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def embedding_init(gen, vocab: int, d: int, dtype, device) -> Params:
    return {"table": _init(gen, (vocab, d), dtype, device, scale=1.0)}


def embedding_axes() -> Axes:
    return {"table": ("vocab", "d_model")}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows (``table[tokens]``), through ``F.embedding``, whose
    backward on the card sums a token's cotangents in fp32 and rounds once.
    Indexing's backward adds each repeat of a token into the bf16 gradient
    row one at a time, rounding each sum: a frequent token's row then
    depends on how many rows the batch holds, and one process and two
    data-parallel ranks part. A table cut on its vocabulary rows is looked
    up vocab-parallel (``tensor_parallel.vocab_parallel_embed``)."""
    if tp.shard_dim(p["table"]) == 0:
        return tp.vocab_parallel_embed(p["table"], tokens)
    return F.embedding(tokens, p["table"])


def unembed_init(gen, d: int, vocab: int, dtype, device) -> Params:
    return {"w": _init(gen, (d, vocab), dtype, device)}


def unembed_axes() -> Axes:
    return {"w": ("d_model", "vocab")}


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The logits, or the rank's vocabulary columns of them for a weight cut
    on its output dim (``x`` entered into the model region by the caller)."""
    return dispatch("matmul", x, p["w"])
