"""Mixture-of-Experts: top-k routing with capacity, scatter-based dispatch.
The port of ``repro.models.moe``.

Two dispatch modes, as in the JAX package:

  * ``scatter`` (default, the serving and training path): tokens are placed
    into a dense ``[experts, capacity, d]`` buffer, the experts run three
    grouped ``expert_gemm`` dispatches, and the results gather back. Work
    scales with tokens x top_k, never with tokens x experts.
  * ``dense`` (oracle): every expert runs every token and combine weights
    zero out the experts a token did not choose.

Capacity decides which tokens are dropped, so the order is the reference's
bit for bit: the (token, choice) pairs are flattened token-major, each
expert's running count is a cumsum over that order, and a pair past its
expert's capacity is dropped (the later one in the flat order loses).
``top_k`` breaks ties by the lower expert index, as ``jax.lax.top_k``
does. Capacity comes from the token count of the call, so in one batch the
rows share it: a decode pool's free slots route and take capacity too.

The router projection and softmax stay plain torch: ``[n, d] @ [d, e]``
with e a handful of experts is no kernel site.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.runtime import dispatch as rt_dispatch
from .layers import Axes, Params, _init

DISPATCH_MODES = ("scatter", "dense")


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Expert buffer depth for the scatter path, from the call's token
    count (truncated, as the JAX package's ``int``). The planner keys
    ``expert_gemm`` jobs on it."""
    return int(max(top_k, capacity_factor * n_tokens * top_k / n_experts))


def _valid_mask(true_len, b: int, s: int, device) -> Optional[torch.Tensor]:
    """[b, s] bool validity mask from a scalar or per-row ``true_len``."""
    if true_len is None:
        return None
    tl = torch.as_tensor(true_len, device=device)
    if tl.dim() == 0:
        tl = tl.expand(b)
    return torch.arange(s, device=device)[None, :] < tl[:, None]


def moe_init(gen, d: int, ff: int, n_experts: int, dtype, device,
             ffn_kind: str = "swiglu") -> Params:
    """The router (fp32, scale 0.02) and the stacked expert weights, with the
    JAX package's init scales (``_init``'s default, 1/sqrt of the leading
    dim, which for an expert stack is the expert count)."""
    p: Params = {
        "router": _init(gen, (d, n_experts), torch.float32, device, scale=0.02),
        "wg": _init(gen, (n_experts, d, ff), dtype, device),
        "wu": _init(gen, (n_experts, d, ff), dtype, device),
        "wd": _init(gen, (n_experts, ff, d), dtype, device),
    }
    if ffn_kind in ("gelu", "relu2"):
        del p["wg"]
    return p


def moe_axes(ffn_kind: str = "swiglu") -> Axes:
    """The router stays replicated (``experts_r`` is no rule of the solver)."""
    a: Axes = {"router": ("d_model", "experts_r"), "wu": ("experts", "d_model", "ff"),
               "wd": ("experts", "ff", "d_model")}
    if ffn_kind not in ("gelu", "relu2"):
        a["wg"] = ("experts", "d_model", "ff")
    return a


def _expert_ffn(p: Params, x: torch.Tensor, ffn_kind: str) -> torch.Tensor:
    """x: [e, c, d] -> [e, c, d], grouped over the expert dim: three (two
    without a gate) ``expert_gemm`` dispatch sites. As in the JAX package,
    the gated kinds take silu (swiglu) or tanh-form gelu, and the ungated
    ones gelu (relu2 included)."""
    eg = lambda a, w: rt_dispatch("expert_gemm", a, w)
    if "wg" in p:
        g = eg(x, p["wg"])
        g = F.silu(g) if ffn_kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * eg(x, p["wu"])
    else:
        h = F.gelu(eg(x, p["wu"]), approximate="tanh")
    return eg(h, p["wd"])


def _top_k(probs: torch.Tensor, k: int):
    """(values, ids) of the k largest, ties to the lower index: a stable
    descending sort (``torch.topk`` promises no order among ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def _route(router_w, x2, top_k: int, valid: Optional[torch.Tensor] = None):
    """x2: [n, d] -> (weights [n, k] fp32, ids [n, k], aux_loss).

    ``valid`` ([n] bool, optional) marks real tokens: pad tokens get zero
    combine weight and are left out of both factors of the load-balancing
    loss."""
    # repro: allow-raw(router projection is [n, d] @ [d, e] with e a handful of experts — below the tuned-gemm tile floor)
    logits = x2.float() @ router_w                        # [n, e]
    probs = torch.softmax(logits, dim=-1)  # repro: allow-raw(router softmax over e experts — the fused kernel tiles vocab-scale axes, not e)
    weights, ids = _top_k(probs, top_k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balancing auxiliary loss on the top-1 choice.
    n, e = probs.shape
    one_hot = F.one_hot(ids[:, 0], e).float()
    if valid is None:
        me = probs.mean(0)                                # mean prob per expert
        ce = one_hot.mean(0)                              # fraction routed (top-1)
    else:
        vf = valid.float()[:, None]
        denom = vf.sum().clamp_min(1.0)
        me = (probs * vf).sum(0) / denom
        ce = (one_hot * vf).sum(0) / denom
        weights = weights * vf
    aux = e * (me * ce).sum()
    return weights, ids, aux


def moe_apply(
    p: Params,
    x: torch.Tensor,                  # [b, s, d]
    *,
    top_k: int,
    ffn_kind: str = "swiglu",
    capacity_factor: float = 1.25,
    dispatch: str = "scatter",
    true_len=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [b, s, d], aux_loss scalar).

    ``true_len`` (scalar or [b] int, optional): real tokens per row. Pad
    tokens past it route nowhere: they take no expert capacity, add nothing
    to the aux loss and give zero output.
    """
    if dispatch == "scatter_hinted":
        raise NotImplementedError("moe_dispatch='scatter_hinted' only adds sharding hints; "
                                  "it comes with the distributed slice")
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"moe dispatch {dispatch!r} not in {DISPATCH_MODES}")
    b, s, d = x.shape
    n = b * s
    x2 = x.reshape(n, d)
    e = p["wu"].shape[0]
    mask = _valid_mask(true_len, b, s, x.device)
    valid = None if mask is None else mask.reshape(n)
    weights, ids, aux = _route(p["router"], x2, top_k, valid=valid)

    if dispatch == "dense":
        outs = _expert_ffn(p, x2[None].expand(e, n, d), ffn_kind)    # [e, n, d]
        combine = torch.zeros((n, e), dtype=torch.float32, device=x.device)
        combine.scatter_add_(1, ids, weights)
        # repro: allow-raw(dense oracle path — correctness baseline for the scatter dispatch, never the serving path)
        y = torch.einsum("ne,end->nd", combine, outs.float())
        return y.reshape(b, s, d).to(x.dtype), aux

    cap = expert_capacity(n, e, top_k, capacity_factor)
    # position of each (token, choice) in its expert's buffer: token-major
    flat_ids = ids.reshape(-1)                                        # [n*k]
    onehot = F.one_hot(flat_ids, e)                                   # [n*k, e]
    if valid is not None:
        # pad pairs add no occupancy, so later real tokens keep capacity
        flat_valid = valid.repeat_interleave(top_k)                   # [n*k]
        onehot = onehot * flat_valid[:, None]
    pos = (onehot.cumsum(0) - 1).gather(1, flat_ids[:, None])[:, 0]  # running count
    keep = pos < cap                                                  # dropped if over
    if valid is not None:
        keep = keep & flat_valid
    slot = flat_ids * cap + torch.where(keep, pos, torch.zeros_like(pos))

    xk = x2.repeat_interleave(top_k, dim=0)                          # [n*k, d]
    # A dropped pair adds a zero at its expert's position 0, as the JAX
    # scatter-add does; every kept slot receives exactly one row.
    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, torch.where(keep[:, None], xk, torch.zeros_like(xk)))
    expert_out = _expert_ffn(p, buf.reshape(e, cap, d), ffn_kind)
    gathered = expert_out.reshape(e * cap, d)[slot]                  # [n*k, d]
    wk = weights.reshape(-1) * keep
    y = (gathered.float() * wk[:, None]).reshape(n, top_k, d).sum(1)
    return y.reshape(b, s, d).to(x.dtype), aux
