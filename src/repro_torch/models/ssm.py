"""The recurrent mixers: Mamba (S6 selective scan, the hybrid archs,
jamba) and mLSTM + sLSTM (xlstm).

The port of ``repro.models.ssm``, with the same contract as attention:

    *_forward(params, x, ..., return_state) -> y or (y, state)  # prefill
    *_decode(params, x_t, state, ...)       -> (y_t, new_state) # one token

The selective scan is the ``ssm_scan`` dispatch site and the decode step
the ``ssm_update`` site; every projection gemm is a ``matmul`` dispatch,
``dt_proj`` and ``out_proj`` in fp32 (their bf16 weights cast on every
call, as the JAX package does). The state is ``{"h": [b, di, ds] fp32,
"conv": [b, d_conv - 1, di]}``, the conv tail holding the last
``d_conv - 1`` *pre-conv* inputs in the model dtype.

The xLSTM mixers' recurrences are plain torch, as the JAX package computes
them raw; their projection gemms are ``matmul`` dispatch sites:

* mLSTM runs the stabilized chunkwise form, a Python loop over chunks of
  ``chunk`` steps (decay-masked in-chunk scores, an inter-chunk matrix
  memory carry), its state ``{"C": [b, h, hd, hd], "n": [b, h, hd],
  "m": [b, h]}`` in fp32. The gate projection ``xb @ w_gates`` is a plain
  fp32 product, as in JAX, and ``out_proj`` an fp32 gemm.
* sLSTM is sequential: a Python loop over tokens with exp-gating
  stabilizers, its state ``{"c", "n", "h", "m"}`` each [b, d] in fp32,
  followed by a GeGLU MLP of three ``matmul`` sites.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..core.runtime import dispatch
from .layers import Axes, Params, _init

LOG_EPS = -1e30


def mamba_init(gen, d: int, dtype, device, expand: int = 2, d_state: int = 16,
               d_conv: int = 4) -> Params:
    """The JAX package's init and scales; ``dt_bias``, ``A_log`` and ``D``
    are fp32 whatever the model dtype."""
    di = expand * d
    dt_rank = max(1, math.ceil(d / 16))
    f32 = torch.float32
    return {
        "in_proj": _init(gen, (d, 2 * di), dtype, device),
        "conv_w": _init(gen, (d_conv, di), dtype, device, scale=1.0 / math.sqrt(d_conv)),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": _init(gen, (di, dt_rank + 2 * d_state), dtype, device),
        "dt_proj": _init(gen, (dt_rank, di), dtype, device, scale=1.0 / math.sqrt(dt_rank)),
        "dt_bias": torch.full((di,), -2.0, dtype=f32, device=device),  # softplus^-1(~0.12)
        "A_log": torch.log(torch.arange(1, d_state + 1, dtype=f32, device=device)
                           ).expand(di, d_state).contiguous(),
        "D": torch.ones((di,), dtype=f32, device=device),
        "out_proj": _init(gen, (di, d), dtype, device, scale=1.0 / math.sqrt(di)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, x [b, s, di], w [k, di]: the k
    shifted products summed in x's dtype, then the bias, as the JAX loop
    does (``F.conv1d`` would accumulate in fp32 and round differently)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, j:j + s] * w[j] for j in range(k)) + b


def _mamba_project(p, x):
    x_in, z = dispatch("matmul", x, p["in_proj"]).chunk(2, dim=-1)
    return x_in, z


def _mamba_dtBC(p, xc):
    """xc [b, s, di] (conv'd, silu'd) -> (dt [b,s,di] fp32 post-softplus,
    B [b,s,ds] fp32, C [b,s,ds] fp32), the coefficients the scan and the
    update consume."""
    d_state = p["A_log"].shape[1]
    dt_rank = p["x_proj"].shape[1] - 2 * d_state
    proj = dispatch("matmul", xc, p["x_proj"]).float()
    dt, B, C = proj.split([dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dispatch("matmul", dt, p["dt_proj"].float()) + p["dt_bias"])
    return dt, B, C


def _mamba_out(p, y, xc, z, out_dtype):
    """Skip term, silu gate, and the fp32 down-projection."""
    y = y + p["D"] * xc.float()
    g = y * F.silu(z.float())
    return dispatch("matmul", g, p["out_proj"].float()).to(out_dtype)


def mamba_forward(p: Params, x: torch.Tensor, *, return_state: bool = False, scan_fn=None):
    """x [b, s, d] -> y, or (y, state) with the state decode continues
    from. The scan runs at exactly s steps, so the state is h at step s-1.
    The scan is the ``ssm_scan`` dispatch site unless ``scan_fn`` (same
    ``(xc, dt, B, C, A, h0) -> (y, hN)`` contract) pins another schedule,
    as the ``mamba_chunk`` tunable does."""
    b = x.shape[0]
    di = p["conv_b"].shape[0]
    d_state = p["A_log"].shape[1]
    k = p["conv_w"].shape[0]
    x_in, z = _mamba_project(p, x)
    xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, B, C = _mamba_dtBC(p, xc)
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((b, di, d_state), dtype=torch.float32, device=x.device)
    if scan_fn is None:
        y, hN = dispatch("ssm_scan", xc, dt, B, C, A, h0)
    else:
        y, hN = scan_fn(xc, dt, B, C, A, h0)
    out = _mamba_out(p, y, xc, z, x.dtype)
    if not return_state:
        return out
    # decode needs the last k-1 pre-conv inputs, zeros before a short prompt
    tail = F.pad(x_in, (0, 0, max(0, k - 1 - x_in.shape[1]), 0))[:, -(k - 1):]
    return out, {"h": hN, "conv": tail.contiguous()}


def mamba_state_shapes(batch: int, d: int, dtype, expand: int = 2, d_state: int = 16,
                       d_conv: int = 4) -> Dict[str, tuple]:
    """Each state leaf's (shape, dtype): ``h`` fp32, ``conv`` in ``dtype``."""
    di = expand * d
    return {"h": ((batch, di, d_state), torch.float32),
            "conv": ((batch, d_conv - 1, di), dtype)}


def mamba_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor]):
    """x [b, 1, d], one token -> (y [b, 1, d], new state). The caller owns
    the state's storage: the returned leaves are new tensors."""
    x_in, z = _mamba_project(p, x)                                # [b, 1, di]
    window = torch.cat([state["conv"].to(x.dtype), x_in], dim=1)  # [b, k, di]
    xc = F.silu((window * p["conv_w"][None]).sum(dim=1, keepdim=True) + p["conv_b"])
    dt, B, C = _mamba_dtBC(p, xc)                                 # [b, 1, ...]
    A = -torch.exp(p["A_log"])
    y, h = dispatch("ssm_update", xc[:, 0], dt[:, 0], B[:, 0], C[:, 0], A, state["h"])
    out = _mamba_out(p, y[:, None], xc, z, x.dtype)
    return out, {"h": h, "conv": window[:, 1:]}


# ===========================================================================
# mLSTM (matrix-memory LSTM) -- the stabilized chunkwise-parallel form
# ===========================================================================


def mamba_axes() -> Axes:
    return {"in_proj": ("d_model", "ff"), "conv_w": ("conv_k", "ff"), "conv_b": ("ff",),
            "x_proj": ("ff", "ssm_small"), "dt_proj": ("ssm_small", "ff"), "dt_bias": ("ff",),
            "A_log": ("ff", "ssm_state"), "D": ("ff",), "out_proj": ("ff", "d_model")}


def mlstm_axes() -> Axes:
    return {"in_proj": ("d_model", "ff"), "wq": ("ff", "ff2"), "wk": ("ff", "ff2"),
            "wv": ("ff", "ff2"), "w_gates": ("ff", "heads_small"), "b_gates": ("heads_small",),
            "norm_scale": ("ff",), "out_proj": ("ff", "d_model")}


def slstm_axes() -> Axes:
    return {"w": ("d_model", "heads"), "r": ("heads_small", "hd", "hd4"), "b": ("heads",),
            "up_g": ("d_model", "ff"), "up_u": ("d_model", "ff"), "down": ("ff", "d_model")}


def mlstm_init(gen, d: int, n_heads: int, dtype, device, expand: int = 2) -> Params:
    """The JAX package's init and scales; ``w_gates`` and ``b_gates`` in
    fp32 whatever the model dtype, the forget bias 3.0."""
    di = expand * d
    f32 = torch.float32
    return {
        "in_proj": _init(gen, (d, 2 * di), dtype, device),
        "wq": _init(gen, (di, di), dtype, device),
        "wk": _init(gen, (di, di), dtype, device),
        "wv": _init(gen, (di, di), dtype, device),
        "w_gates": _init(gen, (di, 2 * n_heads), f32, device, scale=0.01),
        "b_gates": torch.cat([torch.zeros((n_heads,), dtype=f32, device=device),
                              torch.full((n_heads,), 3.0, dtype=f32, device=device)]),
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": _init(gen, (di, d), dtype, device, scale=1.0 / math.sqrt(di)),
    }


def _mlstm_qkvg(p, x, n_heads):
    """x [b, s, d] -> q, k, v [b, h, s, hd] (model dtype), z [b, s, di],
    and the log input and log forget gates [b, h, s] in fp32."""
    b, s, _ = x.shape
    di = p["wq"].shape[0]
    hd = di // n_heads
    xb, z = dispatch("matmul", x, p["in_proj"]).chunk(2, dim=-1)
    heads = lambda w: dispatch("matmul", xb, w).reshape(b, s, n_heads, hd).transpose(1, 2)
    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    # the gate projection is [di, 2h]: a plain fp32 product, as in JAX
    # repro: allow-raw(gate projection is tiny — [di, 2h] with h a handful of heads, far below the tuned-gemm tile floor)
    gates = xb.float() @ p["w_gates"] + p["b_gates"]
    log_i, f_raw = gates.chunk(2, dim=-1)                        # [b, s, h]
    return q, k, v, z, log_i.transpose(1, 2), F.logsigmoid(f_raw).transpose(1, 2)


def _mlstm_out(p, h, z, out_dtype):
    """The RMS norm over all of di (JAX's "per-head group norm" takes the
    mean over the whole last axis), ``norm_scale``, the silu(z) gate and
    the fp32 down-projection (its weight cast on every call)."""
    hn = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + 1e-6)
    hn = (hn * p["norm_scale"]).float()
    return dispatch("matmul", hn * F.silu(z.float()), p["out_proj"].float()).to(out_dtype)


def _mlstm_scan(q, k, v, log_i, log_f, chunk: int):
    """The stabilized chunkwise recurrence: q, k, v [b, h, s, hd], the log
    gates [b, h, s] in fp32 -> (h [b, h, s, hd] fp32, C, n, m), the state
    after step s - 1. A ragged last chunk is padded with log input gate
    ``LOG_EPS`` and log forget gate 0: the pad steps add nothing and decay
    nothing. A Python loop over the chunks, plain torch as in JAX."""
    b, n_heads, s, hd = q.shape
    scale = hd ** -0.5
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, pad), value=LOG_EPS)
        log_f = F.pad(log_f, (0, pad))
    f32 = torch.float32
    C = torch.zeros((b, n_heads, hd, hd), dtype=f32, device=q.device)
    n = torch.zeros((b, n_heads, hd), dtype=f32, device=q.device)
    m = torch.zeros((b, n_heads), dtype=f32, device=q.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    hs = []
    # repro: allow-raw(mLSTM decay-masked score matmuls await a fused mlstm_scores tunable — plain-matmul records cannot carry the mask epilogue; the inter-chunk state recurrence is sequential by construction)
    for c0 in range(0, s + pad, chunk):
        qc = q[:, :, c0:c0 + chunk].float() * scale               # [b, h, c, hd]
        kc, vc = k[:, :, c0:c0 + chunk].float(), v[:, :, c0:c0 + chunk].float()
        li, lf = log_i[..., c0:c0 + chunk], log_f[..., c0:c0 + chunk]   # [b, h, c]
        Fc = torch.cumsum(lf, dim=-1)                             # inclusive cum log-forget
        # intra-chunk decay g[t, s'] = F_t - F_s' + li_s' for s' <= t
        g = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
        g = torch.where(tri, g, LOG_EPS)
        carry_lg = Fc + m[..., None]                              # carry-in decay
        m_new = torch.maximum(g.amax(dim=-1), carry_lg)
        scores = (qc @ kc.transpose(-1, -2)) * torch.exp(g - m_new[..., None])
        inter = torch.exp(carry_lg - m_new)
        num = scores @ vc + inter[..., None] * (qc @ C)
        den = scores.sum(dim=-1) + inter * (qc @ n[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])
        # the state at the chunk's end
        F_tot = Fc[..., -1]                                       # [b, h]
        lg_state = F_tot[..., None] - Fc + li                     # each step's decay to the end
        m_next = torch.maximum(F_tot + m, lg_state.amax(dim=-1))
        w_s = torch.exp(lg_state - m_next[..., None])             # [b, h, c]
        decay = torch.exp(F_tot + m - m_next)
        wk = w_s[..., None] * kc
        C = decay[..., None, None] * C + wk.transpose(-1, -2) @ vc
        n = decay[..., None] * n + wk.sum(dim=-2)
        m = m_next
    return torch.cat(hs, dim=2)[:, :, :s], C, n, m


def mlstm_forward(p: Params, x: torch.Tensor, *, n_heads: int, chunk: int = 64,
                  return_state: bool = False):
    """x [b, s, d] -> y, or (y, state) with the state decode continues
    from (:func:`_mlstm_scan` over the projections)."""
    b, s, _ = x.shape
    di = p["wq"].shape[0]
    q, k, v, z, log_i, log_f = _mlstm_qkvg(p, x, n_heads)
    h, C, n, m = _mlstm_scan(q, k, v, log_i, log_f, chunk)
    out = _mlstm_out(p, h.transpose(1, 2).reshape(b, s, di), z, x.dtype)
    if not return_state:
        return out
    return out, {"C": C, "n": n, "m": m}


def mlstm_state_shapes(batch: int, d: int, n_heads: int, expand: int = 2) -> Dict[str, tuple]:
    """Each state leaf's (shape, dtype), all fp32."""
    di = expand * d
    hd = di // n_heads
    f32 = torch.float32
    return {"C": ((batch, n_heads, hd, hd), f32), "n": ((batch, n_heads, hd), f32),
            "m": ((batch, n_heads), f32)}


def mlstm_decode(p: Params, x: torch.Tensor, state, *, n_heads: int):
    """x [b, 1, d], one token -> (y [b, 1, d], new state as new tensors)."""
    b = x.shape[0]
    di = p["wq"].shape[0]
    hd = di // n_heads
    q, k, v, z, log_i, log_f = _mlstm_qkvg(p, x, n_heads)
    q, k, v = q[:, :, 0].float(), k[:, :, 0].float(), v[:, :, 0].float()   # [b, h, hd]
    li, lf = log_i[..., 0], log_f[..., 0]                                # [b, h]
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    f_s = torch.exp(lf + m - m_new)
    i_s = torch.exp(li - m_new)
    C = f_s[..., None, None] * C + i_s[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = f_s[..., None] * n + i_s[..., None] * k
    qf = (q * hd ** -0.5)[..., None, :]                                  # [b, h, 1, hd]
    # repro: allow-raw(decode-step state readout — [b,h,hd] contractions, too small to tile)
    num = (qf @ C)[..., 0, :]
    # repro: allow-raw(decode-step state readout — [b,h,hd] contractions, too small to tile)
    den = (qf @ n[..., None])[..., 0, 0].abs()
    h = (num / torch.maximum(den, torch.exp(-m_new))[..., None]).reshape(b, 1, di)
    return _mlstm_out(p, h, z, x.dtype), {"C": C, "n": n, "m": m_new}


# ===========================================================================
# sLSTM (scalar-memory LSTM with exp gating) -- sequential recurrence
# ===========================================================================


def slstm_ff(d: int) -> int:
    """The post-MLP's width: GeGLU at 4/3 of d, rounded up to 64."""
    return ((4 * d // 3 + 63) // 64) * 64


def slstm_init(gen, d: int, n_heads: int, dtype, device) -> Params:
    """The JAX package's init and scales; the bias ``b`` in fp32, in the
    order z, i, f, o, the forget part 3.0."""
    hd = d // n_heads
    ff = slstm_ff(d)
    f32 = torch.float32
    return {
        "w": _init(gen, (d, 4 * d), dtype, device),
        "r": _init(gen, (n_heads, hd, 4 * hd), dtype, device, scale=1.0 / math.sqrt(hd)),
        "b": torch.cat([torch.zeros((2 * d,), dtype=f32, device=device),
                        torch.full((d,), 3.0, dtype=f32, device=device),
                        torch.zeros((d,), dtype=f32, device=device)]),
        "up_g": _init(gen, (d, ff), dtype, device),
        "up_u": _init(gen, (d, ff), dtype, device),
        "down": _init(gen, (ff, d), dtype, device, scale=1.0 / math.sqrt(ff)),
    }


def _slstm_cell(p, r32, xw, state, n_heads):
    """One step: xw [b, 4d] (x @ w in fp32), ``r32`` the recurrent weight in
    fp32. The block-diagonal recurrent product [b, heads, 4 hd] is flattened
    to [b, 4d] before the four-way split, as in JAX: z takes the first
    quarter of the flattened row (at 4 heads, all of head 0's outputs)."""
    b = xw.shape[0]
    d = state["h"].shape[-1]
    hr = state["h"].reshape(b, n_heads, d // n_heads).transpose(0, 1)   # [heads, b, hd]
    # repro: allow-raw(per-step block-diagonal recurrent product [heads, b, hd] @ [heads, hd, 4 hd] carries h — each token needs the last one's, so it stays inside the token loop)
    rec = torch.bmm(hr, r32).transpose(0, 1).reshape(b, 4 * d)
    zf, if_, ff_, of_ = (xw + rec + p["b"]).chunk(4, dim=-1)
    z = torch.tanh(zf)
    o = torch.sigmoid(of_)
    lf_m = F.logsigmoid(ff_) + state["m"]
    m_new = torch.maximum(lf_m, if_)
    i_s = torch.exp(if_ - m_new)
    f_s = torch.exp(lf_m - m_new)
    c = f_s * state["c"] + i_s * z
    n = f_s * state["n"] + i_s
    h = o * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_mlp(p: Params, h: torch.Tensor) -> torch.Tensor:
    """The post-cell GeGLU MLP (tanh GELU), three ``matmul`` sites."""
    g = F.gelu(dispatch("matmul", h, p["up_g"]), approximate="tanh")
    return dispatch("matmul", g * dispatch("matmul", h, p["up_u"]), p["down"])


def _slstm_scan(p: Params, xw: torch.Tensor, n_heads: int):
    """The recurrence over xw [b, s, 4d] (fp32) from a zero state: a Python
    loop of one cell a token. Returns (h [b, s, d] fp32, the final state)."""
    b, _, d4 = xw.shape
    r32 = p["r"].float()
    state = {k: torch.zeros((b, d4 // 4), dtype=torch.float32, device=xw.device)
             for k in ("c", "n", "h", "m")}
    hs = []
    # unbind: one backward node hands each step its slice of the gradient,
    # where indexing xw[:, t] would add a zero-padded full-size one a step
    for xw_t in xw.unbind(1):
        state = _slstm_cell(p, r32, xw_t, state, n_heads)
        hs.append(state["h"])
    return torch.stack(hs, dim=1), state


def slstm_forward(p: Params, x: torch.Tensor, *, n_heads: int, unroll: int = 1,
                  return_state: bool = False):
    """x [b, s, d] -> y, or (y, state). ``unroll`` is the JAX scan's
    schedule knob and changes nothing here."""
    xw = dispatch("matmul", x, p["w"]).float()                  # [b, s, 4d]
    h, state = _slstm_scan(p, xw, n_heads)
    y = _slstm_mlp(p, h.to(x.dtype))
    if not return_state:
        return y
    return y, state


def slstm_state_shapes(batch: int, d: int) -> Dict[str, tuple]:
    """Each state leaf's (shape, dtype): c, n, h and m, [batch, d] fp32."""
    return {k: ((batch, d), torch.float32) for k in ("c", "n", "h", "m")}


def slstm_decode(p: Params, x: torch.Tensor, state, *, n_heads: int):
    """x [b, 1, d], one token -> (y [b, 1, d], new state as new tensors)."""
    xw = dispatch("matmul", x[:, 0], p["w"]).float()
    new = _slstm_cell(p, p["r"].float(), xw, state, n_heads)
    return _slstm_mlp(p, new["h"].to(x.dtype)[:, None]), new
