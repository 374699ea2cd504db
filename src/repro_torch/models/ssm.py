"""The Mamba (S6 selective scan) mixer of the hybrid archs (jamba).

The port of the Mamba part of ``repro.models.ssm``, with the same contract
as attention:

    mamba_forward(params, x, return_state) -> y or (y, state)  # prefill
    mamba_decode(params, x_t, state)       -> (y_t, new_state) # one token

The selective scan is the ``ssm_scan`` dispatch site and the decode step
the ``ssm_update`` site; every projection gemm is a ``matmul`` dispatch,
``dt_proj`` and ``out_proj`` in fp32 (their bf16 weights cast on every
call, as the JAX package does). The state is ``{"h": [b, di, ds] fp32,
"conv": [b, d_conv - 1, di]}``, the conv tail holding the last
``d_conv - 1`` *pre-conv* inputs in the model dtype.

The xLSTM mixers (mLSTM, sLSTM) are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..core.runtime import dispatch
from .layers import Params, _init


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
