"""Selective scan (Mamba S6): the ``ssm_scan`` and ``ssm_update``
tunables and their CUDA kernels.

The recurrence is ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * xc_t) * B_t``,
``y_t = h_t . C_t``, with an fp32 carry. Two dispatch sites, as in
``repro.kernels.ssm_scan``:

* ``ssm_scan`` -- prefill over ``[b, s, di]``. Replaces the TPU kernel
  ``repro/kernels/ssm_scan.py:_ssm_scan_kernel`` (``ssm_scan_pallas``).
  Its Reference tier is :func:`ssm_scan_chunked`, the port of the JAX
  package's chunked form with the same signature and ``chunk`` knob.
  PyTorch has no stable associative scan, so it steps through time inside
  each chunk: the same recurrence, with a peak live tensor of
  ``[b, di, ds]`` (never ``[b, s, di, ds]``).
* ``ssm_update`` -- one decode step over ``[b, di]``. Replaces
  ``repro/kernels/ssm_scan.py:_ssm_update_kernel`` (``ssm_update_pallas``).

Both kernels are in ``csrc/ssm_scan.cu``. The kernels take ``exp`` as
``exp2`` of ``dt * (A * log2 e)``; the plain versions
:func:`ssm_scan_plain` and :func:`ssm_update_plain` do the same. A channel's
states live in registers, so ``d_state`` is at most :data:`MAX_STATE`.

On an H100 the scan is bound by its exponentials (one a state element a
step, on the SFUs at 16 a clock an SM), not by its bytes, and the
schedulers' slots for the instructions around them come close behind. The first port
kept one thread a channel and staged each slice with the threads
that compute it: 4 warps an SM at b = 1, every slice's loads exposed. The
kernel now specialises warps: a producer warp fills a ring of slices in
shared memory behind mbarriers while the consumer warps only compute;
``lanes`` threads share a channel's states (16, 8 or 4 each), for up to 16
consumer warps an SM; a turn of ``lanes`` steps runs without a branch and
sums its y by one reduce-scatter of shuffles. The producer's loader is
picked by :func:`loader` from alignment: ``tma`` (four boxes a slice from
one thread) or ``cpasync`` (xc by the producer warp's cp.async in the
widest granule its rows allow, dt, B and C by TMA where theirs allow it).
Each has its launch counter, ``ssm_scan_tma`` and ``ssm_scan_cpasync``,
beside ``ssm_scan``.

Knobs, worked out for the H100 (not the TPU's VMEM): the scan's ``chunk``
is the time steps of a slice, ``stages`` the slices of the ring,
``block_d`` the channels of a CTA and ``lanes`` the threads of a channel;
``block_d * lanes`` consumer threads (one warp to 512) plus the producer
warp, and ``stages`` slices of ``chunk * (block_d * 8 + 2 * d_state * 4)``
bytes at most (:func:`scan_smem_bytes`) within the 227 KB a block may use.
The update is bound by its bytes (the state read and written once);
``lanes`` threads share a channel's 16 states, a float4 each at four lanes,
so a warp's state accesses are contiguous 16-byte runs. Its CTA is
``block_d`` channels by ``block_b`` rows, ``block_d * lanes`` threads (one
warp to 1,024); each thread keeps its float4s of A in registers across the
CTA's rows.

Backwards are dispatch sites of their own, as in the JAX package: both
forward sites declare ``vjp="dispatch"``, and their plans dispatch
``ssm_scan_bwd`` and ``ssm_update_bwd`` with both cotangents in fp32.
These are torch code, not kernels (their JAX counterparts are jnp, not
Pallas), gated against the autograd VJPs ``ref.ssm_scan_bwd`` and
``ref.ssm_update_bwd``. The scan's backward is the adjoint recurrence
``g_t = exp(dt_{t+1} A) g_{t+1} + ct_y_t C_t`` walked ``chunk`` steps at a
time: the states of a chunk are recomputed from its saved entry state, so
at most a few ``[chunk, b, di, ds]`` tensors are live, never ``[b, s, di,
ds]``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core import Constraint, DispatchSpec, ParamSpace, PowerOfTwoParam, tunable
from ..core.params import EnumParam
from ..core.platform import H100_SXM
from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16
SCAN_MAX_CONSUMERS = 512
LOG2E = 1.0 / math.log(2.0)
LOADERS = {"cpasync": 0, "tma": 1}


def _align128(v: int) -> int:
    return (v + 127) // 128 * 128


def scan_smem_bytes(c, ds: int = MAX_STATE, itemsize: int = 4) -> int:
    """Shared memory of one scan CTA: ``stages`` slices of xc (``itemsize``
    bytes an element), dt, B and C, each region 128-byte aligned, the
    ring's two mbarriers a slice and 128 bytes of alignment slack (mirrors
    repro_ssm_scan_smem_bytes). The defaults are the widest case."""
    chunk, bd = c["chunk"], c["block_d"]
    stage = (_align128(chunk * bd * itemsize) + _align128(chunk * bd * 4)
             + 2 * _align128(chunk * ds * 4))
    return 128 + c["stages"] * (stage + 16)


SSM_SCAN_SPACE = ParamSpace(
    [
        PowerOfTwoParam("chunk", 8, 256),
        PowerOfTwoParam("block_d", 16, 256),
        EnumParam("stages", (2, 3, 4)),
        EnumParam("lanes", (1, 2, 4)),
    ],
    [
        Constraint(lambda c: 32 <= c["block_d"] * c["lanes"] <= SCAN_MAX_CONSUMERS,
                   "block_d x lanes consumer threads outside one warp .. 512"),
        Constraint(lambda c: scan_smem_bytes(c) <= H100_SXM.smem_per_block,
                   "stages x chunk-step slices exceed 227 KB of shared memory"),
    ],
)

SSM_UPDATE_SPACE = ParamSpace(
    [
        PowerOfTwoParam("block_b", 1, 8),
        PowerOfTwoParam("block_d", 8, 1024),
        EnumParam("lanes", (1, 2, 4)),
    ],
    [
        Constraint(lambda c: 32 <= c["block_d"] * c["lanes"] <= H100_SXM.max_threads_per_block,
                   "block_d x lanes threads outside one warp .. 1024 a CTA"),
    ],
)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _ssm_scan_heuristic(xc, dt, B, C, A, h0):
    """Four lanes a channel, the most warps an SM, and the widest CTA (up to
    128 channels) that still gives every SM a CTA: at b = 1, d_inner =
    16384 that is 64 channels, 256 CTAs of 8 consumer warps and the
    producer. A ring of two 64-step slices (shorter for a shorter prompt),
    64 KB in bf16."""
    b, s, di = xc.shape
    bd = 128
    while bd > 16 and b * -(-di // bd) < H100_SXM.sm_count:
        bd //= 2
    return {"chunk": min(64, max(8, _pow2_at_least(s))), "block_d": bd, "stages": 2,
            "lanes": 4}


def _ssm_update_heuristic(xc, dt, B, C, A, h):
    """Four lanes a channel (a float4 of the 16 states each), 64 channels a
    CTA of 256 threads, and up to 8 rows a CTA (every row of the 8-slot
    pool: A read once a channel): 256 CTAs at d_inner = 16384, two an SM."""
    return {"block_b": min(8, _pow2_at_least(xc.shape[0])), "block_d": 64, "lanes": 4}


def _contiguous(*args):
    """B and C reach the sites as column slices of the x_proj output: the
    kernels take dense rows."""
    return tuple(a.contiguous() for a in args), lambda out: out


def _inputs(rs, lead, di, ds):
    """Seeded inputs in the ranges the mixer gives (dt > 0 after softplus,
    A < 0): xc, dt [*lead, di], B, C [*lead, ds], A [di, ds], state
    [lead[0], di, ds]."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (t(rs.randn(*lead, di) * 0.5), t(np.abs(rs.randn(*lead, di)) * 0.1 + 0.01),
            t(rs.randn(*lead, ds) * 0.5), t(rs.randn(*lead, ds) * 0.5),
            t(-np.abs(rs.randn(di, ds)) - 0.1), t(rs.randn(lead[0], di, ds) * 0.3))


def _ssm_scan_example():
    """b=2, s=12, di=8, ds=4: s is not a multiple of the smallest chunk."""
    return _inputs(np.random.RandomState(0), (2, 12), 8, 4), {}


def _ssm_update_example():
    return _inputs(np.random.RandomState(2), (3,), 8, 4), {}


# ---------------------------------------------------------------------------
# Reference tier: the chunked form
# ---------------------------------------------------------------------------


def ssm_scan_chunked(xc, dt, B, C, A, h0, *, chunk: int = 32):
    """The ``ssm_scan`` tunable's Reference tier: same signature and result
    as :func:`ref.ssm_scan`, walked ``chunk`` steps at a time (the chunk's
    ``dt * xc`` products taken at once, then its steps in order). Stops at
    s, so the state is h at step s-1 for any s. Peak live tensor
    ``[b, di, ds]``."""
    b, s, di = xc.shape
    chunk = max(1, min(int(chunk), s))
    h = h0.float()
    y = torch.empty((b, s, di), dtype=torch.float32, device=xc.device)
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        dbx = dt[:, c0:c1] * xc[:, c0:c1].float()               # [b, c, di]
        for t in range(c1 - c0):
            dA = torch.exp(dt[:, c0 + t, :, None] * A)
            h = dA * h + dbx[:, t, :, None] * B[:, c0 + t, None, :]
            y[:, c0 + t] = (h * C[:, c0 + t, None, :]).sum(-1)
    return y, h


# ---------------------------------------------------------------------------
# ssm_scan
# ---------------------------------------------------------------------------


def ssm_scan_plain(xc, dt, B, C, A, h0):
    """The scan kernel's function in plain PyTorch: (y, hN), both fp32,
    stepping through time with exp taken as exp2 of the log2-scaled A."""
    a2 = A.float() * LOG2E
    xf = xc.float()
    h = h0.float()
    y = torch.empty(xc.shape, dtype=torch.float32, device=xc.device)
    for t in range(xc.shape[1]):
        h = torch.exp2(dt[:, t, :, None] * a2) * h + (dt[:, t] * xf[:, t])[..., None] \
            * B[:, t, None, :]
        y[:, t] = (h * C[:, t, None, :]).sum(-1)
    return y, h


def _check_ssm(name, xc, dt, B, C, A, h, lead):
    """Shapes, dtypes, contiguity and device of either kernel's inputs;
    ``lead`` is (b, s) for the scan and (b,) for the update."""
    di, ds = A.shape
    want = {"xc": lead + (di,), "dt": lead + (di,), "B": lead + (ds,), "C": lead + (ds,),
            "h": (lead[0], di, ds)}
    for n, t in (("xc", xc), ("dt", dt), ("B", B), ("C", C), ("h", h)):
        if tuple(t.shape) != want[n]:
            raise ValueError(f"{name}: {n} has shape {tuple(t.shape)}, expected {want[n]}")
    if xc.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes xc in f32 or bf16, got {xc.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, B, C, A, h)):
        raise TypeError(f"{name} kernel takes dt, B, C, A and the state in fp32")
    if ds > MAX_STATE:
        raise ValueError(f"{name} kernel keeps at most {MAX_STATE} states a channel in "
                         f"registers, got d_state={ds}")
    if not all(t.is_contiguous() for t in (xc, dt, B, C, A, h)):
        raise ValueError(f"{name} kernel takes contiguous tensors only")
    if len({t.device for t in (xc, dt, B, C, A, h)}) != 1:
        raise ValueError(f"{name} tensors on different devices")


def loader(xc, dt, B, C) -> str:
    """The scan's loader: ``tma`` when every base is 16-byte aligned and the
    rows of xc and dt and of B and C (d_state * 4 bytes) are 16-byte
    multiples, as a TMA box needs; else ``cpasync`` (xc by cp.async; dt, B
    and C by TMA where their own rows allow it). The kernel's entry holds
    the TMA loader to the same rule."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (xc, dt, B, C))
    if aligned and xc.shape[-1] * xc.element_size() % 16 == 0 and B.shape[-1] % 4 == 0:
        return "tma"
    return "cpasync"


_SCAN_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def ssm_scan_cuda(xc, dt, B, C, A, h0, *, chunk: int, block_d: int, stages: int, lanes: int):
    """Launch the scan of csrc/ssm_scan.cu on CUDA tensors: (y, hN)."""
    if xc.dim() != 3 or A.dim() != 2:
        raise ValueError(f"ssm_scan takes xc [b,s,di] and A [di,ds], got {tuple(xc.shape)}, "
                         f"{tuple(A.shape)}")
    b, s, di = xc.shape
    ds = A.shape[1]
    _check_ssm("ssm_scan", xc, dt, B, C, A, h0, (b, s))
    cfg = {"chunk": chunk, "block_d": block_d, "stages": stages, "lanes": lanes}
    if scan_smem_bytes(cfg, ds, xc.element_size()) > H100_SXM.smem_per_block:
        raise ValueError(f"ssm_scan: {cfg} exceeds {H100_SXM.smem_per_block} B of shared memory")
    ld = loader(xc, dt, B, C)
    y = torch.empty((b, s, di), dtype=torch.float32, device=xc.device)
    hn = torch.empty((b, di, ds), dtype=torch.float32, device=xc.device)
    fn = _build.entry("ssm_scan", "repro_ssm_scan", _SCAN_ARGTYPES)
    err = fn(xc.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
             h0.data_ptr(), y.data_ptr(), hn.data_ptr(), b, s, di, ds, _DTYPES[xc.dtype],
             chunk, block_d, stages, lanes, LOADERS[ld], _build.stream_ptr(xc.device))
    _build.check("ssm_scan", err, f"ssm_scan b={b} s={s} di={di} ds={ds} {cfg} loader={ld}")
    _build.LAUNCHES["ssm_scan"] += 1
    _build.LAUNCHES[f"ssm_scan_{ld}"] += 1
    return y, hn


def ssm_scan_ctas_per_sm(dtype, ds: int, cfg: dict, ld: str) -> int:
    """CTAs of ``cfg`` one SM holds on the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); each has
    ``block_d * lanes / 32`` consumer warps and the producer."""
    fn = _build.entry("ssm_scan", "repro_ssm_scan_ctas_per_sm",
                      [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    err = fn(_DTYPES[dtype], ds, cfg["chunk"], cfg["block_d"], cfg["stages"], cfg["lanes"],
             LOADERS[ld], ctypes.byref(out))
    _build.check("ssm_scan", err, f"ssm_scan occupancy {cfg} loader={ld}")
    return out.value


def _ssm_scan_bwd_plan(ct, xc, dt, B, C, A, h0):
    """Backward plan: one ``ssm_scan_bwd`` dispatch site on the cotangents of
    y and of the final state (zeros where the caller dropped it), in fp32."""
    from ..core.runtime import dispatch

    ct_y, ct_h = ct
    return dispatch("ssm_scan_bwd", ct_y.float(), ct_h.float(), xc, dt, B, C, A, h0)


@tunable(
    "ssm_scan",
    space=SSM_SCAN_SPACE,
    reference=ssm_scan_chunked,
    heuristic=_ssm_scan_heuristic,
    # A is the [di, ds] state matrix (a weight, never batch-sharded).
    dispatch=DispatchSpec(canonicalize=_contiguous, example=_ssm_scan_example,
                          data_parallel_args=(0, 1, 2, 3, 5), vjp="dispatch",
                          bwd=_ssm_scan_bwd_plan),
)
def ssm_scan(xc, dt, B, C, A, h0, *, chunk: int, block_d: int, stages: int, lanes: int):
    if xc.is_cuda:
        return ssm_scan_cuda(xc, dt, B, C, A, h0, chunk=chunk, block_d=block_d, stages=stages,
                             lanes=lanes)
    if xc.device.type == "cpu":
        return ssm_scan_plain(xc, dt, B, C, A, h0)
    raise _build.KernelUnavailable(f"ssm_scan has no kernel for device {xc.device}")


# ---------------------------------------------------------------------------
# ssm_scan_bwd: the chunk-windowed adjoint recurrence
# ---------------------------------------------------------------------------


SSM_SCAN_BWD_SPACE = ParamSpace([PowerOfTwoParam("chunk", 8, 512)])


def _pick_pow2(d: int, lo: int, cap: int) -> int:
    """The JAX package's heuristic rounding: the power of two at or above
    ``d``, within [lo, cap]."""
    return min(cap, max(lo, _pow2_at_least(max(d, 1))))


def _ssm_scan_bwd_heuristic(ct_y, ct_h, xc, dt, B, C, A, h0):
    return {"chunk": _pick_pow2(xc.shape[1], 8, 64)}


def _cotangents(rs, y_shape, h_shape):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return t(rs.randn(*y_shape) * 0.5), t(rs.randn(*h_shape) * 0.5)


def _ssm_scan_bwd_example():
    (xc, dt, B, C, A, h0), _ = _ssm_scan_example()
    return _cotangents(np.random.RandomState(1), xc.shape, h0.shape) + (
        xc, dt, B, C, A, h0), {}


@tunable(
    "ssm_scan_bwd",
    space=SSM_SCAN_BWD_SPACE,
    reference=ref.ssm_scan_bwd,
    heuristic=_ssm_scan_bwd_heuristic,
    dispatch=DispatchSpec(example=_ssm_scan_bwd_example,
                          data_parallel_args=(0, 1, 2, 3, 4, 5, 7),
                          # the reference's VJP: grad-of-grad differentiates through
                          vjp="reference"),
)
def ssm_scan_bwd(ct_y, ct_h, xc, dt, B, C, A, h0, *, chunk: int):
    """VJP of the scan, (d_xc, d_dt, d_B, d_C, d_A, d_h0) in fp32, with
    ``chunk`` as the rematerialisation window.

    With ``a_t = exp(dt_t A)`` and ``u_t = (dt_t xc_t) B_t``, the forward is
    ``h_t = a_t h_{t-1} + u_t``; the state's cotangent runs backwards as
    ``g_t = a_{t+1} g_{t+1} + ct_y_t C_t`` from ``g_{s-1} = ct_h + ct_y_{s-1}
    C_{s-1}``. A first pass keeps each chunk's entry state; the second walks
    the chunks in reverse, recomputes a chunk's states from its entry
    state, runs g through it and takes the chunk's gradients at once (d_A
    summed over the chunks). One fused multiply-add a step in each of the
    three walks; time-major ``[chunk, b, di, ds]`` tensors, so each step's
    slice is contiguous."""
    b, s, di = xc.shape
    dev = xc.device
    chunk = max(1, min(int(chunk), s))
    bounds = [(c0, min(c0 + chunk, s)) for c0 in range(0, s, chunk)]
    A = A.float()
    tm = lambda t: t.transpose(0, 1).float()          # [b, L, ...] -> [L, b, ...]

    def coeffs(c0, c1):
        d, x = tm(dt[:, c0:c1]), tm(xc[:, c0:c1])
        a = torch.exp(d[..., None] * A)                               # [L, b, di, ds]
        u = (d * x)[..., None] * tm(B[:, c0:c1])[:, :, None, :]      # [L, b, di, ds]
        return d, x, a, u

    with torch.no_grad():
        entry, h = [], h0.float()
        for c0, c1 in bounds:
            entry.append(h)
            _, _, a, u = coeffs(c0, c1)
            for a_t, u_t in zip(a.unbind(0), u.unbind(0)):     # views made once a chunk
                h = torch.addcmul(u_t, a_t, h)
        d_xc = torch.empty((b, s, di), dtype=torch.float32, device=dev)
        d_dt = torch.empty_like(d_xc)
        d_B = torch.empty(B.shape, dtype=torch.float32, device=dev)
        d_C = torch.empty_like(d_B)
        d_A = torch.zeros_like(A)
        g = ct_h.float()                  # the state's cotangent from beyond the chunk
        for (c0, c1), h_in in zip(reversed(bounds), reversed(entry)):
            n = c1 - c0
            d, x, a, hs = coeffs(c0, c1)
            a_t, h_t = a.unbind(0), hs.unbind(0)
            h_t[0].addcmul_(a_t[0], h_in)    # u becomes the chunk's states
            for t in range(1, n):
                h_t[t].addcmul_(a_t[t], h_t[t - 1])
            cy, Bt, Ct = tm(ct_y[:, c0:c1]), tm(B[:, c0:c1]), tm(C[:, c0:c1])
            G = cy[..., None] * Ct[:, :, None, :]
            g_t = G.unbind(0)
            g_t[n - 1].add_(g)
            for t in range(n - 2, -1, -1):
                g_t[t].addcmul_(a_t[t + 1], g_t[t + 1])
            g = a[0] * G[0]
            d_C[:, c0:c1] = (cy[..., None] * hs).sum(2).transpose(0, 1)
            d_u = (G * Bt[:, :, None, :]).sum(-1)                     # d(dt * xc), [L, b, di]
            d_B[:, c0:c1] = (G * (d * x)[..., None]).sum(2).transpose(0, 1)
            h_prev = torch.cat([h_in[None], hs[:-1]])
            d_log = G.mul_(h_prev).mul_(a)                           # d(dt * A)
            d_A += (d_log * d[..., None]).sum((0, 1))
            d_dt[:, c0:c1] = ((d_log * A).sum(-1) + d_u * x).transpose(0, 1)
            d_xc[:, c0:c1] = (d_u * d).transpose(0, 1)
    return d_xc, d_dt, d_B, d_C, d_A, g


# ---------------------------------------------------------------------------
# ssm_update
# ---------------------------------------------------------------------------


def ssm_update_plain(xc, dt, B, C, A, h):
    """The update kernel's function in plain PyTorch: (y, h_new), fp32."""
    dA = torch.exp2(dt[..., None] * (A.float() * LOG2E))
    hn = dA * h + (dt * xc.float())[..., None] * B[:, None, :]
    return (hn * C[:, None, :]).sum(-1), hn


_UPDATE_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def ssm_update_cuda(xc, dt, B, C, A, h, *, block_b: int, block_d: int, lanes: int):
    """Launch the decode update of csrc/ssm_scan.cu on CUDA tensors."""
    if xc.dim() != 2 or A.dim() != 2:
        raise ValueError(f"ssm_update takes xc [b,di] and A [di,ds], got {tuple(xc.shape)}, "
                         f"{tuple(A.shape)}")
    b, di = xc.shape
    ds = A.shape[1]
    _check_ssm("ssm_update", xc, dt, B, C, A, h, (b,))
    y = torch.empty((b, di), dtype=torch.float32, device=xc.device)
    hn = torch.empty((b, di, ds), dtype=torch.float32, device=xc.device)
    fn = _build.entry("ssm_scan", "repro_ssm_update", _UPDATE_ARGTYPES)
    err = fn(xc.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
             h.data_ptr(), y.data_ptr(), hn.data_ptr(), b, di, ds, _DTYPES[xc.dtype], block_b,
             block_d, lanes, _build.stream_ptr(xc.device))
    _build.check("ssm_scan", err, f"ssm_update b={b} di={di} ds={ds} block_b={block_b} "
                                  f"block_d={block_d} lanes={lanes}")
    _build.LAUNCHES["ssm_update"] += 1
    return y, hn


def _ssm_update_bwd_plan(ct, xc, dt, B, C, A, h):
    from ..core.runtime import dispatch

    ct_y, ct_h = ct
    return dispatch("ssm_update_bwd", ct_y.float(), ct_h.float(), xc, dt, B, C, A, h)


@tunable(
    "ssm_update",
    space=SSM_UPDATE_SPACE,
    reference=ref.ssm_update,
    heuristic=_ssm_update_heuristic,
    dispatch=DispatchSpec(canonicalize=_contiguous, example=_ssm_update_example,
                          data_parallel_args=(0, 1, 2, 3, 5), vjp="dispatch",
                          bwd=_ssm_update_bwd_plan),
)
def ssm_update(xc, dt, B, C, A, h, *, block_b: int, block_d: int, lanes: int):
    if xc.is_cuda:
        return ssm_update_cuda(xc, dt, B, C, A, h, block_b=block_b, block_d=block_d,
                               lanes=lanes)
    if xc.device.type == "cpu":
        return ssm_update_plain(xc, dt, B, C, A, h)
    raise _build.KernelUnavailable(f"ssm_update has no kernel for device {xc.device}")


# ---------------------------------------------------------------------------
# ssm_update_bwd
# ---------------------------------------------------------------------------


SSM_UPDATE_BWD_SPACE = ParamSpace([PowerOfTwoParam("block_d", 8, 512)])


def _ssm_update_bwd_heuristic(ct_y, ct_h, xc, dt, B, C, A, h):
    return {"block_d": _pick_pow2(xc.shape[1], 8, 256)}


def _ssm_update_bwd_example():
    (xc, dt, B, C, A, h), _ = _ssm_update_example()
    return _cotangents(np.random.RandomState(3), xc.shape, h.shape) + (
        xc, dt, B, C, A, h), {}


@tunable(
    "ssm_update_bwd",
    space=SSM_UPDATE_BWD_SPACE,
    reference=ref.ssm_update_bwd,
    heuristic=_ssm_update_bwd_heuristic,
    dispatch=DispatchSpec(example=_ssm_update_bwd_example,
                          data_parallel_args=(0, 1, 2, 3, 4, 5, 7),
                          # the reference's VJP: grad-of-grad differentiates through
                          vjp="reference"),
)
def ssm_update_bwd(ct_y, ct_h, xc, dt, B, C, A, h, *, block_d: int):
    """The decode update's VJP in ``block_d``-channel strips of d_inner (the
    working-set knob): (d_xc, d_dt, d_B, d_C, d_A, d_h), d_B and d_C summed
    across strips."""
    di = xc.shape[1]
    bd = max(1, min(int(block_d), di))
    strips = [ref.ssm_update_bwd(ct_y[:, lo:lo + bd], ct_h[:, lo:lo + bd], xc[:, lo:lo + bd],
                                 dt[:, lo:lo + bd], B, C, A[lo:lo + bd], h[:, lo:lo + bd])
              for lo in range(0, di, bd)]
    cat = lambda i, dim: torch.cat([g[i] for g in strips], dim=dim)
    return (cat(0, 1), cat(1, 1), sum(g[2] for g in strips), sum(g[3] for g in strips),
            cat(4, 0), cat(5, 1))
