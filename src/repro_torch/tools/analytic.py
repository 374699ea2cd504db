"""First-principles FLOP and device-memory traffic model, per arch, shape
and kernel site: the port of ``repro.tools.analytic``.

Its arithmetic is the JAX package's, copied (the port imports nothing of
``repro``), priced on the :class:`~repro_torch.core.platform.HardwareProfile`
passed in (an H100's by default) where the JAX module prices on TPU peaks.
Three deviations, each the card's:

* **fp32 gemm sites** -- a gemm site (``matmul``, ``matmul_bias_act``,
  ``rmsnorm_matmul``, ``expert_gemm``) in float32 runs gemm.cuh's ``simt``
  route on the SIMT cores, so :func:`site_roofline_seconds` prices its
  FLOPs at ``peak_flops_fp32``; JAX prices every site at the bf16 peak.
* **roofline_fraction** -- divided by the given profile's bf16 peak (JAX's
  divides by TPU v5e's whatever profile it was given).
* **the collective term** -- JAX's wire model: each collective kind's
  bytes times its ring factor (``_WIRE_FACTOR``), over the profile's
  ``interconnect_bandwidth`` (the data sheet's NVLink figure) where JAX
  divides by ICI's. The bytes by kind come from the port's collectives'
  counts (``core.evaluate.collective_stats``), where JAX parses them from
  the compiled HLO.

Conventions: FLOPs count multiply-adds as 2; byte counts are per device;
``T`` is the tokens processed (B*S for train/prefill, B for one decode
step). The defaults are the one-card ones: ``chips=1``, ``model_par=1``,
``remat="none"``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

from ..configs.base import ArchConfig, LayerSpec, ShapeSpec
from ..core.platform import H100_SXM, HardwareProfile

# Backward pass costs 2× forward (grad wrt activations + weights); remat
# adds recompute of the forward inside backward.
_BWD_MULT = {"none": 3.0, "dots": 3.3, "full": 4.0}

# Activation HBM-traffic coefficient: bytes moved per (token × d_model) per
# layer, in units of activation dtype bytes. Counts residual read/write (4),
# norm read/write (2), mixer in/out (2), ffn in/out (2) ≈ 10; MoE adds the
# dispatch/combine buffers (+4); SSM mixers stream state chunks (+2).
_ACT_COEFF = {"dense": 10.0, "moe": 14.0, "ssm": 12.0}


def _ffn_mats(kind: str) -> int:
    return 3 if kind in ("swiglu", "geglu") else 2


def _layer_fwd_flops(cfg: ArchConfig, spec: LayerSpec, T: float, ctx: float) -> float:
    """Forward FLOPs of one layer over T tokens with ctx effective context."""
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.num_heads, cfg.num_kv_heads
    f = 0.0
    if spec.mixer == "attn":
        f += 2 * T * d * 2 * hd * (H + KV)            # qkvo projections
        eff = min(spec.window, ctx) if spec.window else ctx
        f += 2 * T * eff * H * hd * 2                  # qk^T + p@v
    elif spec.mixer == "mamba":
        di = cfg.mamba_expand * d
        ds = cfg.mamba_d_state
        dtr = max(1, math.ceil(d / 16))
        f += 2 * T * d * 2 * di                        # in_proj
        f += 2 * T * di * 4                            # conv (k=4 taps)
        f += 2 * T * di * (dtr + 2 * ds)               # x_proj
        f += 2 * T * dtr * di                          # dt_proj
        f += 12 * T * di * ds                          # scan + C reduce
        f += 2 * T * di * d                            # out_proj
    elif spec.mixer == "mlstm":
        di = 2 * d
        hdm = di // cfg.num_heads
        c = 64                                          # chunk (run default)
        f += 2 * T * d * 2 * di + 3 * 2 * T * di * di  # in_proj + qkv
        f += 4 * T * c * di                             # intra-chunk
        f += 8 * T * di * hdm                           # inter + state update
        f += 2 * T * di * d                             # out_proj
    elif spec.mixer == "slstm":
        hd_s = d // cfg.num_heads
        ff_s = ((4 * d // 3 + 63) // 64) * 64
        f += 2 * T * d * 4 * d                          # gate projections
        f += 2 * T * d * 4 * hd_s                       # block-diag recurrence
        f += 20 * T * d                                 # cell element-wise
        f += 2 * T * d * ff_s * 3                       # post-GeGLU MLP
    # FFN
    if spec.ffn != "none":
        mats = _ffn_mats(cfg.ffn_kind)
        if "moe" in spec.ffn:
            f += 2 * T * d * cfg.num_experts              # router
            f += (2 * T * d * cfg.d_ff * mats
                  * cfg.experts_per_token * cfg.capacity_factor)
        if spec.ffn in ("dense", "moe+dense"):
            f += 2 * T * d * cfg.d_ff * mats
    return f


def _all_layers(cfg: ArchConfig):
    for seg in cfg.segments():
        for _ in range(seg.repeats):
            for spec in seg.pattern:
                yield spec


def step_flops(cfg: ArchConfig, shape: ShapeSpec, remat: str = "none") -> Dict[str, float]:
    """Total math FLOPs of one step (all devices)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        T, ctx = float(B), float(S)
    else:
        T, ctx = float(B) * S, (S + 1) / 2.0
    fwd = sum(_layer_fwd_flops(cfg, spec, T, ctx) for spec in _all_layers(cfg))
    if shape.kind == "train":
        fwd += 2 * T * cfg.d_model * cfg.vocab_size       # lm head
        total = fwd * _BWD_MULT[remat]
    elif shape.kind == "prefill":
        fwd += 2 * B * cfg.d_model * cfg.vocab_size       # last-position logits
        total = fwd
    else:
        fwd += 2 * T * cfg.d_model * cfg.vocab_size
        total = fwd
    return {"fwd": fwd, "total": total}


def step_hbm_bytes(
    cfg: ArchConfig,
    shape: ShapeSpec,
    chips: int = 1,
    model_par: int = 1,
    fsdp: bool = False,
    remat: str = "none",
    fused_xent: bool = False,
    params: Optional[int] = None,
    dtype_bytes: int = 2,
) -> Dict[str, float]:
    """Per-device memory traffic of one step (bytes)."""
    P = params if params is not None else param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    data_par = max(1, chips // model_par)
    p_local = P / model_par * dtype_bytes          # weights touched per chip
    n_opt_local = P / model_par / (data_par if fsdp else 1)

    if shape.kind == "train":
        T_local = B * S / data_par
        w_reads = {"none": 2, "dots": 2, "full": 3}[remat]
        weights = w_reads * p_local
        grads = 2 * 4 * n_opt_local                 # fp32 write + read
        opt = 6 * 4 * n_opt_local + 2 * n_opt_local  # m,v,master r/w + param w
        kind = "moe" if cfg.num_experts else ("ssm" if cfg.family in ("ssm", "hybrid") else "dense")
        acts = (
            cfg.num_layers * T_local * cfg.d_model * dtype_bytes * _ACT_COEFF[kind]
        )
        # logits are vocab-sharded over the model axis (lm_head P(None,model))
        logits = (
            0.0 if fused_xent
            else 4 * T_local * cfg.vocab_size / model_par * dtype_bytes
        )
        total = weights + grads + opt + acts + logits
        return {
            "weights": weights, "grads": grads, "opt": opt,
            "activations": acts, "logits": logits, "total": total,
        }

    if shape.kind == "prefill":
        T_local = B * S / data_par
        kind = "moe" if cfg.num_experts else ("ssm" if cfg.family in ("ssm", "hybrid") else "dense")
        weights = p_local
        acts = cfg.num_layers * T_local * cfg.d_model * dtype_bytes * (
            _ACT_COEFF[kind] * 0.6  # no backward traffic
        )
        cache = _cache_bytes(cfg, B, S, chips, model_par)
        total = weights + acts + cache
        return {"weights": weights, "activations": acts, "cache": cache, "total": total}

    # decode: weight streaming + cache read/write dominate
    frac_experts = 1.0
    if cfg.num_experts:
        frac_experts = min(1.0, B * cfg.experts_per_token / cfg.num_experts)
    # split params into expert vs non-expert for the read fraction
    total_p = P
    if cfg.num_experts:
        expert_p = total_p - active_param_count(cfg)
        expert_p = expert_p / (1 - cfg.experts_per_token / cfg.num_experts)
        non_expert = total_p - expert_p
        read_p = non_expert + expert_p * frac_experts
    else:
        read_p = total_p
    weights = read_p / model_par * dtype_bytes
    cache = 2 * _cache_bytes(cfg, B, S, chips, model_par)   # read + write slot
    total = weights + cache
    return {"weights": weights, "cache": cache, "total": total}


def _cache_bytes(cfg: ArchConfig, B: int, S: int, chips: int, model_par: int,
                 dtype_bytes: int = 2) -> float:
    """Per-chip bytes of the full KV/state cache."""
    total = 0.0
    for spec in _all_layers(cfg):
        if spec.mixer == "attn":
            clen = min(spec.window, S) if spec.window else S
            total += 2 * B * clen * cfg.num_kv_heads * cfg.hd * dtype_bytes
        elif spec.mixer == "mamba":
            di = cfg.mamba_expand * cfg.d_model
            total += B * di * (cfg.mamba_d_state + 3) * 4
        elif spec.mixer == "mlstm":
            di = 2 * cfg.d_model
            hd = di // cfg.num_heads
            total += B * cfg.num_heads * (hd * hd + hd + 1) * 4
        elif spec.mixer == "slstm":
            total += 4 * B * cfg.d_model * 4
    # cache shards over batch (data axes) and kv/feature (model axis) dims —
    # i.e. over all chips (see distributed.sharding.cache_shardings)
    return total / chips


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "int64": 8}


def _prod(seq) -> float:
    out = 1.0
    for x in seq:
        out *= x
    return out


def site_roofline_seconds(
    kernel: str,
    arg_shapes: Tuple[Tuple[int, ...], ...],
    dtype: str,
    profile: HardwareProfile,
) -> float:
    """max(FLOP time, memory time) of one execution of a single kernel site.

    The per-site counterpart of the whole-step model above (same modelling
    discipline: multiply-add = 2 FLOPs, explicit byte counts), specialized
    to the tuned kernel families. The campaign scheduler prices jobs with it
    (seconds-at-stake ordering), the drift detector uses it as the hardware
    bound a tuned record is attributed against (%-of-roofline), and
    ``core.evaluate.roofline_from_launch`` takes it as the floor of a
    config's price. A float32 gemm's FLOPs run at the fp32 peak
    (:func:`site_peak`).
    """
    flops, mem = site_terms(kernel, arg_shapes, dtype)
    return max(flops / site_peak(kernel, dtype, profile), mem / profile.hbm_bandwidth)


def site_terms(kernel: str, arg_shapes: Tuple[Tuple[int, ...], ...],
               dtype: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of one execution of a kernel site, the terms
    :func:`site_roofline_seconds` prices (multiply-add = 2 FLOPs)."""
    sh = arg_shapes
    dt = _DTYPE_BYTES.get(dtype, 4)
    if kernel == "matmul" and len(sh) >= 2 and len(sh[0]) == 2:
        m, k = sh[0]
        n = sh[1][1]
        flops = 2.0 * m * k * n
        mem = (m * k + k * n + m * n) * dt
    elif kernel == "rmsnorm":
        rows, d = sh[0]
        flops = 4.0 * rows * d                       # square, mean, rsqrt-mul, scale
        mem = 2.0 * rows * d * dt                    # one read + one write
    elif kernel == "rmsnorm_bwd":
        rows, d = sh[0]                              # ct leads, x-shaped
        # saved inv-rms residual: no norm recompute, one reduction + dx combine
        flops = 6.0 * rows * d
        mem = 3.0 * rows * d * dt                    # ct + x read, dx write
    elif kernel == "softmax_xent":
        rows, vocab = sh[0]
        flops = 6.0 * rows * vocab                   # max/exp/sum + label gather
        mem = rows * vocab * dt                      # single streamed read
    elif kernel == "softmax_xent_bwd":
        rows, vocab = sh[1]                          # ct[rows] leads; logits 2nd
        # saved lse residual: (p − onehot)·ct in a single logits pass
        flops = 5.0 * rows * vocab
        mem = 2.0 * rows * vocab * dt                # one logits read + dl write
    elif kernel in ("flash_attention", "attn_chunks"):
        b, h, s, hd = sh[0]
        flops = 2.0 * 2.0 * b * h * s * (s / 2.0) * hd   # qk^T + p@v, causal half
        mem = (sum(_prod(x) for x in sh) + _prod(sh[0])) * dt  # q,k,v read + o write
    elif kernel == "flash_attention_bwd":
        b, h, s, hd = sh[0]                          # ct leads, q-shaped
        # residual-threaded: dq + dkv passes rebuild p from the saved lse —
        # the forward-recompute pass is gone: ~2× fwd
        flops = 4.0 * 2.0 * b * h * s * (s / 2.0) * hd
        mem = (2.0 * sum(_prod(x) for x in sh[1:4]) + 4.0 * _prod(sh[0])) * dt
    elif kernel == "matmul_bias_act" and len(sh) >= 2 and len(sh[0]) == 2:
        m, k = sh[0]                                 # gemm + fused epilogue:
        n = sh[1][1]                                 # bias add + activation
        flops = 2.0 * m * k * n + 4.0 * m * n
        mem = (m * k + k * n + n + m * n) * dt       # no [m, n] round-trip
    elif kernel == "rmsnorm_matmul" and len(sh) >= 3 and len(sh[2]) == 2:
        rows, d = sh[0]                              # fused norm epilogue on
        n = sh[2][1]                                 # the gemm's x operand
        flops = 2.0 * rows * d * n + 4.0 * rows * d
        mem = (rows * d + d + d * n + rows * n) * dt  # x read once, no xn trip
    elif kernel == "expert_gemm" and len(sh) >= 2 and len(sh[0]) == 3:
        e, c, k = sh[0]                              # grouped matmul roofline
        n = sh[1][2]
        flops = 2.0 * e * c * k * n
        mem = e * (c * k + k * n + c * n) * dt
    elif kernel in ("ssm_scan", "ssm_scan_bwd"):
        # Selective scan: per step, one dA/dBx coefficient build + one
        # state update + one C-contraction over [di, ds] (~6 fp32 ops per
        # h element).
        off = 2 if kernel == "ssm_scan_bwd" else 0   # ct_y, ct_h lead in bwd
        b, s, di = sh[off]
        ds_ = sh[off + 2][2]
        flops = 6.0 * b * s * di * ds_
        mem = (sum(_prod(x) for x in sh) + 2.0 * _prod(sh[off])) * 4
        if kernel == "ssm_scan_bwd":                 # fwd recompute + grads
            flops *= 3.0
            mem *= 2.0
    elif kernel in ("ssm_update", "ssm_update_bwd"):
        off = 2 if kernel == "ssm_update_bwd" else 0
        b, di = sh[off]
        ds_ = sh[off + 2][1]
        flops = 6.0 * b * di * ds_
        mem = (sum(_prod(x) for x in sh) + _prod(sh[-1])) * 4
        if kernel == "ssm_update_bwd":
            flops *= 3.0
            mem *= 2.0
    else:
        elems = sum(_prod(s) for s in sh)
        flops = 2.0 * elems
        mem = elems * dt * 2
    return flops, mem


# The gemm family: in float32 each runs gemm.cuh's SIMT route (no TF32).
SIMT_GEMMS = ("matmul", "matmul_bias_act", "rmsnorm_matmul", "expert_gemm")


def site_peak(kernel: str, dtype: str, profile: HardwareProfile) -> float:
    """The FLOP rate a site runs at: the tensor cores' bf16 peak, or the
    SIMT cores' fp32 peak for a float32 gemm (the ``simt`` route)."""
    if kernel in SIMT_GEMMS and dtype == "float32":
        return profile.peak_flops_fp32
    return profile.peak_flops_bf16


@dataclasses.dataclass
class AnalyticRoofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float
    chips: int
    peak_flops: float = H100_SXM.peak_flops_bf16     # the profile's bf16 peak

    @property
    def dominant(self) -> str:
        t = {"compute": self.compute_s, "memory": self.memory_s,
             "collective": self.collective_s}
        return max(t, key=t.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / compiled-compute FLOPs (per brief §Roofline)."""
        tot = self.flops_per_chip * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful FLOP time / bound step time, ≤ 1."""
        ideal = self.model_flops / self.chips / self.peak_flops
        return min(1.0, ideal / self.step_time_s) if self.step_time_s else 0.0

    def to_json(self) -> Dict:
        return dataclasses.asdict(self) | {
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# Wire-byte factor per collective kind (ring schedules): an all-reduce moves
# about twice the payload a device; gather and scatter kinds about once.
_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def analytic_roofline(
    cfg: ArchConfig,
    shape: ShapeSpec,
    chips: int = 1,
    collective_bytes_by_kind: Optional[Dict[str, float]] = None,
    model_par: int = 1,
    fsdp: bool = False,
    remat: str = "none",
    fused_xent: bool = False,
    profile: HardwareProfile = H100_SXM,
    params: Optional[int] = None,
    active_params: Optional[int] = None,
) -> AnalyticRoofline:
    """The step's three roofline terms on ``profile``: its FLOPs at the bf16
    peak, its memory traffic at the memory rate, and its collectives' wire
    bytes (``collective_bytes_by_kind``, payload bytes a device by kind)
    at the interconnect rate."""
    wire = sum(v * _WIRE_FACTOR.get(k, 1.0)
               for k, v in (collective_bytes_by_kind or {}).items())
    n_active = active_params if active_params is not None else active_param_count(cfg)
    fl = step_flops(cfg, shape, remat)
    hbm = step_hbm_bytes(cfg, shape, chips, model_par, fsdp, remat, fused_xent, params=params)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    return AnalyticRoofline(
        compute_s=fl["total"] / chips / profile.peak_flops_bf16,
        memory_s=hbm["total"] / profile.hbm_bandwidth,
        collective_s=wire / profile.interconnect_bandwidth,
        flops_per_chip=fl["total"] / chips,
        hbm_bytes_per_chip=hbm["total"],
        collective_bytes_per_chip=wire,
        model_flops=model_flops,
        chips=chips,
        peak_flops=profile.peak_flops_bf16,
    )


def _numel(tree) -> int:
    if hasattr(tree, "numel"):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return sum(_numel(v) for v in tree)


@functools.lru_cache(maxsize=64)
def param_count(cfg: ArchConfig) -> int:
    """Parameters of the arch, counted on its abstract (meta) tree (once a
    config: a full-size tree takes a second or more to lay out)."""
    from ..models import lm

    return lm.param_count(cfg)


@functools.lru_cache(maxsize=64)
def active_param_count(cfg: ArchConfig) -> int:
    """Parameters a token uses: all but the experts' (the router stays) past
    its top-k of them, as ``repro.models.lm.active_param_count`` counts."""
    total = param_count(cfg)
    if not cfg.num_experts:
        return total
    from ..models import lm

    expert = 0

    def walk(t):
        nonlocal expert
        if isinstance(t, dict):
            for k, v in t.items():
                if k == "moe":
                    expert += sum(_numel(vv) for kk, vv in v.items() if kk != "router")
                else:
                    walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(lm.abstract_params(cfg))
    return int(total - expert * (1 - cfg.experts_per_token / cfg.num_experts))
