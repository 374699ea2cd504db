"""Variant evaluation and the correctness gate.

The tuner's loop is: run the variant, hold its output against the
reference, time it. :func:`correctness_gate` is the hold, with the rules of
``repro.core.evaluate``; :class:`WallClockEvaluator` is the run and the
timing, with CUDA events on the card and the host clock on the CPU.

The gate compares with torch on the tensors' own device: nothing is copied
to the host. A variant whose launch the card refuses (a tile that asks for
too many threads, registers or too much shared memory) is pruned with its
reason, as the JAX evaluator prunes a variant that fails to compile. Any
other error propagates: a fault inside a kernel is a bug, not a slow
config.

:class:`CostModelEvaluator` scores a variant without launching it: the
lower bound :func:`roofline_from_launch` puts on one call from the kernel's
launch models (:mod:`repro_torch.core.gridmodel`) and the analytic site
model (:mod:`repro_torch.tools.analytic`), the counterpart of JAX's
``roofline_from_compiled``, which reads XLA's cost analysis of a compiled
program the port does not have. A launch's collective term is 0 (no kernel
communicates); :func:`collective_stats`, the counterpart of JAX's HLO
parser, reports what a run's collectives moved by kind, from the counts
:mod:`repro_torch.distributed.collectives` keeps, for
``tools.analytic.analytic_roofline`` to price.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# (rtol, atol) by dtype; atol is scaled by max(1, max|reference|).
_TOL = {
    torch.float32: (1e-5, 1e-5),
    torch.bfloat16: (2e-2, 2e-2),
    torch.float16: (1e-2, 1e-2),
}


def tolerance_for(dtype) -> Tuple[float, float]:
    return _TOL.get(dtype, (1e-5, 1e-5))


def _structure(tree) -> Any:
    """The container skeleton of a tree of tensors (leaves become '*')."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    if tree is None:
        return ("none",)
    return "*"


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if tree is None:
        return []
    return [tree]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def correctness_gate(out, ref, rtol: Optional[float] = None,
                     atol: Optional[float] = None) -> bool:
    """True iff ``out`` matches the reference tree within dtype tolerance.

    A different tree structure fails, even with equal leaf counts. A NaN in
    ``out`` where the reference is finite fails; NaNs where the reference
    has them pass. The coarser of the two leaves' dtypes decides the
    tolerance, before both are upcast to float32 for the comparison. The
    absolute tolerance scales with ``max(1, max|ref|)`` over the finite
    reference values. Zero-size leaves pass.
    """
    if _structure(out) != _structure(ref):
        return False
    for o, r in zip(_leaves(out), _leaves(ref)):
        o, r = _as_tensor(o), _as_tensor(r)
        if rtol is not None:
            rt, at = rtol, atol
        else:
            rt_o, at_o = tolerance_for(o.dtype)
            rt_r, at_r = tolerance_for(r.dtype)
            rt, at = max(rt_o, rt_r), max(at_o, at_r)
        if o.shape != r.shape:
            return False
        if not r.numel():
            continue
        o = o.to(r.device, torch.float32)
        r = r.float()
        finite = r[torch.isfinite(r)]
        scale = max(1.0, float(finite.abs().max()) if finite.numel() else 0.0)
        if bool((torch.isnan(o) & ~torch.isnan(r)).any()):
            return False
        if not torch.allclose(o, r, rtol=rt or 1e-5, atol=(at or 1e-5) * scale,
                              equal_nan=True):
            return False
    return True


# cudaErrorInvalidValue (a tile or size the entry point or the runtime
# refuses, shared memory past the opt-in limit included),
# cudaErrorLaunchOutOfResources (registers), cudaErrorInvalidConfiguration
# (threads or grid): the launch never ran, so the config is illegal here.
REFUSED_LAUNCH_CODES = frozenset({1, 7, 9})


def refused_launch(err: BaseException) -> bool:
    """Whether ``err`` is a launch the card refused (see ``_build.check``)."""
    from ..kernels._build import CudaError

    return isinstance(err, CudaError) and err.code in REFUSED_LAUNCH_CODES


@dataclasses.dataclass
class Measurement:
    objective: float             # seconds, lower is better; inf on failure
    ok: bool
    error: Optional[str] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Evaluator:
    name = "base"

    def evaluate(self, fn: Callable, args: Sequence[Any], reference=None) -> Measurement:
        raise NotImplementedError


def _device_of(args: Sequence[Any]) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


class WallClockEvaluator(Evaluator):
    """Median of ``repeats`` timed calls of the variant, after ``warmup``.

    On the card each call is timed by a pair of CUDA events on the current
    stream; on the CPU by the host clock. The first call's output is held
    against ``reference`` before any timing.
    """

    name = "wallclock"

    def __init__(self, repeats: int = 5, warmup: int = 2, rtol=None, atol=None):
        self.repeats = repeats
        self.warmup = warmup
        self.rtol = rtol
        self.atol = atol

    def evaluate(self, fn: Callable, args: Sequence[Any], reference=None) -> Measurement:
        device = _device_of(args)
        try:
            out = fn(*args)
        except RuntimeError as e:
            if not refused_launch(e):
                raise
            return Measurement(math.inf, False,
                               error=f"refused launch (CUDA error {e.code}): {e}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if reference is not None and not correctness_gate(out, reference, self.rtol,
                                                          self.atol):
            return Measurement(math.inf, False, error="correctness gate failed")
        del out
        for _ in range(self.warmup):
            fn(*args)
        times = (self._cuda_times(fn, args, device) if device.type == "cuda"
                 else self._host_times(fn, args))
        times.sort()
        return Measurement(times[len(times) // 2], True,
                           meta={"times": times, "best": times[0]})

    def _cuda_times(self, fn, args, device) -> List[float]:
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(self.repeats)]
        torch.cuda.synchronize(device)
        for start, end in events:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize(device)
        return [start.elapsed_time(end) / 1e3 for start, end in events]

    def _host_times(self, fn, args) -> List[float]:
        times = []
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
        return times


# ---------------------------------------------------------------------------
# The cost model: a lower bound from launch models and the analytic terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineTerms:
    """The roofline terms of one call, in seconds: compute, memory and (0 on
    one card) collective from its launches, and the analytic site model's
    bound (``analytic_s``), the floor under all of them."""

    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes: float
    collective_bytes: float
    chips: int
    analytic_s: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s, "analytic": self.analytic_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound time: the largest term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s, self.analytic_s)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self) | {"dominant": self.dominant,
                                           "step_time_s": self.step_time_s}


def collective_stats(counts: Optional[Dict[str, Dict[str, int]]] = None) -> Dict[str, Any]:
    """``{"bytes_by_kind", "total_bytes", "count"}`` of the collectives run:
    JAX's ``collective_stats`` record, from the collectives' own counts
    (``counts`` as ``collectives.collective_counts()`` gives them, by
    default the live ones) where JAX parses compiled HLO. Bytes are each
    collective's payload (an all-reduce's reduced tensor, a ring hop's
    chunk), as JAX counts result shapes."""
    if counts is None:
        from ..distributed.collectives import collective_counts

        counts = collective_counts()
    by_kind = dict(counts.get("bytes_by_kind", {}))
    return {"bytes_by_kind": by_kind, "total_bytes": sum(by_kind.values()),
            "count": sum(counts.get("calls_by_kind", {}).values())}


def price_launches(models, profile) -> RooflineTerms:
    """Compute and memory terms of a sequence of launches on ``profile``.

    Compute: each launch's FLOPs (of its padded tiles) at the peak its route
    runs at (``bf16`` tensor cores or ``fp32`` SIMT cores); where every block
    does the same work, the busiest SM holds ``ceil(blocks / SMs)`` of them,
    so a partial last wave costs a whole one. Memory: each input read once
    and each output written once, plus the split-k partials that cannot stay
    in L2 (written, then read back)."""
    compute = memory = flops = nbytes = 0.0
    for m in models:
        peak = profile.peak_flops_bf16 if m.peak == "bf16" else profile.peak_flops_fp32
        f = m.flops
        if m.uniform and m.blocks > 0:
            f = m.flops / m.blocks * math.ceil(m.blocks / profile.sm_count) * profile.sm_count
        spill = 2.0 * max(0.0, m.workspace - profile.l2_bytes)
        compute += f / peak
        memory += (m.bytes + spill) / profile.hbm_bandwidth
        flops += m.flops
        nbytes += m.bytes + spill
    return RooflineTerms(compute_s=compute, memory_s=memory, collective_s=0.0, flops=flops,
                         bytes=nbytes, collective_bytes=0.0, chips=1)


def site_dtype(shapes, dtypes) -> str:
    """The dtype the analytic site model prices a call at: its largest
    argument's (the logits of the cross entropy's backward, not its fp32
    cotangent), the first of equals."""
    if not isinstance(dtypes, (tuple, list)):
        return str(dtypes).replace("torch.", "")
    sizes = [math.prod(s) for s in shapes]
    return str(dtypes[sizes.index(max(sizes))]).replace("torch.", "")


def roofline_from_launch(kernel: str, config: Dict[str, Any], shapes, dtypes,
                         profile=None,
                         call_kwargs: Optional[Dict[str, Any]] = None) -> RooflineTerms:
    """The lower bound on one call of ``kernel`` at ``config``: its launch
    models' terms (:func:`price_launches`), floored by the analytic site
    model (``tools.analytic.site_roofline_seconds`` at :func:`site_dtype`'s
    dtype). It depends on the config through the padded tiles, split-k's
    partials and the waves. Raises ``ValueError`` where the kernel has no
    launch model for the call."""
    from ..tools.analytic import site_roofline_seconds
    from .gridmodel import build_models
    from .platform import H100_SXM

    profile = profile or H100_SXM
    models = build_models(kernel, config, shapes, dtypes, call_kwargs)
    if models is None:
        raise ValueError(f"{kernel}: no launch model for {config} at {shapes}")
    terms = price_launches(models, profile)
    terms.analytic_s = site_roofline_seconds(kernel, tuple(map(tuple, shapes)),
                                             site_dtype(shapes, dtypes), profile)
    return terms


class CostModelEvaluator(Evaluator):
    """Scores a variant by its cost model, launching nothing.

    ``fn(*args)`` is a thunk that returns the call's launch models (one
    :class:`~repro_torch.core.gridmodel.LaunchModel` or a tuple of them),
    priced by :func:`price_launches`, or :class:`RooflineTerms` already
    priced (:func:`roofline_from_launch`). The objective is the lower-bound
    time, the largest term: minimizing it minimizes the dominant one."""

    name = "costmodel"

    def __init__(self, profile=None):
        from .platform import H100_SXM

        self.profile = profile or H100_SXM

    def evaluate(self, fn: Callable, args: Sequence[Any] = (), reference=None) -> Measurement:
        from .gridmodel import LaunchModel

        try:
            out = fn(*args)
            if isinstance(out, LaunchModel):
                out = (out,)
            terms = out if isinstance(out, RooflineTerms) else price_launches(out, self.profile)
        except (ValueError, TypeError, KeyError, ZeroDivisionError) as e:
            return Measurement(math.inf, False, error=f"{type(e).__name__}: {e}")
        return Measurement(terms.step_time_s, True, meta={"roofline": terms.to_json()})
