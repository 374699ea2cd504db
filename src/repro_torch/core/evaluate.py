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

``CostModelEvaluator`` (XLA's cost analysis of a compiled program) has no
counterpart here yet.
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
