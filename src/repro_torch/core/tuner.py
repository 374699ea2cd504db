"""The tuner: space x search x evaluator -> the best correct variant, and
the database keys of tunable calls.

The loop of ``repro.core.tuner.autotune``:

  1. the tunable's reference runs once on the call's device, giving the
     outputs every variant is held against;
  2. the search proposes configs (``seed_configs`` first: transfer tuning);
  3. each config is bound to a variant, run, held against the reference
     (the correctness gate) and timed; a refused launch or a gate failure
     prunes it;
  4. the best survivor, or the heuristic config when the budget did not
     beat it, is written to the database under the call's key.

All of it runs under ``torch.no_grad()`` and calls the bound variants
directly, never through the dispatch runtime's autograd plane. Before the
search, a static pre-pass asks the kernel's launch models
(:mod:`repro_torch.core.gridmodel`) which configs the device cannot launch
at the call's shapes (shared memory, threads, tensor-core tiles, and any
race or coverage fault), as JAX's pre-pass asks its TPU grid models; such a
config is pruned before any trial, its trial's ``pruned`` reason led by the
verdict's category, and the record counts them (``static_pruned``). Where
legality depends on the call's shapes, the tunable's ``legal`` check (the
flash kernels' tiles at head dim 256) says the same to the runtime's tiers.

Keys must read exactly as the JAX package writes them, so dtypes are
spelled the JAX way (``bfloat16``, never ``torch.bfloat16``) and the key
dtype is the promotion of every array argument's dtype by JAX's rules.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Any, Dict, Optional, Sequence

import torch

from .annotate import Tunable
from .database import Record, TuningDatabase, make_key, now
from .evaluate import Evaluator, WallClockEvaluator
from .params import Config, ParamSpace
from .platform import platform_key
from .search import CoordinateDescent, SearchAlgorithm, SearchResult, Trial
from .search.base import INVALID

log = logging.getLogger("repro_torch.tuner")

_JAX_NAMES = {
    torch.float32: "float32",
    torch.float64: "float64",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.int8: "int8",
    torch.int16: "int16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.uint8: "uint8",
    torch.bool: "bool",
}


def dtype_name(dtype: torch.dtype) -> str:
    """JAX's spelling of a torch dtype (``torch.bfloat16`` -> ``bfloat16``)."""
    try:
        return _JAX_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no JAX dtype name for {dtype}") from None


@functools.lru_cache(maxsize=512)
def _promote(dtypes: tuple) -> torch.dtype:
    out = dtypes[0]
    for d in dtypes[1:]:
        # torch's promotion agrees with JAX's on the types the port keys:
        # bf16 x f32 -> f32, bf16 x f16 -> f32, int32 x f32 -> f32,
        # int32 x bf16 -> bf16.
        out = torch.promote_types(out, d)
    return out


def promoted_dtype(dtypes: Sequence[Any]) -> str:
    """Order-independent key dtype: the promotion of all array dtypes
    (torch dtypes, or their JAX names such as ``"bfloat16"``)."""
    if not dtypes:
        return "f32"
    return dtype_name(_promote(tuple(getattr(torch, d) if isinstance(d, str) else d
                                     for d in dtypes)))


def _args_key(tunable: Tunable, args: Sequence[Any], platform: str,
              extra: str = "") -> str:
    """Database key for (tunable, tensor args) on ``platform``."""
    shapes, dtypes = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            shapes.append(tuple(a.shape))
            dtypes.append(a.dtype)
    return make_key(tunable.name, platform, shapes, promoted_dtype(dtypes), extra)


def first_device(args: Sequence[Any]) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def static_illegal(tunable: Tunable, args: Sequence[Any]) -> Dict[str, str]:
    """config_key -> "category: reason" for every config of the tunable's
    space that its launch models refuse at these tensors' shapes and dtypes
    on their device (empty for a tunable with no launch model)."""
    from .gridmodel import space_illegal
    from .platform import detect_platform

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors:
        return {}
    profile = detect_platform(tensors[0].device)
    return {ck: f"{cat}: {reason}" for ck, (cat, reason) in space_illegal(
        tunable.name, profile, [tuple(t.shape) for t in tensors],
        [t.dtype for t in tensors]).items()}


@dataclasses.dataclass
class TuningResult:
    best_config: Config
    best_objective: float
    default_objective: float          # the heuristic config's time
    evaluations: int
    search: SearchResult


def autotune(
    tunable: Tunable,
    args: Sequence[Any],
    search: Optional[SearchAlgorithm] = None,
    evaluator: Optional[Evaluator] = None,
    db: Optional[TuningDatabase] = None,
    key_extra: str = "",
    save: bool = True,
    seed_configs: Optional[Sequence[Config]] = None,
    platform: Optional[str] = None,
    call_kwargs: Optional[Dict[str, Any]] = None,
) -> TuningResult:
    """Tune ``tunable`` on the concrete tensors ``args`` and bank the winner.

    ``db`` defaults to the active runtime's database and ``platform`` to the
    platform of the tensors' device. ``call_kwargs`` (``act=...``,
    ``causal=...``) go to every variant and to the reference, so the search
    measures the function the call site runs; without them both run at the
    tunable's defaults, as the JAX package's tuner does.
    """
    from .runtime import current_runtime

    search = search or CoordinateDescent(budget=48)
    evaluator = evaluator or WallClockEvaluator()
    db = db if db is not None else current_runtime().db
    platform = platform or platform_key(first_device(args))
    kw = dict(call_kwargs or {})

    illegal_static = static_illegal(tunable, args)
    static_pruned = set()

    with torch.no_grad():
        reference = None
        if tunable.reference is not None:
            reference = tunable.reference(*args, **kw)

        def measure(config: Config):
            variant = tunable.variant(**config)
            return evaluator.evaluate(lambda *a: variant(*a, **kw), args, reference=reference)

        def objective(config: Config) -> Trial:
            ck = ParamSpace.config_key(config)
            if ck in illegal_static:
                static_pruned.add(ck)
                log.debug("variant %s statically pruned: %s", config, illegal_static[ck])
                return Trial(config=config, objective=INVALID, ok=False,
                             meta={"pruned": illegal_static[ck]})
            illegal = tunable.why_illegal(config, *args)
            if illegal is not None:
                # the card cannot run it at these shapes: pruned, never launched
                log.debug("variant %s statically pruned: %s", config, illegal)
                return Trial(config=config, objective=INVALID, ok=False,
                             meta={"pruned": illegal})
            m = measure(config)
            meta = dict(m.meta)
            if not m.ok:
                meta["pruned"] = m.error
                log.debug("variant %s pruned: %s", config, m.error)
            return Trial(config=config, objective=m.objective, ok=m.ok, meta=meta)

        t0 = time.perf_counter()
        result = search.run(tunable.space, objective, seeds=tuple(seed_configs or ()))
        elapsed = time.perf_counter() - t0
        if result.best is None:
            raise RuntimeError(f"autotuning {tunable.name}: no valid variant found "
                               f"({result.evaluations} evaluations)")
        # The heuristic config is the untuned program; a budget too small to
        # beat it keeps it as the winner, so tuning never regresses.
        default_cfg = tunable.default_config(*args)
        base = measure(default_cfg)
    default_obj = base.objective if base.ok else INVALID
    best_config, best_objective = result.best_config, result.best_objective
    if base.ok and tunable.why_illegal(default_cfg, *args) is None and \
            default_obj < best_objective:
        best_config, best_objective = dict(default_cfg), default_obj

    key = _args_key(tunable, args, platform, key_extra)
    db.put(Record(key=key, config=best_config, objective=best_objective,
                  evaluator=evaluator.name, evaluations=result.evaluations, timestamp=now(),
                  meta={"search": search.name, "default_objective": default_obj,
                        "search_seconds": elapsed, "static_pruned": len(static_pruned)}),
           save=save)
    log.info("tuned %s: %.3gs -> %.3gs in %d evals", key, default_obj, best_objective,
             result.evaluations)
    return TuningResult(best_config=best_config, best_objective=best_objective,
                        default_objective=default_obj, evaluations=result.evaluations,
                        search=result)


def tune_or_lookup(
    tunable: Tunable,
    args: Sequence[Any],
    db: Optional[TuningDatabase] = None,
    allow_tune: bool = False,
    key_extra: str = "",
    allow_cover: bool = True,
    **tune_kwargs,
) -> Config:
    """Config resolution outside a runtime: an exact record, else a tuning
    run (``allow_tune``), else the nearest cover-set entry, else the shape
    heuristic."""
    from .runtime import current_runtime

    db = db if db is not None else current_runtime().db
    platform = platform_key(first_device(args))
    key = _args_key(tunable, args, platform, key_extra)
    rec = db.lookup(key)
    if rec is not None and tunable.why_illegal(rec.config, *args) is None:
        return dict(rec.config)
    if allow_tune:
        return autotune(tunable, args, db=db, key_extra=key_extra, platform=platform,
                        **tune_kwargs).best_config
    if allow_cover:
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        for entry in db.lookup_cover(tunable.name, platform, shapes):
            cfg = entry.get("config")
            if cfg is not None and tunable.why_illegal(cfg, *args) is None:
                return dict(cfg)
    return tunable.default_config(*args)
