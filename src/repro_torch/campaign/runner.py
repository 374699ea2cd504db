"""Campaign runner: tune the manifest best-first, bank the results, export.

The port of ``repro.campaign.runner``. Each job materializes seeded
tensors on the campaign's device (the card unless the caller asks for the
CPU), takes warm-start seeds from the nearest records, runs the budgeted
search through :func:`repro_torch.core.tuner.autotune` (which writes the
record) and saves the manifest after every job, so a killed campaign
resumes at the first pending job.

One departure from the JAX runner: the call's keyword arguments are read
back from the job's key extra (``asilu`` -> ``act="silu"``, ``cTruew0`` ->
``causal=True, window=0``) and handed to the variants and the reference,
so a fused-activation job is timed and gated with its activation, where the
JAX runner measures every job at the tunable's defaults.

Each attempt is the ``campaign.job:<kernel>`` fault site and, under an
enabled :mod:`repro_torch.obs` collector, a ``campaign.job`` span; a job
records ``campaign.jobs`` by status, ``campaign.job_s`` and
``campaign.speedup`` (heuristic over best) by kernel, and a poisoned job
warns once.

Export clusters the platform's winners into cover sets and writes the
database a deployment ships.

``job_timeout`` bounds each attempt's wall clock, as the JAX runner's
``--job-timeout`` does. The attempt then runs on a thread of its own and
banks its record into a private database, copied into the campaign's only
when it returns in time. A Python thread cannot cancel a CUDA launch, so an
attempt past its time is abandoned still holding the card: it counts as
failed, the job is poisoned with a ``TimeoutError``, and the campaign ends
there, its other jobs pending (``manifest.meta["timed_out"]`` names the
job). A later ``campaign run``, in a fresh process, resumes after it. The
JAX runner goes on to the next job instead, which on one card would launch
beside the abandoned attempt.
"""
from __future__ import annotations

import contextvars
import logging
import re
import signal
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.annotate import get_tunable
from ..core.database import TuningDatabase
from ..core.evaluate import Evaluator, WallClockEvaluator
from ..core.platform import resolve_device
from ..core.runtime import TunedRuntime
from ..core.search import CoordinateDescent, SearchAlgorithm
from ..core.tuner import autotune, promoted_dtype
from ..obs.collect import current_collector as _obs_collector
from ..obs.trace import span as _obs_span
from ..testing.faults import fault_point as _fault_point
from .planner import TuningJob, _register_tunables
from .scheduler import CampaignManifest
from .transfer import compute_covers, warm_start_configs

log = logging.getLogger("repro_torch.campaign")

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def call_kwargs(job: TuningJob) -> Dict[str, Any]:
    """The call's keyword arguments, read back from the job's key extra."""
    if job.kernel == "matmul_bias_act" and job.key_extra.startswith("a"):
        return {"act": job.key_extra[1:]}
    if job.kernel == "matmul" and job.key_extra == "o32":
        return {"out": "float32"}
    m = re.fullmatch(r"c(True|False)w(\d+)", job.key_extra)
    if job.kernel in ("flash_attention", "flash_attention_bwd") and m:
        return {"causal": m.group(1) == "True", "window": int(m.group(2))}
    return {}


# (dt arg, A arg) of each selective-scan job: the backward jobs lead with
# the two cotangents, which shifts the forward's args right by two.
SSM_COEFFS = {"ssm_scan": (1, 4), "ssm_update": (1, 4),
              "ssm_scan_bwd": (3, 6), "ssm_update_bwd": (3, 6)}


def _float_tensor(t: np.ndarray, dtype: str, device) -> torch.Tensor:
    """``jnp.asarray(t, dtype)`` for a float64 draw: with 64-bit mode off,
    JAX narrows float64 to float32 and then rounds to the target type. The
    port takes the same two steps explicitly (numpy's float32 cast, then
    torch's round-to-nearest-even from float32), not torch's float64 path."""
    return torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32)).to(
        _TORCH_DTYPES[dtype]).to(device)


def materialize_args(job: TuningJob, seed: int = 0, device=None):
    """Seeded tensors for one job, equal to ``repro``'s for the same seed.

    Float args are unit gaussians (attention operands scaled by 0.3),
    integer args labels drawn against the first >= 2-D arg's last dim (the
    vocabulary). The selective scan's jobs draw their coefficients in the
    ranges the mixer gives: dt a small positive step (``|t| * 0.1 +
    0.01``), A a stable decay rate (``-|t| - 0.1``), every other float arg
    scaled by 0.3; unit draws would overflow the state within a few dozen
    steps. The backward jobs' residual operands are derived from their
    primal args, as the forward would have saved them: the rmsnorm inverse
    rms, the cross entropy lse, the attention output and lse.
    """
    return place_args(job, host_args(job, seed), device)


def host_args(job: TuningJob, seed: int = 0) -> List[torch.Tensor]:
    """:func:`materialize_args`' seeded draws on the host, each in its
    dtype, before the device copy and the derived residuals. numpy's draws
    and torch's casts release the GIL, so a replay can draw the next jobs'
    arguments on threads while the card times this one."""
    # crc32, not hash(): str hashes are salted per process.
    rs = np.random.RandomState(seed ^ (zlib.crc32(job.kernel.encode()) & 0xFFFF))
    hi = max(2, max((int(s[-1]) for s in job.arg_shapes if len(s) >= 2), default=2))
    attn_like = ("flash_attention", "flash_attention_bwd", "attn_chunks")
    args = []
    for i, (shape, dtype) in enumerate(zip(job.arg_shapes, job.arg_dtypes)):
        if dtype.startswith("int") or dtype.startswith("uint"):
            args.append(torch.from_numpy(rs.randint(0, hi, size=shape).astype(np.int32)))
            continue
        t = rs.randn(*shape)
        if job.kernel in SSM_COEFFS:
            dt_i, a_i = SSM_COEFFS[job.kernel]
            if i == dt_i:
                t = np.abs(t) * 0.1 + 0.01
            elif i == a_i:
                t = -np.abs(t) - 0.1
            else:
                t = t * 0.3
        elif job.kernel in attn_like:
            t = t * 0.3
        args.append(_float_tensor(t, dtype, "cpu"))
    return args


def place_args(job: TuningJob, args: Sequence[torch.Tensor], device=None) -> tuple:
    """:func:`host_args`' tensors on ``device`` (default the CPU), with the
    backward jobs' residual operands derived there."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return derive_residuals(job, [a.to(device) for a in args])


def derive_residuals(job: TuningJob, args) -> tuple:
    """The backward jobs' residual operands, derived from their primal
    arguments as the forward would have saved them: the rmsnorm inverse rms,
    the cross entropy lse, the attention output and lse."""
    args = list(args)
    if job.kernel == "rmsnorm_bwd" and len(args) >= 4:
        xf = args[1].float()
        args[3] = torch.rsqrt((xf * xf).mean(dim=-1) + 1e-6)
    elif job.kernel == "softmax_xent_bwd" and len(args) >= 4:
        args[3] = torch.logsumexp(args[1].float(), dim=-1)
    elif job.kernel == "flash_attention_bwd" and len(args) >= 6:
        from ..kernels import ref

        kw = call_kwargs(job) or {"causal": True, "window": 0}
        with torch.no_grad():
            o, lse = ref.attention_res(args[1], args[2], args[3], **kw)
        args[4] = o.to(args[4].dtype)
        args[5] = lse
    return tuple(args)


def _sigterm_to_interrupt(signum, frame):
    raise KeyboardInterrupt("SIGTERM")


class JobTimeout(TimeoutError):
    """An attempt ran past ``job_timeout``; its thread may still hold the card."""


def _run_attempt(body: Callable[[TuningDatabase], Any], db: TuningDatabase,
                 job_timeout: Optional[float]):
    """``body(db)`` in this thread, or, with a timeout, on a daemon thread
    (in a copy of this context, so fault plans, runtimes and collectors
    reach it) banking into a private database that is merged into ``db``
    only when the attempt returns in time. BaseExceptions of the body are
    re-raised here."""
    if job_timeout is None:
        return body(db)
    scratch = TuningDatabase(None)
    box: Dict[str, Any] = {}
    ctx = contextvars.copy_context()

    def run():
        try:
            box["res"] = ctx.run(body, scratch)
        except BaseException as e:  # noqa: BLE001 -- relayed to the caller
            box["exc"] = e

    t = threading.Thread(target=run, daemon=True, name="campaign-job")
    t.start()
    t.join(job_timeout)
    if t.is_alive():
        raise JobTimeout(f"attempt exceeded --job-timeout {job_timeout:g}s")
    if "exc" in box:
        raise box["exc"]
    for rec in scratch.records():
        db.put(rec, save=False)
    db.save()
    return box["res"]


def run_campaign(
    manifest: CampaignManifest,
    db: TuningDatabase,
    evaluator: Optional[Evaluator] = None,
    search_factory: Optional[Callable[[TuningJob], SearchAlgorithm]] = None,
    max_jobs: Optional[int] = None,
    warm_start: bool = True,
    arg_seed: int = 0,
    max_attempts: int = 1,
    device=None,
    job_timeout: Optional[float] = None,
) -> Dict:
    """Tune pending jobs best-first on ``device`` (default: the card);
    returns the manifest's summary.

    ``max_jobs`` bounds this invocation (the rest stays pending: resume).
    ``search_factory`` picks each job's strategy (default: coordinate
    descent at the job's budget). A job whose attempts all raise is
    ``poisoned`` with its error and skipped by later runs. An interrupt
    (Ctrl-C, SIGTERM) saves the manifest with the job in flight still
    pending. An attempt past ``job_timeout`` seconds poisons its job and
    ends the campaign (see the module's docstring).
    """
    _register_tunables()
    device = resolve_device(device)
    evaluator = evaluator or WallClockEvaluator(repeats=3, warmup=1)
    max_attempts = max(1, int(max_attempts))
    ran = 0
    campaign_rt = TunedRuntime(db=db, name="campaign")
    prev_sigterm = None
    if threading.current_thread() is threading.main_thread():
        try:
            prev_sigterm = signal.signal(signal.SIGTERM, _sigterm_to_interrupt)
        except (ValueError, OSError):
            prev_sigterm = None
    interrupted = timed_out = False
    try:
        for job in manifest.pending():
            if max_jobs is not None and ran >= max_jobs:
                break
            ran += 1
            tunable = get_tunable(job.kernel)
            seeds = []
            if warm_start:
                seeds = warm_start_configs(db, job.kernel, manifest.platform, job.arg_shapes,
                                           promoted_dtype(job.arg_dtypes), job.key_extra,
                                           space=tunable.space)
            col = _obs_collector()
            t_job = time.perf_counter()
            while True:
                job.attempts += 1
                search = (search_factory(job) if search_factory
                          else CoordinateDescent(budget=job.budget, restarts=2))
                def body(bank, job=job, tunable=tunable, search=search, seeds=seeds):
                    _fault_point(f"campaign.job:{job.kernel}", attempt=job.attempts)
                    args = materialize_args(job, seed=arg_seed, device=device)
                    with campaign_rt, _obs_span("campaign.job", kernel=job.kernel,
                                                budget=job.budget):
                        return autotune(tunable, args, search=search, evaluator=evaluator,
                                        db=bank, key_extra=job.key_extra, seed_configs=seeds,
                                        platform=manifest.platform,
                                        call_kwargs=call_kwargs(job))

                try:
                    res = _run_attempt(body, db, job_timeout)
                except JobTimeout as e:
                    job.error = f"TimeoutError: {e}"
                    job.status = "poisoned"
                    manifest.meta["timed_out"] = {"key": job.db_key(manifest.platform),
                                                  "seconds": job_timeout, "at": time.time()}
                    col.warn_once("campaign.job_timeout", key=job.db_key(manifest.platform),
                                  kernel=job.kernel, seconds=job_timeout)
                    log.warning("job %s %s timed out after %gs; the campaign stops here",
                                job.kernel, job.arg_shapes, job_timeout)
                    timed_out = True
                    break
                except Exception as e:      # a failed job must not sink the campaign
                    job.error = f"{type(e).__name__}: {e}"
                    if job.attempts < max_attempts:
                        log.warning("job %s %s attempt %d/%d failed (%s); retrying",
                                    job.kernel, job.arg_shapes, job.attempts, max_attempts,
                                    job.error)
                        manifest.save()
                        continue
                    job.status = "poisoned"
                    if col.enabled:
                        col.counter("campaign.jobs", status="poisoned")
                    col.warn_once("campaign.job_poisoned", key=job.db_key(manifest.platform),
                                  kernel=job.kernel, attempts=job.attempts, error=job.error)
                    log.warning("job %s %s poisoned after %d attempt(s): %s", job.kernel,
                                job.arg_shapes, job.attempts, job.error)
                    break
                job.status = "done"
                job.evaluations = res.evaluations
                job.best_objective = res.best_objective
                job.default_objective = res.default_objective
                job.seeded = bool(seeds)
                job.error = ""
                if col.enabled:
                    col.observe("campaign.job_s", time.perf_counter() - t_job,
                                kernel=job.kernel)
                    if res.best_objective > 0 and res.default_objective > 0:
                        col.observe("campaign.speedup",
                                    res.default_objective / res.best_objective,
                                    kernel=job.kernel)
                    col.counter("campaign.jobs", status="done")
                # pruned trials by reason ("correctness gate failed",
                # "refused launch (CUDA error 7)", ...)
                by_reason = manifest.meta.setdefault("pruned", {})
                for t in res.search.trials:
                    if "pruned" in t.meta:
                        reason = t.meta["pruned"].split(":")[0]
                        by_reason[reason] = by_reason.get(reason, 0) + 1
                log.info("job %s %s: %.3g -> %.3g (%d evals%s)", job.kernel, job.arg_shapes,
                         res.default_objective, res.best_objective, res.evaluations,
                         ", seeded" if seeds else "")
                break
            manifest.save()
            if timed_out:
                break
    except KeyboardInterrupt:
        interrupted = True
        log.warning("campaign interrupted; manifest saved with the job in flight pending")
        raise
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        manifest.meta["telemetry"] = _merge_snapshots(manifest.meta.get("telemetry"),
                                                      campaign_rt.telemetry.snapshot())
        if interrupted:
            manifest.meta["interrupted"] = time.time()
        manifest.save()
    return manifest.summary()


def _merge_snapshots(prev: Optional[Dict], new: Dict) -> Dict:
    """Two Telemetry snapshots added up (rates recomputed)."""
    if not prev:
        return new
    out = dict(new)
    for field in ("calls", "cache_hits", "cache_evictions"):
        out[field] = prev.get(field, 0) + new.get(field, 0)
    out["cache_hit_rate"] = out["cache_hits"] / out["calls"] if out.get("calls") else 0.0

    def add(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
        out_ = dict(a)
        for t, n in b.items():
            out_[t] = out_.get(t, 0) + n
        return out_

    out["tiers"] = add(prev.get("tiers", {}), new.get("tiers", {}))
    total = out.get("calls") or 1
    out["tier_rates"] = {t: n / total for t, n in out["tiers"].items()}
    for field in ("by_key", "phases"):
        merged = {k: dict(v) for k, v in prev.get(field, {}).items()}
        for k, per in new.get(field, {}).items():
            merged[k] = add(merged.get(k, {}), per)
        out[field] = merged
    by_kp = {p: {k: dict(v) for k, v in per.items()}
             for p, per in prev.get("by_key_phase", {}).items()}
    for p, per in new.get("by_key_phase", {}).items():
        for k, tiers in per.items():
            by_kp.setdefault(p, {})[k] = add(by_kp.get(p, {}).get(k, {}), tiers)
    out["by_key_phase"] = by_kp
    return out


def summarize_telemetry(snap: Dict) -> Dict:
    """Per-tier rates overall, and per kernel and per phase the calls, the
    tier counts and the exact-hit share (dispatches served by tuned
    records)."""
    calls = snap.get("calls", 0)
    tiers = dict(snap.get("tiers", {}))
    per_kernel: Dict[str, Dict[str, int]] = {}
    for key, per in snap.get("by_key", {}).items():
        agg = per_kernel.setdefault(key.split("|")[0], {})
        for tier, n in per.items():
            agg[tier] = agg.get(tier, 0) + n
    kernels = {}
    for kernel, agg in sorted(per_kernel.items()):
        total = sum(agg.values()) or 1
        kernels[kernel] = {
            "calls": sum(agg.values()),
            "tiers": dict(agg),
            "exact_share": agg.get("exact", 0) / total,
            "measured_share": sum(agg.get(t, 0) for t in ("exact", "tune", "cover", "override"))
            / total,
        }
    phases = {}
    for phase, per in snap.get("phases", {}).items():
        total = sum(per.values()) or 1
        phases[phase] = {"calls": sum(per.values()), "tiers": dict(per),
                         "exact_share": per.get("exact", 0) / total}
    return {
        "calls": calls,
        "tier_rates": {t: n / calls for t, n in tiers.items()} if calls else {},
        "cache_hit_rate": snap.get("cache_hit_rate", 0.0),
        "cache_evictions": snap.get("cache_evictions", 0),
        "kernels": kernels,
        "phases": phases,
    }


def format_telemetry(summary: Dict, label: str) -> str:
    rates = ", ".join(f"{t}={100 * r:.0f}%" for t, r in sorted(summary["tier_rates"].items()))
    lines = [f"dispatch accounting [{label}]: {summary['calls']} dispatches ({rates}); "
             f"cache hit {100 * summary['cache_hit_rate']:.0f}%, "
             f"{summary['cache_evictions']} evictions"]
    for kernel, row in summary["kernels"].items():
        lines.append(f"  {kernel:<20} {row['calls']:>6} calls  exact "
                     f"{100 * row['exact_share']:.0f}%  measured "
                     f"{100 * row['measured_share']:.0f}%")
    for phase, row in sorted(summary.get("phases", {}).items()):
        lines.append(f"  phase {phase:<10} {row['calls']:>6} calls  exact "
                     f"{100 * row['exact_share']:.0f}%")
    return "\n".join(lines)


def export_campaign_db(db: TuningDatabase, out_path: str, platform: str,
                       cover_max_size: int = 4) -> TuningDatabase:
    """Cluster the platform's winners into cover sets, then write the
    one-platform database at ``out_path``."""
    compute_covers(db, platform, max_size=cover_max_size, save=bool(db.path))
    return db.export(out_path, platform=platform)
