"""Campaign scheduler: dedup -> prioritize -> budget -> resumable manifest.

The port of ``repro.campaign.scheduler``, priced on this package's
hardware profiles:

* **dedup** -- jobs that land on one database key merge; their per-step
  weights add and their scenarios union;
* **priority** -- a job's roofline seconds on the card (the larger of its
  FLOP time at the bf16 tensor-core peak and its bytes at the memory rate,
  the per-site model of ``repro.tools.analytic.site_roofline_seconds``)
  times its per-step weight: the seconds at stake. Jobs are tuned
  best-first;
* **budget** -- a global evaluation budget split in proportion to
  priority, with a floor per job;
* **manifest** -- the schedule and each job's state, written atomically
  after every job, so ``campaign run`` resumes where it stopped.

The JAX package's static legality counts (``plan_legality``, from its TPU
grid models) have no counterpart yet.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.database import atomic_write_json
from ..core.platform import H100_SXM, HardwareProfile
from .planner import TuningJob

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "int64": 8}


def _prod(seq) -> float:
    out = 1.0
    for x in seq:
        out *= x
    return out


def site_roofline_seconds(kernel: str, arg_shapes: Tuple[Tuple[int, ...], ...], dtype: str,
                          profile: HardwareProfile) -> float:
    """max(FLOP time, memory time) of one execution of a kernel site
    (multiply-add = 2 FLOPs; ``repro.tools.analytic``'s per-site model)."""
    sh = arg_shapes
    dt = _DTYPE_BYTES.get(dtype, 4)
    if kernel == "matmul" and len(sh) >= 2 and len(sh[0]) == 2:
        m, k = sh[0]
        n = sh[1][1]
        flops = 2.0 * m * k * n
        mem = (m * k + k * n + m * n) * dt
    elif kernel == "rmsnorm":
        rows, d = sh[0]
        flops = 4.0 * rows * d
        mem = 2.0 * rows * d * dt
    elif kernel == "rmsnorm_bwd":
        rows, d = sh[0]
        flops = 6.0 * rows * d
        mem = 3.0 * rows * d * dt
    elif kernel == "softmax_xent":
        rows, vocab = sh[0]
        flops = 6.0 * rows * vocab
        mem = rows * vocab * dt
    elif kernel == "softmax_xent_bwd":
        rows, vocab = sh[1]
        flops = 5.0 * rows * vocab
        mem = 2.0 * rows * vocab * dt
    elif kernel in ("flash_attention", "attn_chunks"):
        b, h, s, hd = sh[0]
        flops = 2.0 * 2.0 * b * h * s * (s / 2.0) * hd
        mem = (sum(_prod(x) for x in sh) + _prod(sh[0])) * dt
    elif kernel == "flash_attention_bwd":
        b, h, s, hd = sh[0]
        flops = 4.0 * 2.0 * b * h * s * (s / 2.0) * hd
        mem = (2.0 * sum(_prod(x) for x in sh[1:4]) + 4.0 * _prod(sh[0])) * dt
    elif kernel == "matmul_bias_act" and len(sh) >= 2 and len(sh[0]) == 2:
        m, k = sh[0]
        n = sh[1][1]
        flops = 2.0 * m * k * n + 4.0 * m * n
        mem = (m * k + k * n + n + m * n) * dt
    elif kernel == "rmsnorm_matmul" and len(sh) >= 3 and len(sh[2]) == 2:
        rows, d = sh[0]
        n = sh[2][1]
        flops = 2.0 * rows * d * n + 4.0 * rows * d
        mem = (rows * d + d + d * n + rows * n) * dt
    elif kernel == "expert_gemm" and len(sh) >= 2 and len(sh[0]) == 3:
        e, c, k = sh[0]
        n = sh[1][2]
        flops = 2.0 * e * c * k * n
        mem = e * (c * k + k * n + c * n) * dt
    elif kernel in ("ssm_scan", "ssm_scan_bwd"):
        off = 2 if kernel == "ssm_scan_bwd" else 0      # the two cotangents lead
        b, s, di = sh[off]
        ds = sh[off + 2][2]
        flops = 6.0 * b * s * di * ds
        mem = (sum(_prod(x) for x in sh) + 2.0 * _prod(sh[off])) * 4
        if kernel == "ssm_scan_bwd":                    # the recompute and the gradients
            flops *= 3.0
            mem *= 2.0
    elif kernel in ("ssm_update", "ssm_update_bwd"):
        off = 2 if kernel == "ssm_update_bwd" else 0
        b, di = sh[off]
        ds = sh[off + 2][1]
        flops = 6.0 * b * di * ds
        mem = (sum(_prod(x) for x in sh) + _prod(sh[-1])) * 4
        if kernel == "ssm_update_bwd":
            flops *= 3.0
            mem *= 2.0
    else:
        elems = sum(_prod(s) for s in sh)
        flops = 2.0 * elems
        mem = elems * dt * 2
    return max(flops / profile.peak_flops_bf16, mem / profile.hbm_bandwidth)


def job_roofline_seconds(job: TuningJob, profile: HardwareProfile) -> float:
    return site_roofline_seconds(job.kernel, job.arg_shapes, job.arg_dtypes[0], profile)


def dedupe_jobs(jobs: Sequence[TuningJob], platform: str) -> List[TuningJob]:
    """Merge jobs that share a database key; weights add, scenarios union."""
    merged: Dict[str, TuningJob] = {}
    for job in jobs:
        key = job.db_key(platform)
        prev = merged.get(key)
        if prev is None:
            merged[key] = dataclasses.replace(job)
        else:
            prev.weight += job.weight
            prev.scenarios = tuple(sorted(set(prev.scenarios) | set(job.scenarios)))
    return sorted(merged.values(), key=lambda j: (j.kernel, j.arg_shapes, j.key_extra))


def prioritize_jobs(jobs: Sequence[TuningJob],
                    profile: HardwareProfile = H100_SXM) -> List[TuningJob]:
    """Rank by seconds at stake: roofline time of one execution times the
    per-step weight, highest first."""
    out = []
    for job in jobs:
        j = dataclasses.replace(job)
        j.priority = job_roofline_seconds(j, profile) * max(j.weight, 1e-9)
        out.append(j)
    out.sort(key=lambda j: (-j.priority, j.kernel, j.arg_shapes, j.key_extra))
    return out


def allocate_budget(jobs: Sequence[TuningJob], total_budget: int, min_budget: int = 6,
                    max_budget: int = 128) -> List[TuningJob]:
    """Split ``total_budget`` evaluations across jobs in proportion to
    priority, each funded job getting at least ``min_budget``. The tail the
    total cannot fund at the floor is deferred (budget 0, kept in the
    manifest)."""
    jobs = list(jobs)
    n_funded = max(0, min(len(jobs), total_budget // min_budget))
    funded, deferred = jobs[:n_funded], jobs[n_funded:]
    total_pri = sum(j.priority for j in funded) or 1.0
    remaining = total_budget - min_budget * len(funded)
    for j in funded:
        extra = int(remaining * (j.priority / total_pri))
        j.budget = min(max_budget, min_budget + extra)
    # Spend what the max_budget clamp and the rounding left, best-first.
    leftover = total_budget - sum(j.budget for j in funded)
    for j in funded:
        if leftover <= 0:
            break
        add = min(max_budget - j.budget, leftover)
        j.budget += add
        leftover -= add
    for j in deferred:
        j.budget = 0
    return funded + deferred


@dataclasses.dataclass
class CampaignManifest:
    """The persisted campaign: schedule plus execution state."""

    path: Optional[str]
    platform: str
    jobs: List[TuningJob]
    created: float = dataclasses.field(default_factory=time.time)
    total_budget: int = 0
    meta: Dict = dataclasses.field(default_factory=dict)

    def save(self) -> None:
        if not self.path:
            return
        atomic_write_json(self.path, {
            "version": 1,
            "platform": self.platform,
            "created": self.created,
            "total_budget": self.total_budget,
            "meta": self.meta,
            "jobs": [j.to_json() for j in self.jobs],
        })

    @staticmethod
    def load(path: str) -> "CampaignManifest":
        with open(path) as f:
            blob = json.load(f)
        return CampaignManifest(
            path=path,
            platform=blob["platform"],
            jobs=[TuningJob.from_json(j) for j in blob["jobs"]],
            created=blob.get("created", 0.0),
            total_budget=blob.get("total_budget", 0),
            meta=blob.get("meta", {}),
        )

    def pending(self) -> List[TuningJob]:
        """Runnable jobs, highest priority first."""
        out = [j for j in self.jobs if j.status == "pending" and j.budget > 0]
        out.sort(key=lambda j: -j.priority)
        return out

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {"pending": 0, "done": 0, "poisoned": 0, "deferred": 0}
        for j in self.jobs:
            if j.status == "pending" and j.budget == 0:
                out["deferred"] += 1
            else:
                out[j.status] = out.get(j.status, 0) + 1
        return out

    def summary(self) -> Dict:
        done = [j for j in self.jobs if j.status == "done"]
        speedups = [j.default_objective / j.best_objective for j in done
                    if j.best_objective > 0 and j.default_objective > 0]
        return {
            "platform": self.platform,
            "jobs": len(self.jobs),
            **self.counts(),
            "evaluations_spent": sum(j.evaluations for j in self.jobs),
            "total_budget": self.total_budget,
            "mean_speedup": (sum(speedups) / len(speedups)) if speedups else 0.0,
            "seeded_jobs": sum(1 for j in done if j.seeded),
        }


def build_manifest(jobs: Sequence[TuningJob], total_budget: int, path: Optional[str] = None,
                   platform: Optional[str] = None, profile: HardwareProfile = H100_SXM,
                   min_budget: int = 6, max_budget: int = 128) -> CampaignManifest:
    """Plan output -> deduplicated, prioritized, budgeted, saved schedule.
    ``platform`` (the database namespace) defaults to the profile's name."""
    platform = platform or profile.name
    scheduled = allocate_budget(prioritize_jobs(dedupe_jobs(jobs, platform), profile),
                                total_budget, min_budget=min_budget, max_budget=max_budget)
    m = CampaignManifest(path=path, platform=platform, jobs=list(scheduled),
                         total_budget=total_budget)
    m.save()
    return m
