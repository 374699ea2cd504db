"""Database + manifest contract checks (the ``campaign check`` backend;
``repro.analysis.db_check`` for the port's databases).

Loads the tuning database as *raw JSON* on purpose: ``TuningDatabase.load``
drops wrong-schema blobs (right for the runtime: stale records must not be
served), but an operator running ``check`` wants the finding, not a silent
fresh start. Checks:

* schema version drift (pre-current databases) — warn;
* record keys naming a platform that is neither one of the port's profiles
  (``h100-sxm``, ``h100-pcie``, ``torch-cpu``) nor the detected one — warn
  (a database tuned elsewhere, the JAX package's, or a typo'd export);
* stale pre-promoted-dtype keys: an integer-dtype key for a tunable whose
  example call promotes to float — error, the runtime will never hit it;
* records whose stored config is no longer valid in the tunable's current
  space — warn (the space evolved; dispatch falls through this record);
* records whose stored config the kernel's launch models now refuse on the
  record's platform at the record's shapes (shared memory, threads, a
  tensor-core tile, or a race or coverage fault) — warn: no tier would
  launch it. Each argument's dtype is the manifest's where it holds the
  key, else the key's; a record whose arguments mix float dtypes is judged
  only with the manifest (``obs.drift.replay_call``);
* pre-residual ``*_bwd`` keys: a backward record whose key carries fewer
  operands than the tunable's current dispatch call — warn, re-plan and
  re-run;
* manifest: the pre-backward-plane hazard (``@dp`` training scenarios, no
  ``*_bwd`` roster) — error, mirroring ``campaign run``'s refusal;
* expert_gemm capacity drift: records whose bucketed capacity dim matches
  no capacity the manifest's expert_gemm jobs expect — warn, once a key
  through ``obs.collect.warn_once`` so drift also lands in the event buffer.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence

from .findings import Report


def _load_raw_db(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _example_arg_count(tunable) -> Optional[int]:
    """Arity of the tunable's dispatch call: its example's, else the
    positional parameters of the function before its keyword-only knobs."""
    spec = tunable.dispatch
    if spec is not None and getattr(spec, "example", None) is not None:
        try:
            args, _kwargs = spec.example()
            return len(args)
        except Exception:                             # pragma: no cover
            return None
    import inspect

    try:
        params = inspect.signature(tunable.fn).parameters.values()
    except (TypeError, ValueError):                   # pragma: no cover
        return None
    return sum(1 for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))


def _example_promotes_float(tunable) -> Optional[bool]:
    """True when the tunable's example call computes in a float dtype; with
    no example, True: every tunable of the port computes in a float dtype
    (integer arguments, softmax_xent's labels, only index)."""
    spec = tunable.dispatch
    if spec is None or getattr(spec, "example", None) is None:
        return True
    try:
        args, _kwargs = spec.example()
        from ..core.tuner import promoted_dtype

        dtypes = [a.dtype for a in args if hasattr(a, "dtype")]
        return promoted_dtype(dtypes).startswith(("float", "bfloat", "f"))
    except Exception:                                 # pragma: no cover
        return None


def _launch_verdict(kernel, cfg, platform, shapes, dtypes):
    """The launch models' verdict on a stored config at its key's shapes,
    in each argument's dtype as the drift replay draws it."""
    from ..core.gridmodel import config_verdict

    return config_verdict(kernel, cfg, platform, shapes, dtypes)


def check_db(
    db_path: str,
    manifest_path: Optional[str] = None,
    report: Optional[Report] = None,
) -> Report:
    report = report if report is not None else Report()
    from ..core.annotate import registered
    from ..core.database import SCHEMA_VERSION, shape_bucket, split_key
    from ..core.gridmodel import registered_models
    from ..core.platform import PROFILES, detect_platform
    from ..core.runtime import ensure_registered

    ensure_registered()
    regs = registered()
    models = registered_models()
    known_platforms = set(PROFILES) | {detect_platform().name}

    blob = _load_raw_db(db_path)
    if blob is None:
        report.add("db", "info", db_path, "no tuning database at this path")
        report.stats["db"] = {"records": 0}
        return report

    schema = blob.get("schema", 0)
    if schema != SCHEMA_VERSION:
        report.add(
            "db", "warn", db_path,
            f"schema {schema} != current {SCHEMA_VERSION}: the runtime "
            "ignores every record in this file (re-run the campaign)",
        )
    records: Dict[str, Any] = blob.get("records", {})
    report.stats["db"] = {"records": len(records), "schema": schema}

    from ..obs.drift import manifest_calls, replay_call

    known = (manifest_calls(manifest_path)
             if manifest_path and os.path.exists(manifest_path) else {})
    seen_platforms = set()
    float_example_cache: Dict[str, Optional[bool]] = {}
    arity_cache: Dict[str, Optional[int]] = {}
    for key, rec in sorted(records.items()):
        kernel, platform, shapes, dtype, _extra = split_key(key)
        if platform not in known_platforms and platform not in seen_platforms:
            seen_platforms.add(platform)
            report.add(
                "db", "warn", key,
                f"unknown platform fingerprint {platform!r} (known: "
                f"{sorted(known_platforms)}) — foreign export or typo",
            )
        t = regs.get(kernel)
        if t is None:
            report.add(
                "db", "warn", key,
                f"record for unregistered tunable {kernel!r}: dead weight, "
                "nothing will ever look it up",
            )
            continue
        if dtype.startswith(("int", "uint")):
            if kernel not in float_example_cache:
                float_example_cache[kernel] = _example_promotes_float(t)
            if float_example_cache[kernel]:
                report.add(
                    "db", "error", key,
                    f"stale integer-dtype key ({dtype}) for a float-computing "
                    "kernel — recorded before keys used the promoted dtype; "
                    "the runtime will never hit it (re-tune rebuilds it)",
                )
        if kernel.endswith("_bwd"):
            if kernel not in arity_cache:
                arity_cache[kernel] = _example_arg_count(t)
            want = arity_cache[kernel]
            if want is not None and len(shapes) < want:
                report.add(
                    "db", "warn", key,
                    f"{kernel} record keyed under a pre-residual signature "
                    f"({len(shapes)} operands, current dispatch keys "
                    f"{want}): the runtime will never ExactHit it — it is "
                    "warm-start-only (transfer seeds still mine it); "
                    "re-plan and re-run the backward roster",
                )
        cfg = (rec or {}).get("config")
        if cfg is not None and not t.space.is_valid(cfg):
            why = t.space.why_invalid(cfg)
            report.add(
                "db", "warn", key,
                f"stored config is no longer valid in {kernel}'s space "
                f"({why}); dispatch falls through this record",
            )
        elif (cfg is not None and kernel in models and platform in known_platforms
              and (call := replay_call(key, known)) is not None):
            verdict = _launch_verdict(kernel, cfg, platform, shapes, call[1])
            if verdict is not None:
                report.add(
                    "db", "warn", key,
                    f"stored config {cfg} cannot launch on {platform} at the record's "
                    f"shapes ({verdict[0]}: {verdict[1]}); no tier would run it",
                )

    if manifest_path:
        _check_manifest(manifest_path, records, report)
    else:
        report.add(
            "db", "info", db_path,
            "no manifest given: capacity-drift and backward-roster checks "
            "skipped (pass --manifest)",
        )
    return report


def _check_manifest(
    manifest_path: str, records: Dict[str, Any], report: Report
) -> None:
    from ..campaign import scheduler
    from ..core.database import split_key

    if not os.path.exists(manifest_path):
        report.add("db", "warn", manifest_path, "manifest path does not exist")
        return
    manifest = scheduler.CampaignManifest.load(manifest_path)
    if scheduler.manifest_missing_bwd(manifest):
        report.add(
            "db", "error", manifest_path,
            "manifest has sharding-aware training jobs (@dp scenarios) but "
            "no backward roster — it predates the tuned backward plane; "
            "re-plan before running",
        )
    # Expert-capacity drift: the MoE x operand is (experts, capacity, d) —
    # its bucketed middle dim is the capacity the records were tuned at. If
    # the plan's expert_gemm jobs (derived from today's arch configs via
    # expert_capacity()) expect a different bucket set, the banked records
    # will never ExactHit under the new routing.
    expected = {
        s[1]
        for j in manifest.jobs
        if j.kernel == "expert_gemm"
        for s in (j.bucketed_shapes()[:1] or ())
        if len(s) == 3
    }
    if not expected:
        return
    from ..obs.collect import warn_once

    for key in sorted(records):
        kernel, platform, shapes, _dtype, _extra = split_key(key)
        if kernel != "expert_gemm" or not shapes or len(shapes[0]) != 3:
            continue
        capacity = shapes[0][1]
        if capacity not in expected:
            warn_once(
                "analysis.expert_gemm_capacity",
                key=key,
                detail=(
                    f"record capacity bucket {capacity} not among the plan's "
                    f"expected buckets {sorted(expected)}"
                ),
            )
            report.add(
                "db", "warn", key,
                f"expert_gemm capacity bucket {capacity} no longer matches "
                f"the plan's expert_capacity() buckets {sorted(expected)} — "
                "routing changed; this record is unreachable",
            )
