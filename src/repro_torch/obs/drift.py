"""Drift detection: is tuned performance *sustained*, or has it rotted?

The port of ``repro.obs.drift``. A tuning database is a set of promises:
"config C ran key K in ``objective`` seconds on this platform". Those
promises decay (driver and toolkit upgrades, clocks under a lower power
limit, a neighbour on the card, a changed model). This module re-checks
them:

1. **replay probe** (:func:`measure_sites`) -- for each stored record,
   rebuild the arguments from the key (the campaign runner's seeded recipe,
   on the campaign's device: the card unless the caller asks for the CPU)
   with the call's keyword arguments read back from the key extra, as the
   port's campaign measured them, and re-time the stored config through the
   same wall-clock evaluator. The variant is the kernel: a replay never
   times the plain version in its place. Where a campaign manifest is
   given, the replay runs the manifest's job for the key: the call the
   campaign timed, each argument's shape and dtype. Else it runs the key's
   bucketed shapes in its one promoted dtype, as JAX's replay does; a
   record of a kernel whose calls mix float dtypes (bf16 activations beside
   fp32 residuals or coefficients) cannot be rebuilt from its float32 key,
   and is then left out (:func:`unreplayable`), never replayed on the
   all-fp32 kernel in its place.
2. **attribution** (:func:`detect_drift`) -- live seconds against the
   record's objective (%-of-tuned-best) and against the first-principles
   bound of :func:`repro_torch.tools.analytic.site_roofline_seconds` on the
   record's platform profile (%-of-roofline): a 1.5x slowdown at 80% of the
   roofline is a machine problem, at 3% a tuning problem.
3. **ranked report** (:func:`format_drift`) -- worst slowdown first, the
   ``campaign drift`` artifact; sites flagged ``regressed`` (past 1.5x by
   default) are the re-tune queue.

Live timings can also come from elsewhere (``--live``): any mapping of db
key to seconds.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Lazy-import discipline: repro_torch.core.runtime imports repro_torch.obs,
# so this module must not be imported from the package __init__; it pulls
# core and campaign modules only when called.


@dataclasses.dataclass
class DriftEntry:
    """One dispatch site's sustained-performance attribution."""

    key: str
    kernel: str
    tuned_s: float            # the database record's measured objective
    live_s: float             # what the same config costs right now
    roofline_s: float         # first-principles hardware bound for the site
    slowdown: float           # live_s / tuned_s (>1 = slower than tuned)
    pct_of_tuned_best: float  # 100 * tuned_s / live_s (100 = promise holds)
    pct_of_roofline: float    # 100 * roofline_s / live_s
    regressed: bool

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# Kernels whose planned calls mix float dtypes: fp32 residuals beside bf16
# operands (rmsnorm's inverse rms, the cross entropy's cotangent and lse,
# flash's lse) or the selective scan's fp32 coefficients beside its bf16
# input. Their keys read float32 (the promoted dtype) either way.
MIXED_FLOAT_KERNELS = frozenset({
    "rmsnorm_bwd", "softmax_xent_bwd", "flash_attention_bwd",
    "ssm_scan", "ssm_update", "ssm_scan_bwd", "ssm_update_bwd",
})


def arg_dtypes_for(kernel: str, shapes: Sequence[Sequence[int]], dtype: str) -> List[str]:
    """Each argument's dtype, rebuilt from a key's promoted dtype: the
    cross entropy's integer labels (the planner's only integer arguments)
    marked ``int32``, every other argument in the key's dtype."""
    dtypes = [dtype] * len(shapes)
    if kernel == "softmax_xent" and len(shapes) >= 2:
        dtypes[1] = "int32"                      # (T,) labels
    elif kernel == "softmax_xent_bwd" and len(shapes) >= 3:
        dtypes[2] = "int32"                      # ct, logits, labels
    return dtypes


def manifest_calls(manifest) -> Dict[str, Tuple[Tuple[Tuple[int, ...], ...], Tuple[str, ...]]]:
    """db key -> (each argument's shape, each argument's dtype) of the
    campaign manifest's job for the key (``manifest``: a path or a loaded
    :class:`~repro_torch.campaign.scheduler.CampaignManifest`; None gives
    an empty map)."""
    if manifest is None:
        return {}
    from ..campaign.scheduler import CampaignManifest

    if isinstance(manifest, str):
        manifest = CampaignManifest.load(manifest)
    return {j.db_key(manifest.platform): (tuple(j.arg_shapes), tuple(j.arg_dtypes))
            for j in manifest.jobs}


def replay_call(key: str, known: Optional[Dict] = None):
    """(shapes, dtypes) of the call a record's replay runs: the manifest's
    job for the key (``known``, from :func:`manifest_calls`), the call the
    campaign timed; else the key's bucketed shapes, each argument's dtype
    rebuilt from its promoted one. None where the key cannot tell the
    dtypes (a kernel of :data:`MIXED_FLOAT_KERNELS` keyed float32: its
    operands may be narrower)."""
    from ..core.database import split_key

    if known and key in known:
        return known[key]
    kernel, _plat, shapes, dtype, _extra = split_key(key)
    if kernel in MIXED_FLOAT_KERNELS and (dtype or "float32") == "float32":
        return None
    return (tuple(tuple(s) for s in shapes),
            tuple(arg_dtypes_for(kernel, shapes, dtype or "float32")))


def unreplayable(db, manifest=None, platform: Optional[str] = None) -> List[str]:
    """The keys whose arguments' dtypes neither the manifest nor the key
    gives: :func:`measure_sites` leaves them out."""
    from ..core.database import split_key

    known = manifest_calls(manifest)
    return [r.key for r in db.records()
            if (platform is None or split_key(r.key)[1] == platform)
            and replay_call(r.key, known) is None]


# The replay draws its arguments on this many host threads, a batch of at
# most _BATCH_ELEMENTS elements (a single larger job is a batch of its own)
# at a time, and times the batch only once it is drawn: no draw runs
# beside a timing, whose host-bound calls it would slow.
_DRAW_THREADS = 4
_BATCH_ELEMENTS = 1 << 30


def _batches(calls):
    import math

    batch, size = [], 0
    for call in calls:
        n = sum(math.prod(s) for s in call[1].arg_shapes)
        if batch and size + n > _BATCH_ELEMENTS:
            yield batch
            batch, size = [], 0
        batch.append(call)
        size += n
    if batch:
        yield batch


def measure_sites(
    db,
    platform: Optional[str] = None,
    evaluator=None,
    keys: Optional[Sequence[str]] = None,
    seed: int = 0,
    device=None,
    manifest=None,
) -> Dict[str, float]:
    """Replay probe: re-time each stored record's config *now* on ``device``
    (default: the card), on the call :func:`replay_call` gives: the
    campaign manifest's job for the key where ``manifest`` (a path or a
    loaded one) holds it, else the key's.

    Returns {db key: live seconds}. Records of unregistered tunables, and
    those whose dtypes cannot be rebuilt (:func:`unreplayable`), are left
    out; a replay that fails lands as +inf, so the report shows it. The
    arguments are the campaign's seeded tensors (``runner.host_args``),
    drawn on host threads a batch at a time, never beside a timing.
    """
    import math
    from concurrent.futures import ThreadPoolExecutor

    from ..campaign.planner import _register_tunables
    from ..campaign.runner import call_kwargs, host_args, place_args
    from ..core.annotate import get_tunable, registered
    from ..core.database import split_key
    from ..core.evaluate import WallClockEvaluator
    from ..core.platform import resolve_device

    _register_tunables()
    device = resolve_device(device)
    evaluator = evaluator or WallClockEvaluator(repeats=3, warmup=1)
    known = manifest_calls(manifest)
    want = set(keys) if keys is not None else None
    calls = []
    for record in db.records():
        if want is not None and record.key not in want:
            continue
        kernel, plat, _shapes, _dtype, extra = split_key(record.key)
        if platform is not None and plat != platform:
            continue
        if kernel not in registered():
            continue
        call = replay_call(record.key, known)
        if call is None:
            continue
        # host_args reads .kernel/.arg_shapes/.arg_dtypes/.key_extra, so a
        # namespace stands in for a TuningJob: the campaign's tensors
        calls.append((record, types.SimpleNamespace(kernel=kernel, key_extra=extra,
                                                    arg_shapes=call[0], arg_dtypes=call[1])))
    live: Dict[str, float] = {}
    with ThreadPoolExecutor(max_workers=_DRAW_THREADS) as pool:
        for batch in _batches(calls):
            drawn = [pool.submit(host_args, job, seed) for _, job in batch]
            for f in drawn:
                f.exception()                     # the whole batch drawn first
            for (record, job), host in zip(batch, drawn):
                try:
                    args = place_args(job, host.result(), device)
                    variant = get_tunable(job.kernel).variant(**record.config)
                    kw = call_kwargs(job)
                    m = evaluator.evaluate(lambda *a: variant(*a, **kw), args)
                    live[record.key] = m.objective if m.ok else math.inf
                except Exception:
                    live[record.key] = math.inf
            del drawn
    return live


def detect_drift(
    db,
    live: Dict[str, float],
    threshold: float = 1.5,
    profile=None,
    platform: Optional[str] = None,
    manifest=None,
) -> List[DriftEntry]:
    """Attribute live per-site seconds against tuned-best and roofline.

    `live` maps db keys to current seconds — from :func:`measure_sites`, or
    from any external source (a production metrics snapshot). A site is
    `regressed` when live exceeds `threshold` × the record's tuned
    objective. The roofline is priced on ``profile``, else each record's
    platform profile, on the call :func:`replay_call` gives (at its
    largest argument's dtype), else on the key's shapes and dtype.
    Entries come back ranked worst-slowdown-first.
    """
    from ..core.database import split_key
    from ..core.evaluate import site_dtype
    from ..core.gridmodel import resolve_profile
    from ..tools.analytic import site_roofline_seconds

    known = manifest_calls(manifest)
    out: List[DriftEntry] = []
    for record in db.records():
        live_s = live.get(record.key)
        if live_s is None:
            continue
        kernel, plat, shapes, dtype, _extra = split_key(record.key)
        if platform is not None and plat != platform:
            continue
        tuned_s = record.objective
        prof = profile or _profile_for(plat, resolve_profile)
        call = replay_call(record.key, known)
        if call is not None:
            shapes, dtype = call[0], site_dtype(*call)
        roof_s = site_roofline_seconds(kernel, shapes, dtype or "float32", prof)
        slow = (live_s / tuned_s) if tuned_s > 0 else float("inf")
        out.append(
            DriftEntry(
                key=record.key,
                kernel=kernel,
                tuned_s=tuned_s,
                live_s=live_s,
                roofline_s=roof_s,
                slowdown=slow,
                pct_of_tuned_best=(100.0 * tuned_s / live_s) if live_s > 0 else 0.0,
                pct_of_roofline=(100.0 * roof_s / live_s) if live_s > 0 else 0.0,
                regressed=slow > threshold,
            )
        )
    out.sort(key=lambda e: -e.slowdown)
    return out


def _profile_for(platform: str, resolve):
    """The record's platform profile; the detected device's for a key that
    names none of the port's profiles."""
    try:
        return resolve(platform)
    except KeyError:
        return resolve(None)


def drift_report(
    db,
    platform: Optional[str] = None,
    threshold: float = 1.5,
    evaluator=None,
    profile=None,
    live: Optional[Dict[str, float]] = None,
    seed: int = 0,
    device=None,
    manifest=None,
) -> List[DriftEntry]:
    """measure (unless `live` is supplied) + attribute, ranked worst-first;
    ``manifest`` gives each record's call (:func:`replay_call`)."""
    if isinstance(manifest, str):                 # load it once for both steps
        from ..campaign.scheduler import CampaignManifest

        manifest = CampaignManifest.load(manifest)
    if live is None:
        live = measure_sites(db, platform=platform, evaluator=evaluator, seed=seed,
                             device=device, manifest=manifest)
    return detect_drift(db, live, threshold=threshold, profile=profile,
                        platform=platform, manifest=manifest)


def format_drift(entries: Sequence[DriftEntry], threshold: float = 1.5,
                 left_out: Sequence[str] = ()) -> str:
    """The `campaign drift` report: ranked table + re-tune queue, and the
    records ``left_out`` of the replay (:func:`unreplayable`)."""
    text = _format_entries(entries, threshold)
    if left_out:
        text += (f"\n  {len(left_out)} record(s) left out: their arguments mix float dtypes "
                 f"that the key does not give (pass --manifest): {', '.join(left_out[:4])}"
                 f"{' ...' if len(left_out) > 4 else ''}")
    return text


def _format_entries(entries: Sequence[DriftEntry], threshold: float) -> str:
    if not entries:
        return "drift: no measured sites (empty db or no live timings)"
    lines = [
        f"campaign drift report ({len(entries)} sites, "
        f"regression threshold {threshold:.2f}x)",
        f"  {'slowdown':>9}  {'%tuned':>7}  {'%roof':>6}  "
        f"{'tuned_s':>10}  {'live_s':>10}  key",
    ]
    for e in entries:
        flag = " <-- REGRESSED" if e.regressed else ""
        lines.append(
            f"  {e.slowdown:>8.2f}x  {e.pct_of_tuned_best:>6.1f}%  "
            f"{e.pct_of_roofline:>5.1f}%  {e.tuned_s:>10.3e}  "
            f"{e.live_s:>10.3e}  {e.key}{flag}"
        )
    n_reg = sum(1 for e in entries if e.regressed)
    if n_reg:
        lines.append(f"  {n_reg} site(s) regressed — re-tune queue:")
        for e in entries:
            if e.regressed:
                lines.append(f"    campaign re-tune candidate: {e.key}")
    else:
        lines.append("  all sites within threshold — tuned performance sustained")
    return "\n".join(lines)
