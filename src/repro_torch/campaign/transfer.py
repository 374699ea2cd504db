"""Transfer: warm starts from neighbouring records, and cover sets.

The port of ``repro.campaign.transfer``:

* **warm starts** -- the winning config varies smoothly with the shape
  bucket, so the nearest tuned neighbour (same kernel, closest bucket; then
  the same platform under another dtype or key extra; then another
  platform) is a good first evaluation for a search;
* **cover sets** -- a campaign's winners per kernel are few; clustering the
  records by winning config gives a handful of entries that cover most
  tuned buckets, and the database ships them as the measured fallback for
  shapes the campaign never saw (the ``CoverSet`` tier).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.database import Record, TuningDatabase, shape_bucket, shape_distance, split_key
from ..core.params import Config, ParamSpace


def warm_start_configs(
    db: TuningDatabase,
    kernel: str,
    platform: str,
    arg_shapes: Sequence[Sequence[int]],
    dtype: str,
    key_extra: str = "",
    space: Optional[ParamSpace] = None,
    k: int = 3,
) -> List[Config]:
    """Up to ``k`` seed configs from the nearest records of ``kernel``.

    ``dtype`` is the promoted key dtype of the call. The exact target key is
    skipped: that is a database hit, not a transfer. Configs invalid in
    ``space`` are dropped.
    """
    target = tuple(shape_bucket(s) for s in arg_shapes)
    scored: List[Tuple[Tuple[int, float, float], Config]] = []
    for rec in db.records():
        r_kernel, r_platform, r_shapes, r_dtype, r_extra = split_key(rec.key)
        if r_kernel != kernel:
            continue
        dist = shape_distance(target, r_shapes)
        if r_platform == platform and r_dtype == dtype and r_extra == key_extra:
            if dist == 0.0:
                continue
            tier = 0
        elif r_platform == platform:
            tier = 1
        else:
            tier = 2
        if math.isinf(dist):
            continue
        scored.append(((tier, dist, rec.objective), dict(rec.config)))
    scored.sort(key=lambda t: t[0])

    out: List[Config] = []
    seen = set()
    for _, cfg in scored:
        if space is not None and not space.is_valid(cfg):
            continue
        ck = ParamSpace.config_key(cfg)
        if ck in seen:
            continue
        seen.add(ck)
        out.append(cfg)
        if len(out) >= k:
            break
    return out


def cluster_winners(records: Sequence[Record], max_size: int = 4,
                    coverage: float = 0.95) -> List[Dict]:
    """Greedy set cover on config identity: the config that won the most
    buckets first, until ``coverage`` of the records or ``max_size``
    entries; each entry keeps the bucketed shapes it won on."""
    if not records:
        return []
    groups: Dict[str, Dict] = {}
    for rec in records:
        ck = ParamSpace.config_key(rec.config)
        g = groups.setdefault(ck, {"config": dict(rec.config), "support": []})
        g["support"].append([list(s) for s in split_key(rec.key)[2]])
    ranked = sorted(groups.values(), key=lambda g: -len(g["support"]))
    total = len(records)
    out: List[Dict] = []
    covered = 0
    for g in ranked:
        if len(out) >= max_size or covered / total >= coverage:
            break
        covered += len(g["support"])
        out.append({"config": g["config"], "support": g["support"],
                    "share": len(g["support"]) / total})
    return out


def compute_covers(db: TuningDatabase, platform: str, max_size: int = 4,
                   save: bool = True) -> Dict[str, List[Dict]]:
    """Cluster every kernel's winners on ``platform`` and store the covers."""
    by_kernel: Dict[str, List[Record]] = {}
    for rec in db.records():
        kernel, r_platform, _, _, _ = split_key(rec.key)
        if r_platform == platform:
            by_kernel.setdefault(kernel, []).append(rec)
    covers: Dict[str, List[Dict]] = {}
    for kernel, recs in sorted(by_kernel.items()):
        entries = cluster_winners(recs, max_size=max_size)
        if entries:
            db.put_cover(kernel, platform, entries, save=False)
            covers[kernel] = entries
    if save:
        db.save()
    return covers
