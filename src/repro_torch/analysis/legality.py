"""Pass 2 — kernel legality over full config spaces, by launch model.

Evaluates every registered launch model (``repro_torch.core.gridmodel``)
over its tunable's whole knob product on each requested platform profile,
without building or launching anything:

* **race** or **coverage** findings are errors: a kernel whose blocks write
  one output tile with no declared reduction, or leave an output element
  unwritten, is wrong on *every* card whatever today's runs show.
* a space with **zero** legal configs is an error: the tuner would find no
  variant to launch on that card.
* shared-memory, thread and tensor-core tile pruning is ``info``
  accounting: those configs stay in the space (another card or shape may
  take them) and are skipped on this one before any trial (the tuner's
  pre-pass and ``ParamSpace.legal_configs`` read the same verdicts).

``DEFAULT_PLATFORMS`` are the port's two card profiles, ``h100-sxm`` and
``h100-pcie``; where a card is present its detected key joins them. The
CPU profile ``torch-cpu`` carries the H100's shared-memory numbers
(``core/platform.py``), so it prunes what the card prunes, where the JAX
package's CPU host prunes nothing.

Besides the nominal shapes, each kernel is judged at the shapes its main
paths give it on the card (:data:`PHASE_SHAPES`: qwen2_0_5b's serving and
training steps, the hybrid's Mamba layer, Mixtral's experts, PaliGemma's
heads of 256).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Report

DEFAULT_PLATFORMS = ("h100-sxm", "h100-pcie")

_BF, _F32, _I32 = "bfloat16", "float32", "int32"

# kernel -> (label, shapes, dtypes) of the calls the card's main paths make
PHASE_SHAPES: Dict[str, Tuple[Tuple[str, tuple, tuple], ...]] = {
    "matmul": (
        ("serve decode unembed", ((8, 896), (896, 151936)), (_BF, _BF)),
        ("train unembed dx", ((2048, 151936), (151936, 896)), (_BF, _BF)),
        ("hybrid out_proj f32", ((2048, 16384), (16384, 8192)), (_F32, _F32)),
    ),
    "rmsnorm": (("train", ((8192, 896), (896,)), (_BF, _BF)),
                ("hybrid", ((2048, 8192), (8192,)), (_BF, _BF))),
    "rmsnorm_bwd": (("train", ((8192, 896), (8192, 896), (896,), (8192,)),
                     (_BF, _BF, _BF, _F32)),),
    "softmax_xent": (("train", ((2048, 151936), (2048,)), (_BF, _I32)),),
    "softmax_xent_bwd": (("train", ((2048,), (2048, 151936), (2048,), (2048,)),
                          (_F32, _BF, _I32, _F32)),),
    "flash_attention": (
        ("train d=64", ((4, 14, 2048, 64), (4, 2, 2048, 64), (4, 2, 2048, 64)), (_BF,) * 3),
        ("paligemma d=256", ((2, 8, 2048, 256), (2, 1, 2048, 256), (2, 1, 2048, 256)),
         (_BF,) * 3),
    ),
    "flash_attention_bwd": (
        ("train d=64", ((4, 14, 2048, 64), (4, 14, 2048, 64), (4, 2, 2048, 64),
                        (4, 2, 2048, 64), (4, 14, 2048, 64), (4, 14, 2048)),
         (_BF,) * 5 + (_F32,)),
        ("paligemma d=256", ((2, 8, 2048, 256), (2, 8, 2048, 256), (2, 1, 2048, 256),
                             (2, 1, 2048, 256), (2, 8, 2048, 256), (2, 8, 2048)),
         (_BF,) * 5 + (_F32,)),
    ),
    "matmul_bias_act": (("train gate", ((8192, 896), (896, 4864), (4864,)), (_BF,) * 3),),
    "rmsnorm_matmul": (("serve decode unembed", ((8, 896), (896,), (896, 151936)),
                        (_BF,) * 3),),
    "ssm_scan": (("hybrid prefill", ((1, 2048, 16384), (1, 2048, 16384), (1, 2048, 16),
                                     (1, 2048, 16), (16384, 16), (1, 16384, 16)),
                  (_BF,) + (_F32,) * 5),),
    "ssm_update": (("hybrid decode", ((8, 16384), (8, 16384), (8, 16), (8, 16), (16384, 16),
                                      (8, 16384, 16)), (_BF,) + (_F32,) * 5),),
    "expert_gemm": (("moe decode", ((8, 2, 4096), (8, 4096, 14336)), (_BF, _BF)),
                    ("moe train", ((8, 2560, 4096), (8, 4096, 14336)), (_BF, _BF))),
}


def default_platforms() -> List[str]:
    """The port's profiles, plus the detected card's key where there is one."""
    import torch

    out = list(DEFAULT_PLATFORMS)
    if torch.cuda.is_available():
        from ..core.platform import detect_platform

        here = detect_platform("cuda").name
        if here not in out:
            out.append(here)
    return out


def check_legality(platforms: Optional[Sequence[str]] = None,
                   report: Optional[Report] = None, phases: bool = True) -> Report:
    report = report if report is not None else Report()
    from ..core.gridmodel import registered_models, space_report
    from ..core.runtime import ensure_registered

    ensure_registered()
    platforms = list(platforms or default_platforms())
    stats = {}
    for kernel in sorted(registered_models()):
        cases = [("nominal", None, None)]
        if phases:
            cases += list(PHASE_SHAPES.get(kernel, ()))
        for platform in platforms:
            for label, shapes, dtypes in cases:
                r = space_report(kernel, platform, shapes, dtypes)
                loc = f"{kernel}@{platform}" + ("" if shapes is None else f" [{label}]")
                if shapes is None:
                    stats[f"{kernel}@{platform}"] = {
                        "total": r["total"], "legal": r["legal"], "illegal": r["illegal"],
                        "by_category": dict(r["by_category"]), "redundant": r["redundant"]}
                by_cat = r.get("by_category", {})
                for cat in ("race", "coverage", "build"):
                    n = by_cat.get(cat, 0)
                    if n:
                        sample = next((s for s in r.get("reasons", ()) if s.startswith(cat)), "")
                        report.add("legality", "error", loc,
                                   f"{n} config(s) with a {cat} fault"
                                   + (f" — e.g. {sample}" if sample else ""))
                if r["legal"] == 0:
                    report.add("legality", "error", loc,
                               f"no legal configs (all {r['total']} pruned): the tuner would "
                               "find no variant to launch on this card")
                elif r["illegal"] and shapes is None:
                    cats = ", ".join(f"{c} {n}" for c, n in sorted(by_cat.items()))
                    report.add("legality", "info", loc,
                               f"{r['illegal']} of {r['total']} configs statically pruned "
                               f"({r['legal']} legal; {cats})")
                if r.get("redundant") and shapes is None:
                    report.add("legality", "info", loc,
                               f"{r['redundant']} legal config(s) launch the same kernels as "
                               "another at the nominal shapes (measurement redundancy)")
    report.stats["legality"] = stats
    return report
