"""Pass 3 — registry contract verification (``repro.analysis.contracts``
for the port's registry).

Cross-checks the three places a kernel must agree with itself:

* every registered tunable has a correctness oracle (its tuning
  ``reference``) — without one the autotuner's gate is vacuous;
* every ``vjp="dispatch"`` tunable's backward plan actually routes through
  registered tunables: its ``bwd`` callable must dispatch either a matched
  ``<name>_bwd`` sibling or the forward tunable itself (matmul/expert_gemm
  gradients reuse the forward kernel with transposed operands) — unless the
  spec declares ``bwd_via``, in which case the plan is verified against
  those names instead (fused-epilogue tunables decompose their gradients
  onto *other* kernels' dispatch sites) — and every dispatch target it
  names must exist in the registry with an oracle;
* the campaign planner's default roster (``planner.DEFAULT_KERNELS``) only
  names registered tunables — a roster typo silently plans zero jobs for
  that kernel.

The backward-plan check reads the ``bwd`` source (``inspect.getsource``)
for ``dispatch("<name>", ...)`` sites: the registry declares *that* a
backward plan exists, the source names *which* tunables it resolves
through, and this pass pins the two together.

The pass reads the process-wide registry, as JAX's does, so a tunable a
test registers for itself must leave it again (the port's tests do, through
``repro_torch.core.annotate.unregister``); one left behind would be checked
with the rest.
"""
from __future__ import annotations

import inspect
import re
from typing import Optional

from .findings import Report

_DISPATCH_RE = re.compile(r"dispatch\(\s*[\"']([^\"']+)[\"']")


def check_contracts(report: Optional[Report] = None) -> Report:
    report = report if report is not None else Report()
    from ..campaign.planner import DEFAULT_KERNELS
    from ..core.annotate import registered
    from ..core.runtime import ensure_registered

    ensure_registered()
    regs = registered()
    n_dispatch_vjp = 0

    for name in sorted(regs):
        t = regs[name]
        if t.reference is None:
            report.add(
                "contracts", "error", name,
                "tunable has no reference oracle: the tuner's correctness "
                "gate cannot validate its variants",
            )
        spec = t.dispatch
        if spec is None or getattr(spec, "vjp", None) != "dispatch":
            continue
        n_dispatch_vjp += 1
        bwd = getattr(spec, "bwd", None)
        if bwd is None:
            report.add(
                "contracts", "error", name,
                'vjp="dispatch" declared but no bwd callable attached',
            )
            continue
        try:
            src = inspect.getsource(bwd)
        except (OSError, TypeError):                  # pragma: no cover
            report.add(
                "contracts", "warn", name,
                "bwd source unavailable; cannot verify its dispatch targets",
            )
            continue
        targets = sorted(set(_DISPATCH_RE.findall(src)))
        if not targets:
            report.add(
                "contracts", "error", name,
                'vjp="dispatch" bwd never calls dispatch(...): gradients '
                "would bypass the policy pipeline entirely",
            )
            continue
        via = tuple(getattr(spec, "bwd_via", ()) or ())
        if via:
            undeclared = [v for v in via if v not in targets]
            if undeclared:
                report.add(
                    "contracts", "error", name,
                    f"bwd_via declares {undeclared} but the bwd source never "
                    "dispatches them — the declared decomposition has drifted "
                    "from the plan",
                )
        elif f"{name}_bwd" not in targets and name not in targets:
            report.add(
                "contracts", "error", name,
                f"bwd dispatches {targets} but neither {name}_bwd nor the "
                f"forward tunable — gradient records would bank under an "
                "unrelated key",
            )
        for target in targets:
            if target not in regs:
                report.add(
                    "contracts", "error", name,
                    f"bwd dispatches unregistered tunable {target!r}",
                )
            elif regs[target].reference is None:
                report.add(
                    "contracts", "error", name,
                    f"bwd target {target!r} has no reference oracle",
                )

    for kernel in DEFAULT_KERNELS:
        if kernel not in regs:
            report.add(
                "contracts", "error", f"planner:{kernel}",
                "DEFAULT_KERNELS names a tunable missing from the registry — "
                "campaign plans would silently skip it",
            )

    report.stats["contracts"] = {
        "tunables": len(regs),
        "dispatch_vjp": n_dispatch_vjp,
        "roster": len(DEFAULT_KERNELS),
    }
    return report
