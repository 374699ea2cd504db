"""repro_torch.analysis — static analysis over the port's autotuning contract.

Three passes, nothing built or launched (the port of ``repro.analysis``):

1. **lint** — dispatch completeness: raw compute in the port's model code
   (``torch.matmul``/``mm``/``bmm``/``einsum``/``tensordot``, ``F.linear``,
   ``@``, ``torch.softmax``/``F.softmax``) must route through a registry
   tunable or carry a ``# repro: allow-raw(<reason>)`` pragma.
2. **legality** — every kernel's launch models (``repro_torch.core.gridmodel``)
   over its whole config space on the H100 profiles: shared memory, threads,
   tensor-core tiles, races and coverage.
3. **contracts** — registry, planner and database coherence: backward plans
   dispatch registered tunables with oracles (``bwd_via`` where they
   decompose), ``DEFAULT_KERNELS`` is registry-covered, databases and
   manifests carry no stale, unlaunchable or unreachable keys.

CLI: ``python -m repro_torch.analysis check [--strict] [--db ...] [--manifest ...]``
(the db and manifest subset is also ``python -m repro_torch.campaign check``).
"""
from .cli import main, run_checks
from .findings import Finding, Report

__all__ = ["Finding", "Report", "main", "run_checks"]
