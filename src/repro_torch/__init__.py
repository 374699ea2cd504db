"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors ``repro``'s layout: ``core`` (knob spaces, the tuning database,
the dispatch runtime), ``kernels`` (hand-written CUDA kernels, each beside
its plain PyTorch version), ``models``, ``serving`` and ``launch``. It
imports torch and numpy, never jax and nothing of ``repro``.

    import repro_torch

    with repro_torch.runtime(db=serve_db) as rt:
        ...                      # every dispatch resolves against serve_db
    print(rt.telemetry.report())
"""
from .core.runtime import (  # noqa: F401
    TunedRuntime,
    current_runtime,
    dispatch,
    runtime,
)
