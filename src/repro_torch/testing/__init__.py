"""Test support shipped with the port: the deterministic fault-injection
harness (a copy of ``repro.testing``), so chaos tests and the card's smoke
run drive the same seeded failure scenarios against a real process.
"""
from .faults import (  # noqa: F401
    FaultPlan,
    FaultRule,
    InjectedFault,
    InjectedWorkerCrash,
    active_plan,
    fault_point,
)
