"""The port's fault-injection harness (``repro_torch.testing``): the
counterparts of ``tests/test_faults.py``, and its parity with the JAX
package's copy: the same seeded plan and the same sequence of site calls
fire the same faults in both."""
import threading
import time

import pytest

import repro.testing as jax_faults
from repro_torch.testing import (
    FaultPlan,
    FaultRule,
    InjectedFault,
    InjectedWorkerCrash,
    active_plan,
    fault_point,
)


def test_no_plan_is_inert():
    assert active_plan() is None
    assert fault_point("dispatch.kernel:matmul", tier="exact") is None


def test_error_kind_raises_and_records():
    plan = FaultPlan([FaultRule(site="a.b:*", kind="error", message="boom")])
    with plan:
        with pytest.raises(InjectedFault, match="boom"):
            fault_point("a.b:matmul")
        assert fault_point("other.site") is None
    assert plan.fired == [("a.b:matmul", "error", 0)]
    assert plan.count("a.b:*") == 1
    assert plan.count("a.b:*", kind="nan") == 0
    assert fault_point("a.b:matmul") is None          # the plan exited


@pytest.mark.parametrize("kind, exc", [("crash", InjectedWorkerCrash), ("torn", ValueError)])
def test_raising_kinds(kind, exc):
    """crash escapes ``except Exception``; torn is the plain ValueError a
    torn json.load raises, so real corruption handlers catch it."""
    with FaultPlan([FaultRule(site="w:*", kind=kind)]):
        with pytest.raises(exc):
            fault_point("w:job")
        if kind == "crash":
            with pytest.raises(InjectedWorkerCrash):
                try:
                    fault_point("w:job")
                except Exception:  # noqa: BLE001
                    pytest.fail("crash kind must escape `except Exception`")


@pytest.mark.parametrize("kind", ["nan", "latency"])
def test_kinds_returned_to_the_site(kind):
    with FaultPlan([FaultRule(site="k:*", kind=kind, delay_s=0.05)]) as plan:
        t0 = time.monotonic()
        rule = fault_point("k:x")
        if kind == "latency":
            assert time.monotonic() - t0 >= 0.05
    assert rule is not None and rule.kind == kind
    assert plan.count(kind=kind) == 1


def test_after_and_times_gating():
    plan = FaultPlan([FaultRule(site="s", kind="error", after=2, times=2)])
    with plan:
        outcomes = []
        for _ in range(6):
            try:
                fault_point("s")
                outcomes.append("ok")
            except InjectedFault:
                outcomes.append("fault")
    assert outcomes == ["ok", "ok", "fault", "fault", "ok", "ok"]


def _fire_sequence(mod, seed):
    fired = []
    with mod.FaultPlan([mod.FaultRule(site="p", kind="error", p=0.5)], seed=seed) as plan:
        for _ in range(32):
            try:
                mod.fault_point("p")
                fired.append(0)
            except mod.InjectedFault:
                fired.append(1)
        assert len(plan.fired) == sum(fired)
    return fired


def test_probability_is_seeded_deterministic():
    import repro_torch.testing as port

    a, b = _fire_sequence(port, 7), _fire_sequence(port, 7)
    assert a == b
    assert 0 < sum(a) < 32
    assert _fire_sequence(port, 8) != a


def test_when_ctx_narrowing():
    with FaultPlan([FaultRule(site="dispatch.kernel:*", when={"tier": "exact"})]):
        assert fault_point("dispatch.kernel:matmul", tier="heuristic") is None
        with pytest.raises(InjectedFault):
            fault_point("dispatch.kernel:matmul", tier="exact")


def test_nested_plans_innermost_wins():
    outer = FaultPlan([FaultRule(site="x", kind="error")], name="outer")
    inner = FaultPlan([], name="inner")
    with outer:
        with inner:
            assert active_plan() is inner
            assert fault_point("x") is None
        with pytest.raises(InjectedFault):
            fault_point("x")


def test_install_reaches_fresh_threads():
    plan = FaultPlan([FaultRule(site="worker:*", kind="error")])
    plan.install()
    try:
        box = {}

        def work():
            try:
                fault_point("worker:job")
                box["out"] = "ok"
            except InjectedFault:
                box["out"] = "fault"

        t = threading.Thread(target=work)
        t.start()
        t.join()
        assert box["out"] == "fault"
    finally:
        plan.uninstall()
    assert active_plan() is None


def test_bad_kind_rejected():
    with pytest.raises(ValueError, match="fault kind"):
        FaultRule(site="x", kind="segfault")


def _mixed_calls(mod):
    """A seeded plan of every kind the caller survives, against one
    sequence of site calls: what fired, in order, and the outcome of each
    call."""
    rules = [mod.FaultRule(site="dispatch.kernel:*", p=0.4, when={"tier": "exact"}),
             mod.FaultRule(site="dispatch.kernel:rmsnorm", kind="nan", after=1, times=3),
             mod.FaultRule(site="db.load:*", kind="torn", p=0.5),
             mod.FaultRule(site="campaign.job:*", p=0.3, after=2)]
    sites = [("dispatch.kernel:matmul", {"tier": "exact"}),
             ("dispatch.kernel:matmul", {"tier": "heuristic"}),
             ("dispatch.kernel:rmsnorm", {"tier": "exact"}),
             ("db.load:/x/db.json", {}),
             ("campaign.job:matmul", {"attempt": 1})]
    outcomes = []
    with mod.FaultPlan(rules, seed=1234) as plan:
        for i in range(60):
            site, ctx = sites[i % len(sites)]
            try:
                rule = mod.fault_point(site, **ctx)
                outcomes.append("ok" if rule is None else rule.kind)
            except mod.InjectedFault:
                outcomes.append("error")
            except ValueError:
                outcomes.append("torn")
    return list(plan.fired), outcomes


def test_fired_list_matches_the_jax_package():
    import repro_torch.testing as port

    fired, outcomes = _mixed_calls(port)
    j_fired, j_outcomes = _mixed_calls(jax_faults)
    assert fired == j_fired and outcomes == j_outcomes
    assert {k for _, k, _ in fired} == {"error", "nan", "torn"}
    assert _fire_sequence(port, 7) == _fire_sequence(jax_faults, 7)
