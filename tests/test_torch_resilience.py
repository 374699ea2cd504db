"""The port's straggler monitor, restart policy and recovery loop
(``repro_torch.train.resilience``): the counterparts of
``tests/test_resilience.py``, each held against ``repro.train.resilience``
on the same inputs (the same step times flag the same steps, the same
failures give the same backoffs, replays and exhaustion)."""
import pytest

import repro.train.resilience as jres
import repro_torch.train.resilience as tres

BOTH = pytest.mark.parametrize("mod", [tres, jres], ids=["port", "jax"])


def _flags(mod, times, **kw):
    events = []
    m = mod.StragglerMonitor(on_straggler=lambda s, t, med: events.append(s), **kw)
    verdicts = [m.record(i, t) for i, t in enumerate(times)]
    return verdicts, events, m.flagged


def test_straggler_detection():
    times = [1.0 + 0.01 * (i % 3) for i in range(20)] + [10.0, 1.01]
    port = _flags(tres, times, threshold_mads=5.0, min_samples=8)
    assert port == _flags(jres, times, threshold_mads=5.0, min_samples=8)
    verdicts, events, _ = port
    assert not any(verdicts[:20]) and verdicts[20] and not verdicts[21]
    assert events == [20]


def test_straggler_needs_history():
    times = [100.0 if i == 3 else 1.0 for i in range(7)]
    port = _flags(tres, times, min_samples=8)
    assert port == _flags(jres, times, min_samples=8)
    assert not any(port[0])


def test_restart_policy_budget():
    def backoffs(mod):
        p = mod.RestartPolicy(max_failures=3, backoff_base_s=0.1, backoff_cap_s=1.0)
        out = [p.on_failure() for _ in range(3)]
        with pytest.raises(RuntimeError, match="budget"):
            p.on_failure()
        return out

    assert backoffs(tres) == backoffs(jres) == [0.1, 0.2, 0.4]


def _replay(mod):
    state = {"step": 0, "ckpt": 0, "fail_armed": True}
    executed, slept = [], []

    def step_fn(step):
        if state["fail_armed"] and step == 5:
            state["fail_armed"] = False
            raise RuntimeError("simulated node failure")
        executed.append(step)
        state["step"] = step + 1
        if (step + 1) % 3 == 0:
            state["ckpt"] = step + 1
        return {"loss": float(step)}

    def restore_fn():
        state["step"] = state["ckpt"]
        return state["ckpt"]

    last = mod.run_with_recovery(step_fn, restore_fn, total_steps=8,
                                 policy=mod.RestartPolicy(max_failures=2), sleep=slept.append)
    return executed, slept, last


def test_run_with_recovery_replays_from_checkpoint():
    port = _replay(tres)
    assert port == _replay(jres)
    # failed at 5 -> restored to the checkpoint at 3 -> replayed 3, 4, 5
    assert port[0] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    assert port[1] == [0.1] and port[2] == {"loss": 7.0}


@BOTH
def test_run_with_recovery_gives_up(mod):
    calls = []

    def step_fn(step):
        calls.append(step)
        raise RuntimeError("always broken")

    with pytest.raises(RuntimeError, match="budget"):
        mod.run_with_recovery(step_fn, lambda: 0, total_steps=4,
                              policy=mod.RestartPolicy(max_failures=2), sleep=lambda s: None)
    assert calls == [0, 0, 0]


def test_run_with_recovery_raises_what_fatal_names():
    """The port's ``fatal=``: an error it names raises at once, with no
    restore and no failure counted; any other still recovers."""
    calls, restores = [], []
    policy = tres.RestartPolicy(max_failures=5)

    def step_fn(step):
        calls.append(step)
        if step == 1 and len(calls) == 2:
            raise RuntimeError("recoverable")
        if step == 2:
            raise KeyError("fatal")

    def restore_fn():
        restores.append(1)
        return 1

    with pytest.raises(KeyError, match="fatal"):
        tres.run_with_recovery(step_fn, restore_fn, total_steps=4, policy=policy,
                               sleep=lambda s: None, fatal=lambda e: isinstance(e, KeyError))
    assert calls == [0, 1, 1, 2] and restores == [1] and policy.failures == 1
