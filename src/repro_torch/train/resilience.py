"""Fault-tolerance utilities: failure detection, straggler monitor, restart
policy.

A copy of ``repro.train.resilience`` (stdlib only; the port imports nothing
of the JAX package), plus ``run_with_recovery(fatal=)``.

At 1000+ nodes the mean time between node failures drops below job length;
the framework must treat failure as a steady-state input, not an exception:

  * :class:`StragglerMonitor` — robust per-step timing stats (median/MAD);
    flags steps beyond k·MAD and exposes a pluggable response (log, or a
    callback that would trigger re-slicing/hot-spare swap on a real fleet).
  * :class:`RestartPolicy` — bounded exponential backoff with a failure
    budget, so a flapping node cannot livelock the job.
  * :func:`run_with_recovery` — the supervision loop the Trainer uses: run
    step → on exception, restore from the last committed checkpoint and
    replay. The data pipeline's O(1) resume state makes replay exact.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("repro_torch.resilience")


class StragglerMonitor:
    """Flags abnormally slow steps via median + MAD (robust to warmup)."""

    def __init__(self, window: int = 50, threshold_mads: float = 5.0,
                 min_samples: int = 8,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.window = window
        self.threshold = threshold_mads
        self.min_samples = min_samples
        self.times: List[float] = []
        self.flagged: List[int] = []
        self.on_straggler = on_straggler

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def record(self, step: int, seconds: float) -> bool:
        """Record one step time; returns True if it is a straggler."""
        history = self.times[-self.window:]
        self.times.append(seconds)
        if len(history) < self.min_samples:
            return False
        med = self._median(history)
        mad = self._median([abs(t - med) for t in history]) or 1e-9
        if seconds > med + self.threshold * mad and seconds > 1.2 * med:
            self.flagged.append(step)
            log.warning(
                "straggler at step %d: %.3fs vs median %.3fs (MAD %.3fs)",
                step, seconds, med, mad,
            )
            if self.on_straggler:
                self.on_straggler(step, seconds, med)
            return True
        return False


@dataclasses.dataclass
class RestartPolicy:
    max_failures: int = 10
    backoff_base_s: float = 0.1
    backoff_cap_s: float = 30.0
    failures: int = 0

    def on_failure(self) -> float:
        """Record a failure; return backoff seconds. Raises if budget spent."""
        self.failures += 1
        if self.failures > self.max_failures:
            raise RuntimeError(
                f"failure budget exhausted ({self.failures} failures)"
            )
        return min(self.backoff_cap_s, self.backoff_base_s * 2 ** (self.failures - 1))


def run_with_recovery(
    step_fn: Callable[[int], Dict],
    restore_fn: Callable[[], int],
    total_steps: int,
    start_step: int = 0,
    policy: Optional[RestartPolicy] = None,
    sleep=time.sleep,
    fatal: Optional[Callable[[Exception], bool]] = None,
) -> Dict:
    """Supervision loop: execute steps, recover-and-replay on failure.

    step_fn(step) runs one training step (it owns state mutation).
    restore_fn() rolls state back to the last committed checkpoint and
    returns the step to resume from. An exception for which ``fatal(e)``
    holds is raised at once, with no recovery (the port's addition: the
    Trainer passes ``runtime.raises_through``).
    """
    policy = policy or RestartPolicy()
    step = start_step
    metrics: Dict = {}
    while step < total_steps:
        try:
            metrics = step_fn(step)
            step += 1
        except KeyboardInterrupt:
            raise
        except Exception as e:
            if fatal is not None and fatal(e):
                raise
            backoff = policy.on_failure()
            log.error("step %d failed (%s); restoring (backoff %.2fs)", step, e, backoff)
            sleep(backoff)
            step = restore_fn()
    return metrics
