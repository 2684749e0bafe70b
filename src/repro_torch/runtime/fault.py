"""Fault tolerance, its first half (port of the step-time watchdog of
``src/repro/runtime/fault.py``): ``StragglerWatchdog``, ``StepTimer`` and
the ``DegradedRecovery`` warning that the placement policy raises when a
table must co-host replicas of one expert.

Rank-death detection (``FaultDetector``), the deterministic fault injector,
the preemption guard and the shrink/expand recovery of the servers are
ROADMAP A10b.

* stragglers: a step-time watchdog keeps an EMA and flags outliers (>
  factor x EMA). A transient outlier never updates the EMA; a persistent
  slowdown (``rebase_after`` consecutive outliers, a new steady state such
  as thermal throttling) re-bases the EMA so the flag clears instead of
  firing forever. The servers surface it as
  ``ServeMetrics.stragglers_flagged`` and in their window rows
  (``stragglers_flagged``, ``watchdog_rebased``).
"""
from __future__ import annotations

import dataclasses
import time


class DegradedRecovery(UserWarning):
    """A placement or a recovery that weakens the replica guarantee: a
    forced co-hosting of one expert's replicas, or fault domains too uneven
    for the requested span. Always loud, never silent."""


@dataclasses.dataclass
class StragglerWatchdog:
    """EMA step-time monitor; ``observe`` returns True when the step is an
    outlier (> factor x EMA). Transient outliers never update the EMA; a
    slowdown that persists for ``rebase_after`` consecutive steps re-bases
    the EMA to the mean of that outlier run. ``flagged`` / ``rebased`` are
    the counters the servers surface; with a ``tracer`` each flag and
    rebase also lands on the timeline as an instant (``straggler`` /
    ``watchdog_rebase``)."""
    factor: float = 2.5
    decay: float = 0.9
    rebase_after: int = 5
    ema: float | None = None
    flagged: int = 0
    rebased: int = 0
    consecutive: int = 0
    _outlier_sum: float = 0.0
    tracer: object | None = None

    def observe(self, step_time: float) -> bool:
        if self.ema is None:
            self.ema = step_time
            return False
        outlier = step_time > self.factor * self.ema
        if outlier:
            self.flagged += 1
            self.consecutive += 1
            self._outlier_sum += step_time
            if self.tracer is not None:
                self.tracer.instant("straggler", step_time_s=step_time,
                                    ema_s=self.ema, consecutive=self.consecutive)
            if self.consecutive >= self.rebase_after:
                # persistent new steady state: re-base on the outlier run
                self.ema = self._outlier_sum / self.consecutive
                self.rebased += 1
                self.consecutive = 0
                self._outlier_sum = 0.0
                if self.tracer is not None:
                    self.tracer.instant("watchdog_rebase", new_ema_s=self.ema,
                                        rebased=self.rebased)
        else:
            self.consecutive = 0
            self._outlier_sum = 0.0
            self.ema = self.decay * self.ema + (1 - self.decay) * step_time
        return outlier


class StepTimer:
    """Context manager appending each block's wall seconds to ``times``."""

    def __init__(self):
        self.t0 = None
        self.times = []

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.times.append(time.perf_counter() - self.t0)
