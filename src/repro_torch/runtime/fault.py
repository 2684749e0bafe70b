"""Fault tolerance (port of ``src/repro/runtime/fault.py``): preemption,
stragglers and rank death, host Python only.

* preemption: ``PreemptionGuard`` installs SIGTERM/SIGINT handlers that set
  a flag the servers poll once per step; the server then drains its steps
  in flight, writes a placement-tagged checkpoint (``ckpt_dir``) and returns
  with ``preempted=True`` (``runtime/server.py``).
* stragglers: a step-time watchdog keeps an EMA and flags outliers (>
  factor x EMA). A transient outlier never updates the EMA; a persistent
  slowdown (``rebase_after`` consecutive outliers, a new steady state such
  as thermal throttling) re-bases the EMA so the flag clears instead of
  firing forever. The servers surface it as
  ``ServeMetrics.stragglers_flagged`` and in their window rows
  (``stragglers_flagged``, ``watchdog_rebased``).
* rank death: ``FaultDetector`` watches per-rank heartbeats at serving-step
  boundaries and declares a rank dead after ``miss_threshold`` consecutive
  silent boundaries (or a wall-clock ``timeout_s``); a dead rank that
  heartbeats again is reported as rejoined. ``FaultInjector`` is the
  deterministic fault source of tests and benches: a step-keyed kill and
  rejoin schedule (per rank, or per fault domain) that suppresses the
  victims' heartbeats, so detection takes the path a transport error
  would. Recovery (a degraded placement on the survivors, the weights
  re-adopted from surviving replicas, a re-expand on a rejoin) is the
  job of the servers (``runtime/server.py``) and of ``core/placement.py
  run_rebalancing``. Over a ``DistComm`` each process runs its own
  detector; the servers fold every process's dead set and stop flag into
  one decision a boundary (``comm.DistComm.control_max``).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import NamedTuple


class DegradedRecovery(UserWarning):
    """A rank death that could not be absorbed with zero data loss (an
    expert had every replica on dead ranks: the server restores from a
    checkpoint or raises), or a placement that weakens the replica
    guarantee (a forced co-hosting of one expert's replicas, fault domains
    too uneven for the requested span). Always loud, never silent."""


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers; `should_stop` is polled per step."""

    def __init__(self):
        self._stop = False
        self._orig = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:      # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def restore(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)
        self._orig = {}


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


# --------------------------------------------------------------------------
# rank-death detection (elastic EP)
# --------------------------------------------------------------------------

class FaultReport(NamedTuple):
    """What one detector poll found: ranks newly declared dead and dead
    ranks that came back. Empty tuples = healthy boundary."""
    died: tuple[int, ...] = ()
    rejoined: tuple[int, ...] = ()

    def __bool__(self):
        return bool(self.died or self.rejoined)

    def merge(self, other: "FaultReport") -> "FaultReport":
        """Coalesce a later report into this one: the combined report the
        server treats as ONE fault event, so back-to-back detections within
        a single step boundary trigger one degraded-placement transition —
        one fingerprint bump, one handle rebuild, one weight adoption —
        instead of one per dead rank. A rank that died in one report and
        rejoined in the other cancels out (net no-op for the boundary);
        duplicates dedupe; order is normalized (sorted) since the merged
        report describes a set of simultaneous events, not a sequence."""
        died = (set(self.died) | set(other.died))
        rejoined = (set(self.rejoined) | set(other.rejoined))
        both = died & rejoined
        return FaultReport(tuple(sorted(died - both)),
                           tuple(sorted(rejoined - both)))


class FaultDetector:
    """Heartbeat/step-timeout rank-death detector, polled at serving-step
    boundaries.

    Each live rank calls ``heartbeat(rank, step)`` once per step (the servers
    forward heartbeats for every rank the ``FaultInjector`` says is alive;
    on a real pod the transport layer would). ``poll(step)`` then declares dead any rank silent for
    ``miss_threshold`` consecutive boundaries — strictly step-count based,
    so detection is deterministic for tests — optionally OR'd with a
    wall-clock ``timeout_s`` (the production knob: a rank pinned in a hung
    collective misses wall time before it misses steps). A dead rank whose
    heartbeat resumes is reported ``rejoined`` at the next poll. The
    detector only *reports*; placement shrink/expand is the caller's move.
    """

    def __init__(self, num_ranks: int, *, miss_threshold: int = 2,
                 timeout_s: float | None = None):
        if num_ranks < 1:
            raise ValueError(f"num_ranks={num_ranks} must be >= 1")
        if miss_threshold < 1:
            raise ValueError(f"miss_threshold={miss_threshold} must be >= 1")
        self.num_ranks = num_ranks
        self.miss_threshold = miss_threshold
        self.timeout_s = timeout_s
        self._last_step = {r: -1 for r in range(num_ranks)}
        self._last_time = {r: None for r in range(num_ranks)}
        self._dead: set[int] = set()

    def heartbeat(self, rank: int, step: int, now: float | None = None):
        if not 0 <= rank < self.num_ranks:
            raise ValueError(f"rank {rank} out of range [0, {self.num_ranks})")
        self._last_step[rank] = step
        self._last_time[rank] = time.perf_counter() if now is None else now

    def poll(self, step: int, now: float | None = None) -> FaultReport:
        """Evaluate liveness at a step boundary. A rank is dead when it has
        been silent for >= miss_threshold boundaries (a rank that NEVER
        heartbeat counts from step 0) or, with ``timeout_s``, when its last
        heartbeat is older than the timeout."""
        died, rejoined = [], []
        for r in range(self.num_ranks):
            missed = step - self._last_step[r]
            timed_out = missed >= self.miss_threshold
            if (not timed_out and self.timeout_s is not None
                    and self._last_time[r] is not None):
                t = time.perf_counter() if now is None else now
                timed_out = (t - self._last_time[r]) > self.timeout_s
            if r in self._dead:
                if not timed_out:
                    self._dead.discard(r)
                    rejoined.append(r)
            elif timed_out:
                self._dead.add(r)
                died.append(r)
        return FaultReport(tuple(died), tuple(rejoined))

    def set_dead(self, ranks):
        """Replace the dead set: a server over a ``DistComm`` hands every
        process's detector the set all of them agreed on, so the next poll
        reports rejoins and deaths against it."""
        self._dead = set(int(r) for r in ranks)

    @property
    def dead(self) -> tuple[int, ...]:
        return tuple(sorted(self._dead))

    @property
    def alive(self) -> tuple[int, ...]:
        return tuple(r for r in range(self.num_ranks) if r not in self._dead)


class FaultInjector:
    """Deterministic kill/rejoin schedule for tests and benches.

    ``kill``/``rejoin`` map a step index to the rank (or ranks) that die /
    come back AT that step boundary: ``advance(step)`` applies the events
    scheduled for ``step`` and returns them as a ``FaultReport`` (here
    "died" means *injected*, not yet detected — detection is the
    ``FaultDetector``'s job, fed by the injector suppressing the victims'
    heartbeats). Pure function of the schedule and the step sequence, so
    two runs over the same schedule produce identical event logs
    (``self.log``) — the determinism tests/benches rely on.

    Correlated (whole-domain) failures: ``kill_domains``/``rejoin_domains``
    schedule entire fault domains — ``{step: domain_id_or_ids}`` against the
    ``domains`` topology (`core/placement.FaultDomains`) — and expand to
    every rank in the domain dying/rejoining AT THE SAME step boundary (a
    pod losing power is one event, not a sequence). Expanded events merge
    with any per-rank schedule for the same step.
    """

    def __init__(self, num_ranks: int, *, kill=None, rejoin=None,
                 domains=None, kill_domains=None, rejoin_domains=None):
        self.num_ranks = num_ranks
        self.domains = domains
        if (kill_domains or rejoin_domains) and domains is None:
            raise ValueError(
                "kill_domains/rejoin_domains need the domains= topology "
                "(core/placement.FaultDomains) to expand to ranks")
        if domains is not None and domains.num_ranks != num_ranks:
            raise ValueError(f"domains cover {domains.num_ranks} ranks, "
                             f"injector spans num_ranks={num_ranks}")

        def norm(d):
            out = {}
            for step, ranks in (d or {}).items():
                rs = (ranks,) if isinstance(ranks, int) else tuple(ranks)
                for r in rs:
                    if not 0 <= r < num_ranks:
                        raise ValueError(
                            f"rank {r} out of range [0, {num_ranks})")
                out[int(step)] = rs
            return out

        def expand(dom_sched, rank_sched):
            for step, ds in (dom_sched or {}).items():
                ds = (ds,) if isinstance(ds, int) else tuple(ds)
                ranks = []
                for d in ds:
                    rs = domains.ranks_in(d)
                    if not rs:
                        raise ValueError(
                            f"domain {d} has no ranks in "
                            f"{domains.describe()}")
                    ranks.extend(rs)
                step = int(step)
                rank_sched[step] = tuple(dict.fromkeys(
                    rank_sched.get(step, ()) + tuple(ranks)))
            return rank_sched

        self.kill = expand(kill_domains, norm(kill))
        self.rejoin = expand(rejoin_domains, norm(rejoin))
        self._dead: set[int] = set()
        self.log: list[tuple[int, FaultReport]] = []

    def advance(self, step: int) -> FaultReport:
        killed = tuple(r for r in self.kill.get(step, ())
                       if r not in self._dead)
        rejoined = tuple(r for r in self.rejoin.get(step, ())
                         if r in self._dead)
        self._dead |= set(killed)
        self._dead -= set(rejoined)
        report = FaultReport(killed, rejoined)
        if report:
            self.log.append((step, report))
        return report

    def is_alive(self, rank: int) -> bool:
        return rank not in self._dead

    @property
    def dead_ranks(self) -> tuple[int, ...]:
        return tuple(sorted(self._dead))
