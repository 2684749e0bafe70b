"""``runtime/fault.py`` of the port against ``repro.runtime.fault``: every
case of the reference's ``tests/test_fault.py`` and the injector / report
cases of ``tests/test_fault_domains.py``, run on the port's classes and on
the reference's (parametrised over both), and each schedule's outcome held
equal across the two: the same reports, the same ``log``, the same dead and
alive sets, the same errors by type and message.
"""
import signal
import threading
import time

import numpy as np
import pytest

from repro.core import placement as JPL
from repro.runtime import fault as JF
from repro_torch.core import placement as TPL
from repro_torch.runtime import fault as TF

MODS = {"port": (TF, TPL), "jax": (JF, JPL)}
BOTH = pytest.mark.parametrize("pkg", list(MODS))


def outcome(fn):
    """fn's result, or its error as (type name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 - compared, not handled
        return (type(e).__name__, str(e))


def plain(x):
    """Reports and logs as plain tuples, comparable across the packages."""
    if isinstance(x, tuple) and hasattr(x, "died"):
        return ("report", tuple(x.died), tuple(x.rejoined))
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


# --------------------------------------------------------------------------
# PreemptionGuard
# --------------------------------------------------------------------------

@BOTH
def test_preemption_guard_install_signal_restore(pkg):
    F, _ = MODS[pkg]
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    g = F.PreemptionGuard()
    try:
        assert not g.should_stop
        for s in before:
            assert signal.getsignal(s) == g._handler
        signal.raise_signal(signal.SIGTERM)
        assert g.should_stop
    finally:
        g.restore()
    for s, h in before.items():
        assert signal.getsignal(s) == h
    g.restore()                      # idempotent
    for s, h in before.items():
        assert signal.getsignal(s) == h


@BOTH
def test_preemption_guard_non_main_thread_fallback(pkg):
    F, _ = MODS[pkg]
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    box = {}

    def build():
        g = F.PreemptionGuard()
        box["stop"] = g.should_stop
        box["orig"] = dict(g._orig)
        g.restore()

    t = threading.Thread(target=build)
    t.start()
    t.join()
    assert box["stop"] is False and box["orig"] == {}
    for s, h in before.items():
        assert signal.getsignal(s) == h


# --------------------------------------------------------------------------
# StragglerWatchdog, StepTimer
# --------------------------------------------------------------------------

def watchdog_runs(F):
    out = []
    w = F.StragglerWatchdog(factor=2.0)
    out.append([w.observe(1.0) for _ in range(10)] + [w.observe(5.0), w.observe(1.0)])
    out.append((w.flagged, w.consecutive, w.rebased, w.ema))
    w = F.StragglerWatchdog(factor=2.0, rebase_after=3)
    for _ in range(10):
        w.observe(1.0)
    out.append([w.observe(5.0) for _ in range(4)])
    out.append((w.flagged, w.rebased, w.ema))
    w = F.StragglerWatchdog(factor=2.0, rebase_after=3)
    for _ in range(10):
        w.observe(1.0)
    out.append([w.observe(v) for _ in range(5) for v in (5.0, 5.0, 1.0)])
    out.append((w.flagged, w.rebased, w.ema))
    return out


@BOTH
def test_watchdog_cases(pkg):
    F, _ = MODS[pkg]
    runs = watchdog_runs(F)
    assert runs[0][-2:] == [True, False] and runs[1][:3] == (1, 0, 0)
    assert abs(runs[1][3] - 1.0) < 1e-6
    assert runs[2] == [True, True, True, False] and runs[3][:2] == (3, 1)
    assert abs(runs[3][2] - 5.0) < 1e-6
    assert runs[5][:2] == (10, 0) and abs(runs[5][2] - 1.0) < 0.2


def test_watchdog_equal_reference():
    assert watchdog_runs(TF) == watchdog_runs(JF)


@BOTH
def test_step_timer(pkg):
    F, _ = MODS[pkg]
    t = F.StepTimer()
    with t:
        time.sleep(0.01)
    with t:
        pass
    assert len(t.times) == 2 and t.times[0] >= 0.01 and t.times[1] >= 0.0


# --------------------------------------------------------------------------
# FaultInjector, FaultDetector, FaultReport: each schedule on both packages
# --------------------------------------------------------------------------

def injector_schedule(F, P):
    inj = F.FaultInjector(4, kill={2: 1, 5: (0, 3)}, rejoin={7: 1})
    reports = [inj.advance(s) for s in range(10)]
    return dict(reports=reports, log=inj.log, dead=inj.dead_ranks,
                alive=[inj.is_alive(r) for r in range(4)])


def injector_edges(F, P):
    inj = F.FaultInjector(2, kill={0: 1, 3: 1}, rejoin={1: 0})
    return dict(reports=[inj.advance(s) for s in (0, 1, 3)],
                bad=outcome(lambda: F.FaultInjector(2, kill={0: 5})))


def detector_threshold(F, P):
    det = F.FaultDetector(3, miss_threshold=2)
    got = []
    for step in range(2):
        for r in range(3):
            det.heartbeat(r, step)
        got.append(det.poll(step))
    for step in (2, 3):
        for r in (0, 2):
            det.heartbeat(r, step)
        got.append(det.poll(step))
    got += [det.dead, det.alive, det.poll(4)]
    for r in range(3):
        det.heartbeat(r, 5)
    got += [det.poll(5), det.dead, det.alive]
    return dict(got=got)


def detector_never(F, P):
    det = F.FaultDetector(2, miss_threshold=2)
    det.heartbeat(0, 0)
    a = det.poll(0)
    det.heartbeat(0, 1)
    return dict(got=[a, det.poll(1)])


def detector_clock(F, P):
    det = F.FaultDetector(2, miss_threshold=100, timeout_s=1.0)
    det.heartbeat(0, 0, now=0.0)
    det.heartbeat(1, 0, now=0.0)
    a = det.poll(0, now=0.5)
    det.heartbeat(0, 1, now=2.0)
    b = det.poll(1, now=2.0)
    det.heartbeat(1, 2, now=2.5)
    return dict(got=[a, b, det.poll(2, now=2.5)])


def detector_validation(F, P):
    det = F.FaultDetector(2)
    return dict(errs=[outcome(lambda: F.FaultDetector(0)),
                      outcome(lambda: F.FaultDetector(2, miss_threshold=0)),
                      outcome(lambda: det.heartbeat(2, 0))])


def injector_feeds_detector(F, P):
    inj = F.FaultInjector(4, kill={3: 2}, rejoin={8: 2})
    det = F.FaultDetector(4, miss_threshold=2)
    events = []
    for step in range(12):
        inj.advance(step)
        for r in range(4):
            if inj.is_alive(r):
                det.heartbeat(r, step)
        rep = det.poll(step)
        if rep:
            events.append((step, rep))
    return dict(events=events)


def report_merge(F, P):
    a = F.FaultReport(died=(2, 5), rejoined=())
    b = F.FaultReport(died=(5, 7), rejoined=(2,))
    return dict(m=a.merge(b), cancel=bool(F.FaultReport((3,), ()).merge(F.FaultReport((), (3,)))),
                empty=F.FaultReport().merge(F.FaultReport()) == F.FaultReport())


def kill_domains(F, P):
    dom = P.domains_from_geometry(8, 4)
    inj = F.FaultInjector(8, domains=dom, kill_domains={3: 1}, rejoin_domains={7: 1},
                          kill={3: 0})
    kill3 = inj.kill[3]
    reports = [inj.advance(s) for s in (3, 5, 7)]
    dead = inj.dead_ranks
    inj2 = F.FaultInjector(8, domains=dom, kill_domains={3: 1}, rejoin_domains={7: 1},
                           kill={3: 0})
    for s in range(8):
        inj2.advance(s)
    return dict(kill3=kill3, reports=reports, dead=dead, same_log=inj2.log == inj.log,
                log=inj.log,
                errs=[outcome(lambda: F.FaultInjector(8, kill_domains={0: 1})),
                      outcome(lambda: F.FaultInjector(8, domains=P.trivial_domains(4),
                                                      kill_domains={0: 1}))])


SCHEDULES = {f.__name__: f for f in (
    injector_schedule, injector_edges, detector_threshold, detector_never, detector_clock,
    detector_validation, injector_feeds_detector, report_merge, kill_domains)}

R = lambda died=(), rejoined=(): ("report", died, rejoined)  # noqa: E731
EXPECT = {
    "injector_schedule": lambda o: (
        o["reports"][2] == R((1,)) and o["reports"][5] == R((0, 3))
        and o["reports"][7] == R((), (1,))
        and all(r == R() for i, r in enumerate(o["reports"]) if i not in (2, 5, 7))
        and o["dead"] == (0, 3) and o["alive"] == [False, True, True, False]
        and [s for s, _ in o["log"]] == [2, 5, 7]),
    "injector_edges": lambda o: (o["reports"] == [R((1,)), R(), R()]
                                 and o["bad"][0] == "ValueError"
                                 and "out of range" in o["bad"][1]),
    "detector_threshold": lambda o: (
        o["got"] == [R(), R(), R(), R((1,)), (1,), (0, 2), R(), R((), (1,)), (), (0, 1, 2)]),
    "detector_never": lambda o: o["got"] == [R(), R((1,))],
    "detector_clock": lambda o: o["got"] == [R(), R((1,)), R((), (1,))],
    "detector_validation": lambda o: (
        [e[0] for e in o["errs"]] == ["ValueError"] * 3
        and "num_ranks" in o["errs"][0][1] and "miss_threshold" in o["errs"][1][1]
        and "out of range" in o["errs"][2][1]),
    "injector_feeds_detector": lambda o: o["events"] == [(4, R((2,))), (8, R((), (2,)))],
    "report_merge": lambda o: o["m"] == R((5, 7)) and not o["cancel"] and o["empty"],
    "kill_domains": lambda o: (
        o["kill3"] == (0, 4, 5, 6, 7) and o["reports"] == [R((0, 4, 5, 6, 7)), R(),
                                                           R((), (4, 5, 6, 7))]
        and o["dead"] == (0,) and o["same_log"]
        and "need the domains" in o["errs"][0][1] and "domains cover" in o["errs"][1][1]),
}


@BOTH
@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule(case, pkg):
    """The reference test's assertions, on either package."""
    assert EXPECT[case](plain(SCHEDULES[case](*MODS[pkg])))


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_equal_reference(case):
    """The same schedule on both packages: the same reports, log, sets and
    errors (type and message)."""
    assert plain(SCHEDULES[case](TF, TPL)) == plain(SCHEDULES[case](JF, JPL))


def test_determinism_two_runs():
    for case in ("injector_schedule", "injector_feeds_detector", "kill_domains"):
        assert plain(SCHEDULES[case](TF, TPL)) == plain(SCHEDULES[case](TF, TPL))


def test_set_dead_drives_the_next_poll():
    """The port's one addition: ``set_dead`` hands a detector the dead set
    every process of a DistComm agreed on; a rank set dead that heartbeats
    is reported rejoined at the next poll, one that stays silent is not
    reported again."""
    det = TF.FaultDetector(4, miss_threshold=2)
    for r in range(4):
        det.heartbeat(r, 0)
    assert not det.poll(0)
    det.set_dead([np.int64(1), 3])
    assert det.dead == (1, 3) and det.alive == (0, 2)
    for step in (1, 2):
        for r in (0, 1, 2):
            det.heartbeat(r, step)
    assert plain(det.poll(2)) == R((), (1,))
    assert det.dead == (3,)
