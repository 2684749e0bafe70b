"""Host-side serving telemetry: a step-timeline tracer and a per-step time
series (port of ``src/repro/runtime/telemetry.py``, the same names and
contracts; plain Python, no torch).

* ``Tracer`` records named spans and instant events at step boundaries the
  servers already have (``prefill``, ``serve_step``, ``admission``; the
  scheduler's ``admit`` and ``complete`` instants; the EPLB hook's
  ``rebalance``, ``adopt`` and ``drain`` spans, ``placement_swap`` instant
  and ``rank_imbalance`` counter; the watchdog's ``straggler`` and
  ``watchdog_rebase`` instants) and exports Chrome-trace / Perfetto JSON.
  The reference's fault spans come with those paths (ROADMAP A10b).
* ``TimeSeries`` records rows (the continuous server: one per step, with
  ITL, queue depth, active slots, pages live and peak; both servers: one
  per heat window, with its heat, per-rank loads and imbalance) and
  exports JSONL.

Hard contracts (``tests/test_torch_telemetry.py``):

* **Host-side only, boundary-scoped.** Telemetry adds no device sync: spans
  wrap host code at existing step boundaries, and a captured step stays one
  graph replay. Token streams are bitwise identical with tracing on or off.
* **Disabled is a no-op.** ``NULL_TRACER`` / ``NULL_SERIES`` are shared
  singletons whose methods allocate nothing per step (``span`` returns one
  shared no-op context manager; ``record`` returns at once).
* **Deterministic tests.** The clock is injectable (a monotonic callable
  returning seconds); tests drive a fake clock and assert exact durations.

Over a ``DistComm`` each process keeps its own tracer and series, on its
own clock.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Callable, Iterable


def json_safe(obj):
    """Recursively coerce numpy and torch scalars and arrays (and other
    non-JSON leaves) into plain Python so ``json.dumps`` succeeds on metrics
    payloads. A tensor on the card is read back: call it at export time,
    never inside a step."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    # numpy scalars expose .item(); arrays and tensors (0-dim ones too)
    # expose .tolist()
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):
        return json_safe(obj.item())
    if hasattr(obj, "tolist"):
        return json_safe(obj.tolist())
    return str(obj)


class _NullSpan:
    """Shared no-op context manager handed out by a disabled tracer."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one complete ("X") Chrome-trace event."""
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        tr._events.append(("X", self._name, self._t0,
                           tr.clock() - self._t0, self._args))
        return False


class Tracer:
    """Named spans + instant events with an injectable monotonic clock.

    Events are stored as host tuples ``(ph, name, t_s, dur_s, args)`` and
    exported as Chrome-trace JSON (``ts``/``dur`` in microseconds relative
    to the tracer's construction time), loadable in Perfetto / chrome://tracing.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 pid: int = 0, tid: int = 0):
        self.clock = clock
        self.pid = pid
        self.tid = tid
        self._t0 = clock()
        self._events: list[tuple] = []   # (ph, name, t_s, dur_s, args)

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **args) -> _Span:
        """Context manager timing a named host-side region."""
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        self._events.append(("i", name, self.clock(), 0.0, args))

    def counter(self, name: str, value: float) -> None:
        self._events.append(("C", name, self.clock(), 0.0, {"value": value}))

    # -- export ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> list[tuple]:
        return list(self._events)

    def summary(self) -> dict:
        """Per-name aggregate (count + total seconds for spans) folded into
        ``ServeMetrics.timeline``. JSON-safe by construction."""
        out: dict[str, dict] = {}
        for ph, name, _t, dur, _a in self._events:
            row = out.setdefault(name, {"count": 0, "total_s": 0.0, "ph": ph})
            row["count"] += 1
            if ph == "X":
                row["total_s"] = round(row["total_s"] + float(dur), 9)
        return out

    def to_chrome_trace(self) -> dict:
        ev = []
        for ph, name, t, dur, args in self._events:
            e = {"name": name, "ph": ph, "pid": self.pid, "tid": self.tid,
                 "ts": round((t - self._t0) * 1e6, 3)}
            if ph == "X":
                e["dur"] = round(dur * 1e6, 3)
            if ph == "i":
                e["s"] = "t"                      # thread-scoped instant
            if args:
                e["args"] = json_safe(args)
            ev.append(e)
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome_trace()))
        return path


class NullTracer:
    """Disabled tracer: every method is a no-op with no per-call allocation
    (``span`` returns one shared context-manager object)."""

    enabled = False

    def span(self, name, **args):
        return _NULL_SPAN

    def instant(self, name, **args):
        return None

    def counter(self, name, value):
        return None

    def __len__(self):
        return 0

    def events(self):
        return []

    def summary(self):
        return {}

    def to_chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = NullTracer()


class TimeSeries:
    """Append-only recorder of per-window metric rows (plain dicts)."""

    enabled = True

    def __init__(self):
        self.rows: list[dict] = []

    def record(self, **fields) -> None:
        self.rows.append(json_safe(fields))

    def __len__(self) -> int:
        return len(self.rows)

    def to_jsonl(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            for row in self.rows:
                f.write(json.dumps(row) + "\n")
        return path


class NullTimeSeries:
    """Disabled series: ``record`` returns immediately, ``rows`` stays ()."""

    enabled = False
    rows: tuple = ()

    def record(self, **fields):
        return None

    def __len__(self):
        return 0


NULL_SERIES = NullTimeSeries()


def validate_chrome_trace(obj: dict) -> list[dict]:
    """Assert ``obj`` is well-formed Chrome-trace JSON; return its events.

    Checks the event-format invariants CI relies on: a ``traceEvents`` list;
    every event has ``name``/``ph``/``pid``/``tid``/``ts`` with ``ph`` in
    {X, i, C}; ``ts >= 0`` and ``dur >= 0``; and complete ("X") spans
    properly NEST per (pid, tid) — a span either contains or is disjoint
    from every other span on its track (no partial overlap).
    """
    assert isinstance(obj, dict), f"trace root must be a dict, got {type(obj)}"
    events = obj.get("traceEvents")
    assert isinstance(events, list), "trace must carry a traceEvents list"
    tracks: dict[tuple, list[tuple]] = {}
    for i, e in enumerate(events):
        assert isinstance(e, dict), f"event {i} is not an object: {e!r}"
        for key in ("name", "ph", "pid", "tid", "ts"):
            assert key in e, f"event {i} missing {key!r}: {e!r}"
        assert e["ph"] in ("X", "i", "C"), f"event {i} bad ph: {e['ph']!r}"
        assert e["ts"] >= 0, f"event {i} negative ts: {e['ts']}"
        if e["ph"] == "X":
            assert "dur" in e, f"span event {i} missing dur: {e!r}"
            assert e["dur"] >= 0, f"event {i} negative dur: {e['dur']}"
            tracks.setdefault((e["pid"], e["tid"]), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    eps = 1e-6        # µs rounding slack from the 3-decimal export
    for track, spans in tracks.items():
        # sort by start asc, end desc: a containing span sorts before its
        # children, so a containment stack detects partial overlap.
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list[tuple] = []
        for t0, t1, name in spans:
            while stack and t0 >= stack[-1][1] - eps:
                stack.pop()
            if stack:
                assert t1 <= stack[-1][1] + eps, (
                    f"track {track}: span {name!r} [{t0}, {t1}] partially "
                    f"overlaps {stack[-1][2]!r} [{stack[-1][0]}, "
                    f"{stack[-1][1]}] — spans must nest")
            stack.append((t0, t1, name))
    return events


def load_chrome_trace(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def span_names(events: Iterable[dict]) -> list[str]:
    """Names of complete ("X") events, in file order."""
    return [e["name"] for e in events if e.get("ph") == "X"]


__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER",
    "TimeSeries", "NullTimeSeries", "NULL_SERIES",
    "json_safe", "validate_chrome_trace", "load_chrome_trace", "span_names",
]
