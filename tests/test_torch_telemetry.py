"""Serving telemetry in the port (``runtime/telemetry.py`` and the servers'
hooks) against the JAX package's, on the CPU.

* The port's ``Tracer`` and the reference's, driven by the same fake clock
  and the same calls, give equal events, summaries and Chrome traces; each
  validator accepts the other's trace and rejects the same malformed ones;
  a span survives an exception; the null singletons are no-ops;
  ``ServeMetrics.as_dict`` and ``TimeSeries.to_jsonl`` take numpy and torch
  scalars.
* Both port servers on DBRX's and DeepSeek-V3's smoke configs: token
  streams bitwise equal with tracing on and off; the timeline's counts (one
  ``serve_step`` and one ``admission`` a step, one ``admit`` and one
  ``complete`` a request, one ``prefill``) and the continuous server's
  series rows (all but the clock's ``itl_s``) equal to the reference
  server's on the same requests; the capture guard of
  ``tests/test_torch_decode.py`` holds on traced serves.
* ``ContinuousDecodeServer(comm=DistComm)`` over four gloo processes: each
  process's tracer records its own steps, every process the same counts
  and rows, and the streams are bitwise equal with tracing on and off.

The spawned workers import this module by name, so it imports no JAX at
its top: the reference (whose package imports JAX) is imported inside the
tests.
"""
import dataclasses
import datetime
import json

import numpy as np
import pytest
import torch

from repro_torch.comm import DistComm
from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import init_process, spawn
from repro_torch.runtime import telemetry as port_telemetry
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer, ServeMetrics
from repro_torch.runtime.telemetry import (NULL_SERIES, NULL_TRACER, NullTimeSeries,
                                           NullTracer, TimeSeries, Tracer, json_safe,
                                           load_chrome_trace, span_names,
                                           validate_chrome_trace)
from repro_torch.weights import init_params
from test_torch_decode import guarded
from test_torch_dist import config

ARCHS = ["dbrx-132b", "deepseek-v3-671b"]
SLOTS, MAX_LEN, PAGE = 4, 32, 4
PROMPT, GEN = 4, 6
N = 4
WORLD = (("data", N),)
TIMEOUT = datetime.timedelta(seconds=60)
# the port's span and instant names; both servers' straggler watchdogs add
# instants of their own, which the host clock drives: the span counts leave
# them out
PORT_NAMES = {"prefill", "serve_step", "admission", "admit", "complete"}
WATCHDOG = {"straggler", "watchdog_rebase"}


def reference():
    """The JAX package's telemetry module (its package imports JAX)."""
    from repro.runtime import telemetry
    return telemetry


class FakeClock:
    """Injectable monotonic clock: advances only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


def drive(mod, clk: FakeClock):
    """The same calls on ``mod``'s Tracer: nested spans, instants with numpy
    args, a counter, a serve loop's boundaries."""
    tr = mod.Tracer(clock=clk, pid=7, tid=3)
    with tr.span("outer", step=0):
        clk.tick(0.002)
        with tr.span("inner"):
            clk.tick(0.001)
        tr.instant("mark", rid=np.int64(5))
        tr.counter("queue_depth", 4)
        clk.tick(0.0005)
    for step in range(3):
        with tr.span("admission"):
            tr.instant("admit", rid=step, step=step, slot=step, queued=np.int32(2 - step))
            clk.tick(0.0001)
        with tr.span("serve_step"):
            clk.tick(0.01)
    tr.instant("complete", rid=0, tokens=3)
    return tr


# --------------------------------------------------------------------------
# the tracer and series against the reference's
# --------------------------------------------------------------------------

def test_tracer_matches_reference(tmp_path):
    ref = reference()
    got, want = drive(port_telemetry, FakeClock()), drive(ref, FakeClock())
    assert len(got) == len(want) == 14
    assert got.events() == want.events()
    assert got.summary() == want.summary()
    doc = got.to_chrome_trace()
    assert doc == want.to_chrome_trace()
    ev = ref.validate_chrome_trace(doc)
    assert validate_chrome_trace(doc) == ev
    by_name = {e["name"]: e for e in ev}
    assert by_name["inner"]["ts"] == 2000.0 and by_name["inner"]["dur"] == 1000.0
    assert by_name["outer"]["ts"] == 0.0 and by_name["outer"]["dur"] == 3500.0
    assert by_name["mark"]["args"] == {"rid": 5} and by_name["mark"]["s"] == "t"
    assert got.summary()["serve_step"] == {"count": 3, "total_s": 0.03, "ph": "X"}
    p = got.write_chrome_trace(tmp_path / "trace.json")
    assert span_names(validate_chrome_trace(load_chrome_trace(p))) == \
        ref.span_names(ref.validate_chrome_trace(ref.load_chrome_trace(p)))


def _bad(**e):
    base = {"name": "a", "ph": "X", "pid": 0, "tid": 0, "ts": 0.0, "dur": 10.0}
    return base | e


MALFORMED = {
    "partial_overlap": [_bad(), _bad(name="b", ts=5.0)],
    "negative_dur": [_bad(dur=-1.0)],
    "missing_ts": [{k: v for k, v in _bad().items() if k != "ts"}],
    "bad_ph": [_bad(ph="B")],
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_validation_rejects_malformed(case):
    """Each validator rejects the same malformed traces: spans that overlap
    without nesting, a negative duration, a missing key, an unknown phase."""
    doc = {"traceEvents": MALFORMED[case]}
    with pytest.raises(AssertionError):
        validate_chrome_trace(doc)
    with pytest.raises(AssertionError):
        reference().validate_chrome_trace(doc)


def test_span_survives_exception_and_still_validates():
    clk = FakeClock()
    tr = Tracer(clock=clk)
    with pytest.raises(RuntimeError):
        with tr.span("boundary"):
            clk.tick(0.001)
            raise RuntimeError("mid-boundary failure")
    ev = validate_chrome_trace(tr.to_chrome_trace())
    assert span_names(ev) == ["boundary"] and ev[0]["dur"] == 1000.0


def test_null_tracer_and_series_are_noops():
    tr = NullTracer()
    assert not tr.enabled and not NULL_TRACER.enabled
    s1, s2 = tr.span("serve_step", step=0), NULL_TRACER.span("admission")
    assert s1 is s2                       # one shared span: no per-step allocation
    with s1:
        pass
    tr.instant("x")
    tr.counter("y", 1.0)
    assert len(tr) == 0 and tr.summary() == {} and tr.events() == []
    assert tr.to_chrome_trace()["traceEvents"] == []
    ns = NullTimeSeries()
    ns.record(kind="step", itl_s=1.0)
    assert ns.rows == () and len(ns) == 0 and not ns.enabled and not NULL_SERIES.enabled


def test_as_dict_and_jsonl_take_numpy_and_torch(tmp_path):
    """timeline and series land in as_dict() as JSON, numpy and torch leaves
    coerced; the series' JSONL equals the reference's."""
    m = ServeMetrics(
        ttft_s=np.float64(0.1), itl_mean_s=torch.tensor(0.01), itl_p99_s=0.02,
        output_tok_s=np.float32(123.0), total_tokens=torch.tensor(64),
        timeline={"serve_step": {"count": np.int64(8), "total_s": np.float64(0.08),
                                 "ph": "X"}},
        series=[{"kind": "step", "itl_s": np.float32(0.01), "active": torch.tensor(3),
                 "rank_loads": np.arange(4), "heat": torch.arange(3)}])
    out = json.loads(json.dumps(m.as_dict()))
    assert out["timeline"]["serve_step"]["count"] == 8 and out["total_tokens"] == 64
    assert out["series"][0]["rank_loads"] == [0, 1, 2, 3] and out["series"][0]["heat"] == [0, 1, 2]
    assert out["series"][0]["active"] == 3
    assert json_safe(np.bool_(True)) in (True, 1) and json_safe(torch.tensor(True)) is True
    rows = [dict(kind="step", step=i, itl_s=np.float64(0.5 * i), active=torch.tensor(i))
            for i in range(3)]
    se, rse = TimeSeries(), reference().TimeSeries()
    for r in rows:
        se.record(**r)
        rse.record(**{k: (v.item() if isinstance(v, torch.Tensor) else v) for k, v in r.items()})
    assert se.to_jsonl(tmp_path / "a.jsonl").read_text() == \
        rse.to_jsonl(tmp_path / "b.jsonl").read_text()


# --------------------------------------------------------------------------
# the servers: tracing on and off, against the reference server's timeline
# --------------------------------------------------------------------------

def specs(vocab: int) -> list:
    """(rid, prompt, new tokens, arrival step) of seven requests from a seed."""
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, vocab, int(rng.integers(1, 6))).astype(np.int32),
             int(rng.integers(2, 7)), a) for i, a in enumerate([0, 0, 1, 1, 2, 4, 6])]


def requests(cls, vocab: int) -> list:
    return [cls(rid, p, n, arrival_step=a) for rid, p, n, a in specs(vocab)]


def prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(4).integers(0, vocab, (SLOTS, PROMPT)).astype(np.int32)


def port_serve(cfg, params, kind: str, traced: bool, guard: bool = False, comm=None):
    """One serve of ``kind`` (fixed or continuous) on the port, with a
    Tracer and TimeSeries or without. Returns (streams, metrics, tracer,
    the capture guard's findings)."""
    tr, se = (Tracer(), TimeSeries()) if traced else (None, None)
    cls = DecodeServer if kind == "fixed" else ContinuousDecodeServer
    kw = {} if kind == "fixed" else dict(page_size=PAGE)
    srv = cls(cfg, SLOTS, MAX_LEN, params=params, device="cpu", comm=comm, tracer=tr,
              series=se, **kw)
    g = guarded(srv) if guard else None
    if kind == "fixed":
        m = srv.serve(prompts(cfg.vocab), GEN)
        streams = srv.last_tokens
    else:
        m = srv.serve_requests(requests(Request, cfg.vocab))
        streams = {rid: srv.reqsched.tokens_for(rid) for rid in sorted(srv.reqsched.finished)}
    srv.close()
    return streams, m, tr, (g.bad if g else None)


def counts(timeline: dict) -> dict:
    return {k: (v["count"], v["ph"]) for k, v in timeline.items() if k not in WATCHDOG}


def jax_timeline(arch: str, kind: str):
    """The reference server's timeline and series on the same requests."""
    from repro.configs import get_smoke as j_smoke
    from repro.runtime.scheduler import Request as JRequest
    from repro.runtime.server import ContinuousDecodeServer as JContinuous
    from repro.runtime.server import DecodeServer as JServer
    ref = reference()
    jcfg = j_smoke(arch)
    tr, se = ref.Tracer(), ref.TimeSeries()
    if kind == "fixed":
        srv = JServer(jcfg, batch=SLOTS, max_len=MAX_LEN, tracer=tr, series=se)
        try:
            m = srv.serve(prompts(jcfg.vocab), GEN)
        finally:
            srv.close()
    else:
        srv = JContinuous(jcfg, batch=SLOTS, max_len=MAX_LEN, page_size=PAGE, tracer=tr,
                          series=se)
        try:
            m = srv.serve_requests(requests(JRequest, jcfg.vocab))
        finally:
            srv.close()
    return m


def no_clock(rows) -> list:
    return [{k: v for k, v in r.items() if k != "itl_s"} for r in rows or []]


@pytest.mark.parametrize("kind", ["fixed", "continuous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tracing_on_off_bitwise_and_matches_reference(arch, kind):
    cfg = get_smoke(arch)
    params = init_params(cfg, 0, "cpu")
    off, m_off, _, _ = port_serve(cfg, params, kind, traced=False)
    on, m_on, tr, bad = port_serve(cfg, params, kind, traced=True, guard=True)
    assert bad == [], f"host syncs inside a traced {kind} step: {bad}"
    if kind == "fixed":
        np.testing.assert_array_equal(on, off)
    else:
        assert on.keys() == off.keys() == set(range(7))
        for rid in on:
            np.testing.assert_array_equal(on[rid], off[rid])
        assert m_on.serve_steps == m_off.serve_steps
    assert m_off.timeline is None and m_off.series is None
    ev = validate_chrome_trace(tr.to_chrome_trace())
    reference().validate_chrome_trace(tr.to_chrome_trace())
    got = counts(m_on.timeline)
    assert set(got) <= PORT_NAMES
    if kind == "fixed":
        assert got == {"prefill": (1, "X"), "serve_step": (GEN, "X")}
        assert m_on.series is None
        assert [e["args"] for e in ev if e["name"] == "prefill"] == [{"tokens": PROMPT}]
    else:
        steps, n = m_on.serve_steps, len(on)
        assert got == {"admission": (steps, "X"), "serve_step": (steps, "X"),
                       "admit": (n, "i"), "complete": (n, "i")}
        assert [r["step"] for r in m_on.series] == list(range(steps))
        assert all(r["kind"] == "step" and r["itl_s"] > 0 for r in m_on.series)
        assert max(r["pages_live"] for r in m_on.series) <= m_on.pages_peak
        assert m_on.series[-1]["pages_peak"] == m_on.pages_peak
    json.dumps(m_on.as_dict())
    want = jax_timeline(arch, kind)
    ref_counts = counts(want.timeline)
    assert set(ref_counts) - set(got) <= WATCHDOG
    assert {k: ref_counts[k] for k in got} == got
    assert no_clock(m_on.series) == no_clock(want.series)
    if kind == "continuous":
        assert m_on.serve_steps == want.serve_steps


# --------------------------------------------------------------------------
# one process per rank: each keeps its own tracer
# --------------------------------------------------------------------------

def dist_worker(rank: int, world: int, init_method: str) -> dict:
    torch.set_num_threads(1)
    init_process(WORLD, "cpu", init_method, rank=rank, world=world, timeout=TIMEOUT)
    comm = DistComm(WORLD, timeout=TIMEOUT)
    cfg = dataclasses.replace(config("dbrx"), d_model=64)
    params = init_params(cfg, 0, "cpu", comm=comm)
    out = {}
    for kind in ("fixed", "continuous"):
        for traced in (False, True):
            streams, m, tr, _ = port_serve(cfg, params, kind, traced, comm=comm)
            out[kind, traced] = dict(
                streams=streams, steps=m.serve_steps, timeline=m.timeline,
                series=no_clock(m.series), trace=tr.to_chrome_trace() if tr else None,
                itls=[r["itl_s"] for r in m.series or []])
    return out


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    return spawn(dist_worker, N, timeout=180, workdir=tmp_path_factory.mktemp("telemetry"))


@pytest.mark.parametrize("kind", ["fixed", "continuous"])
def test_dist_comm_tracers_per_process(dist_runs, kind):
    """Over four gloo processes: streams bitwise equal with tracing on and
    off in every process; each process's tracer holds its own well-formed
    timeline with one serve_step a step; every process the same counts and
    series rows (but the clock's)."""
    first = dist_runs[0][kind, True]
    for r in dist_runs:
        on, off = r[kind, True], r[kind, False]
        if kind == "fixed":
            np.testing.assert_array_equal(on["streams"], off["streams"])
            np.testing.assert_array_equal(on["streams"], first["streams"])
        else:
            assert on["streams"].keys() == off["streams"].keys() == set(range(7))
            for rid in on["streams"]:
                np.testing.assert_array_equal(on["streams"][rid], off["streams"][rid])
                np.testing.assert_array_equal(on["streams"][rid], first["streams"][rid])
        ev = validate_chrome_trace(on["trace"])
        c = counts(on["timeline"])
        assert c == counts(first["timeline"])
        assert on["series"] == first["series"] and off["timeline"] is None
        if kind == "fixed":
            assert c == {"prefill": (1, "X"), "serve_step": (GEN, "X")}
        else:
            assert c["serve_step"] == c["admission"] == (on["steps"], "X")
            assert c["admit"] == c["complete"] == (7, "i")
            assert len(on["series"]) == on["steps"] and all(t > 0 for t in on["itls"])
        assert span_names(ev).count("serve_step") == c["serve_step"][0]
