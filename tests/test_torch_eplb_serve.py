"""Both servers with EPLB (``rebalance_every``, ``num_redundant_experts``,
``track_expert_heat``) against the JAX package's servers on the same
config, weights and inputs: DBRX's smoke config in f32, EP over 8 ranks
(``LocalComm(8)`` against a mesh of 8 fake devices), in the logical and
the adopt-once physical weight layout.

* token streams equal to JAX's, and to the port's serve without EPLB;
* the sequence of adopted placements equal (tables, versions,
  fingerprints);
* ``ServeMetrics``' heat fields within 1e-6;
* traced: the same span names (the clock-driven watchdog instants apart)
  and series-row keys as JAX's traced run, the window rows' heat values
  equal; streams bitwise equal with tracing on and off;
* the capture guard: a placed step with the heat update passes the no-
  host-sync guard; a real swap keeps the heat counter's tensor and the
  step cache bounded to {current, previous}.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro.runtime import telemetry as jtel
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.server import ContinuousDecodeServer as JContinuous
from repro.runtime.server import DecodeServer as JServer
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.core import placement as TPL
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
from repro_torch.runtime.steps import CompiledStep
from repro_torch.runtime.telemetry import TimeSeries, Tracer
from repro_torch.weights import params_from_jax
from test_torch_decode import guard_config, guarded

N, B, MAX_LEN, PROMPT, GEN, EVERY, R = 8, 16, 24, 4, 8, 4, 8
PAGE = 4
WATCHDOG = {"straggler", "watchdog_rebase"}
HEAT_KEYS = ("window_tokens", "heat_max_mean", "imbalance", "rank_loads",
             "placements_adopted", "kind", "step")


def mesh():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


def heat_cfgs(physical: bool):
    def f(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, track_expert_heat=True, params_physical=physical))
    return (f(dataclasses.replace(jax_smoke(), dtype=jnp.float32)),
            f(dataclasses.replace(smoke_config(), dtype=torch.float32)))


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = heat_cfgs(False)
    return jax.device_get(init_from_specs(jax.random.PRNGKey(0), jax_lm_spec(jcfg)))


def prompts(vocab):
    return np.random.default_rng(3).integers(0, vocab, (B, PROMPT)).astype(np.int32)


def requests(cls, vocab):
    rng = np.random.default_rng(5)
    return [cls(i, rng.integers(0, vocab, int(rng.integers(1, 6))).astype(np.int32),
                int(rng.integers(2, 8)), arrival_step=a)
            for i, a in enumerate([0, 0, 0, 1, 1, 2, 3, 3, 5, 6, 8, 9])]


def placements_of(pls):
    return [(p.slot_expert, p.version, p.fingerprint()) for p in pls]


def jax_serve(kind, physical, tree):
    jcfg, _ = heat_cfgs(physical)
    params = jax.tree.map(jnp.array, tree)          # the server may donate them
    tr, se = jtel.Tracer(), jtel.TimeSeries()
    kw = dict(batch=B, max_len=MAX_LEN, mesh=mesh(), params=params, rebalance_every=EVERY,
              num_redundant_experts=R, tracer=tr, series=se)
    if kind == "fixed":
        srv = JServer(jcfg, **kw)
        box = {}
        decode = srv.decode

        def keep(*a):
            box["toks"] = decode(*a)
            return box["toks"]
        srv.decode = keep
        try:
            m = srv.serve(jnp.asarray(prompts(jcfg.vocab)), GEN)
        finally:
            srv.close()
        streams = np.asarray(box["toks"][0])
    else:
        srv = JContinuous(jcfg, page_size=PAGE, **kw)
        try:
            m = srv.serve_requests(requests(JRequest, jcfg.vocab))
        finally:
            srv.close()
        streams = {rid: np.asarray(srv.reqsched.tokens_for(rid))
                   for rid in sorted(srv.reqsched.finished)}
    return streams, m, placements_of(srv.placements)


def port_serve(kind, cfg, params, traced, eplb=True, guard=False):
    tr, se = (Tracer(), TimeSeries()) if traced else (None, None)
    kw = dict(ep_size=N, params=params, device="cpu", tracer=tr, series=se)
    if eplb:
        kw.update(rebalance_every=EVERY, num_redundant_experts=R)
    if kind == "fixed":
        srv = DecodeServer(cfg, B, MAX_LEN, **kw)
        g = guarded(srv) if guard else None
        m = srv.serve(prompts(cfg.vocab), GEN)
        streams = srv.last_tokens
    else:
        srv = ContinuousDecodeServer(cfg, B, MAX_LEN, page_size=PAGE, **kw)
        g = guarded(srv) if guard else None
        m = srv.serve_requests(requests(Request, cfg.vocab))
        streams = {rid: srv.reqsched.tokens_for(rid) for rid in sorted(srv.reqsched.finished)}
    return streams, m, srv, (g.bad if g else None)


def equal_streams(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("physical", [False, True], ids=["logical", "physical"])
@pytest.mark.parametrize("kind", ["fixed", "continuous"])
def test_eplb_server_matches_jax(kind, physical, tree):
    jcfg, tcfg = heat_cfgs(physical)
    want, jm, jpls = jax_serve(kind, physical, tree)
    params = params_from_jax(tree, dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, params_physical=False)), device="cpu")
    off, m_off, srv_off, _ = port_serve(kind, tcfg, params if not physical else
                                        params_from_jax(tree, tcfg, device="cpu"), False)
    on, m_on, srv_on, bad = port_serve(kind, tcfg, params if not physical else
                                       params_from_jax(tree, tcfg, device="cpu"), True,
                                       guard=True)
    plain, _, _, _ = port_serve(kind, tcfg, params, False, eplb=False)
    equal_streams(off, want)
    equal_streams(on, off)
    equal_streams(plain, off)
    assert bad == []
    assert len(jpls) >= 1
    assert placements_of(srv_off.placements) == placements_of(srv_on.placements) == jpls
    for m in (m_off, m_on):
        np.testing.assert_allclose(m.expert_heat, jm.expert_heat, rtol=0, atol=1e-6)
        assert abs(m.heat_max_mean - jm.heat_max_mean) <= 1e-6
        assert abs(m.rank_heat_max_mean - jm.rank_heat_max_mean) <= 1e-6
        if kind == "continuous":
            assert m.serve_steps == jm.serve_steps
    # traced: the span names and the series rows' keys and heat values
    names = {k for k in m_on.timeline if k not in WATCHDOG}
    assert names == {k for k in jm.timeline if k not in WATCHDOG}
    assert {"rebalance", "adopt" if physical else "rebalance", "placement_swap",
            "rank_imbalance"} <= names
    for k in names:
        assert m_on.timeline[k]["count"] == jm.timeline[k]["count"], k
    assert [sorted(r) for r in m_on.series] == [sorted(r) for r in jm.series]
    wins = [r for r in m_on.series if r["kind"] == "rebalance"]
    jwins = [r for r in jm.series if r["kind"] == "rebalance"]
    assert len(wins) == len(jwins) >= 1
    for a, b in zip(wins, jwins):
        for k in HEAT_KEYS:
            assert (a[k] == pytest.approx(b[k], abs=1e-6) if isinstance(a[k], (float, list))
                    else a[k] == b[k]), k
    assert m_off.timeline is None and m_off.series is None


# --------------------------------------------------------------------------
# capture: no host sync in a placed step; swaps keep what graphs hold
# --------------------------------------------------------------------------

def placed_guard_config(layout, physical=True):
    cfg = guard_config(layout)
    pl = TPL.rebalance(np.arange(8, dtype=float) + 1.0, N, num_redundant=R)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, placement=pl, params_physical=physical, track_expert_heat=True))


@pytest.mark.parametrize("layout", ["nccl_ep", "deepep_fp8", "baseline"])
def test_placed_steps_have_no_host_sync(layout):
    cfg = placed_guard_config(layout)
    srv = DecodeServer(cfg, batch=8, max_len=8, ep_size=N, device="cpu")
    heat = srv.state["expert_heat"]
    tok = srv.step(torch.zeros((8, 1), dtype=torch.int32))      # the warm-up step
    guard = guarded(srv)
    srv.step(tok)
    assert guard.bad == [], f"host syncs inside the placed {layout} step: {guard.bad}"
    assert srv.state["expert_heat"] is heat
    # two steps' routing of 8 rows in every MoE layer
    assert float(heat.sum()) == 2 * 8 * cfg.moe.top_k * cfg.num_layers
    csrv = ContinuousDecodeServer(cfg, batch=8, max_len=8, ep_size=N, device="cpu",
                                  page_size=4)
    mp = csrv.max_pages
    feed = dict(tokens=np.zeros((8, 1), np.int32),
                page_tbl=np.arange(8 * mp, dtype=np.int32).reshape(8, mp),
                kv_lens=np.full(8, 3, np.int32), active=np.ones(8, np.int32))
    csrv.step_feed(feed)
    guard = guarded(csrv)
    csrv.step_feed(feed)
    assert guard.bad == [], f"host syncs inside the placed paged {layout} step: {guard.bad}"


def test_swaps_keep_heat_tensor_and_bound_the_step_cache():
    """Real swaps: every adoption builds a new compiled step, the cache
    keeps the current and the previous placement's, the heat counter is the
    same tensor throughout (zeroed in place at each window), and the
    physical weights are permuted in place (the same storage)."""
    _, tcfg = heat_cfgs(True)
    srv = DecodeServer(tcfg, B, MAX_LEN, ep_size=N, device="cpu", rebalance_every=2,
                       num_redundant_experts=R)
    heat = srv.state["expert_heat"]
    srv.serve(prompts(tcfg.vocab), 12)
    assert len(srv.placements) >= 3
    assert list(srv._step_cache) == srv.placements[-2:]
    assert all(isinstance(s, CompiledStep) for s in srv._step_cache.values())
    assert srv.state["expert_heat"] is heat
    ptr = srv.params["moe_stack"]["moe"]["w_gate"].data_ptr()
    srv._maybe_rebalance(1)            # one more window (drained) and swap
    assert srv.params["moe_stack"]["moe"]["w_gate"].data_ptr() == ptr
    assert len(srv._step_cache) <= 2
