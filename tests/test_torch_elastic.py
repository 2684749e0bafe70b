"""Elastic EP through both servers, the EPLB loops and the checkpoints, against
the JAX package (the cases of ``tests/test_elastic.py`` and the server
cases of ``tests/test_fault_domains.py``).

DBRX's smoke config in f32, its expert weights physical (adopt-once) under
an explicit initial placement, the port over ``LocalComm(8)`` (the
whole-pod case over ``LocalComm(8, axes=(("pod", 2), ("data", 4)))``), the
JAX servers on a mesh of 8 fake devices, both from one weight draw:

* a rank killed mid-serve and rejoined: token streams equal to JAX's and to
  the port's uninterrupted run; the recovery records equal to JAX's (all
  but ``latency_s`` and ``phases``), the placements' fingerprints equal,
  ``degraded_steps`` and the ``ServeMetrics`` fault fields equal; the
  degraded table gives the dead rank no slot, its rows hold zeros; the
  continuous server's page tables clean after the kill and the rejoin;
* the identity placement (no replica): the death warns ``DegradedRecovery``
  and raises, or restores from a checkpoint with the uninterrupted tokens;
* SIGTERM: the pipelined server drains, checkpoints and returns
  ``preempted=True``; its restore equals the server's params;
* ``rebalancing_decode_loop`` under a late kill with the replica floor, and
  the no-replica raise, against JAX's loop;
* checkpoint interop: JAX's ``save_checkpoint`` of a bf16 expert tree under
  a placement restores bitwise in the port and the port's in JAX, with and
  without a rebind; the two indexes' ``expert_layout`` equal;
* the capture guard over a step after a shrink and after an expand.
"""
import dataclasses
import json
import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.checkpoint import adopt_expert_params as j_adopt
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.core import ep_combine as j_combine
from repro.core import ep_create_handle as j_create_handle
from repro.core import ep_dispatch as j_dispatch
from repro.core import placement as JPL
from repro.core import plan as jplan
from repro.core.group import EpGroupConfig as JCfg
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro.runtime.fault import DegradedRecovery as JDegraded
from repro.runtime.fault import FaultInjector as JInjector
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.server import ContinuousDecodeServer as JContinuous
from repro.runtime.server import DecodeServer as JServer
from repro_torch.checkpoint import (adopt_expert_params, latest_step, rebind_expert_leaves,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.core import EpGroupConfig, ep_combine, ep_create_handle, ep_dispatch
from repro_torch.core import placement as TPL
from repro_torch.models.transformer import lm_spec
from repro_torch.runtime.decode import rebalancing_decode_loop
from repro_torch.runtime.fault import DegradedRecovery, FaultInjector
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
from repro_torch.weights import params_from_jax
from test_torch_decode import guard_config, guarded

N, E, B, MAX_LEN, GEN = 8, 8, 8, 32, 12
PODS = (("pod", 2), ("data", 4))
FAULT_FIELDS = ("degraded_steps", "recovery_count", "checkpoint_restores", "alive_ranks",
                "preempted")


def mesh():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


def cfgs(placement_t, placement_j, physical=True):
    jc = dataclasses.replace(jax_smoke(), dtype=jnp.float32)
    tc = dataclasses.replace(smoke_config(), dtype=torch.float32)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, ep_mode="ll", ep_axis=("data",), track_expert_heat=True,
        params_physical=physical, placement=placement_j))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, track_expert_heat=True, params_physical=physical, placement=placement_t))
    return jc, tc


def logical(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, params_physical=False,
                                                            placement=None))


@pytest.fixture(scope="module")
def tree():
    jc, _ = cfgs(None, None, physical=False)
    return jax.device_get(init_from_specs(jax.random.PRNGKey(0), jax_lm_spec(jc)))


def prompts():
    return np.random.RandomState(0).randint(0, 256, (B, 4)).astype(np.int32)


def j_params(tree, jc):
    p = jax.tree.map(jnp.array, tree)
    if jc.moe.params_physical and jc.moe.placement is not None:
        p = j_adopt(p, jax_lm_spec(logical(jc)), None, jc.moe.placement)
    return p


def t_params(tree, tc):
    p = params_from_jax(tree, logical(tc), device="cpu")
    if tc.moe.params_physical and tc.moe.placement is not None:
        p = adopt_expert_params(p, lm_spec(logical(tc)), None, tc.moe.placement)
    return p


def placements(name):
    """(port, JAX) initial placements of each case."""
    if name == "redundant":
        return TPL.redundant_placement(E, N, E), JPL.redundant_placement(E, N, E)
    if name == "identity":
        return TPL.identity_placement(E, N), JPL.identity_placement(E, N)
    dt, dj = TPL.domains_from_geometry(N, 4), JPL.domains_from_geometry(N, 4)
    return (TPL.rebalance(np.ones(E), N, num_redundant=E, min_replicas=2, domains=dt),
            JPL.rebalance(np.ones(E), N, num_redundant=E, min_replicas=2, domains=dj))


def events(recs):
    return [{k: v for k, v in e.items() if k not in ("latency_s", "phases")} for e in recs]


def fps(pls):
    return [p.fingerprint() for p in pls]


# ---------------------------------------------------------------------------
# the JAX runs, each once for the module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tree, tmp_path_factory):
    out = {}
    _, pj = placements("redundant")
    jc, _ = cfgs(None, pj)
    srv = JServer(jc, batch=B, max_len=MAX_LEN, mesh=mesh(), params=j_params(tree, jc),
                  num_redundant_experts=E)
    first, _ = srv.prefill(jnp.asarray(prompts()))
    out["base"] = np.asarray(srv.decode(first, GEN)[0])
    srv.close()
    srv = JServer(jc, batch=B, max_len=MAX_LEN, mesh=mesh(), params=j_params(tree, jc),
                  num_redundant_experts=E, fault_injector=JInjector(8, kill={3: 2}, rejoin={8: 2}),
                  miss_threshold=1)
    m = srv.serve(jnp.asarray(prompts()), GEN)
    out["kill"] = dict(m=m, events=events(srv.recoveries), fps=fps(srv.placements),
                       degraded=srv._degraded_steps)
    srv.close()
    # the whole pod
    _, pj = placements("pods")
    jc, _ = cfgs(None, pj)
    dom = JPL.domains_from_geometry(N, 4)
    srv = JServer(jc, batch=B, max_len=MAX_LEN, mesh=mesh(), params=j_params(tree, jc),
                  num_redundant_experts=E, min_replicas=2, fault_domains=dom, miss_threshold=1,
                  fault_injector=JInjector(8, domains=dom, kill_domains={3: 1},
                                           rejoin_domains={8: 1}))
    first, _ = srv.prefill(jnp.asarray(prompts()))
    toks = np.asarray(srv.decode(first, GEN)[0])
    out["pod"] = dict(toks=toks, events=events(srv.recoveries), fps=fps(srv.placements),
                      degraded=srv._degraded_steps)
    srv.close()
    # no replica, restored from a checkpoint
    _, pj = placements("identity")
    jc, _ = cfgs(None, pj)
    ck = tmp_path_factory.mktemp("jax_ckpt")
    srv = JServer(jc, batch=B, max_len=MAX_LEN, mesh=mesh(), params=j_params(tree, jc),
                  fault_injector=JInjector(8, kill={2: 2}), miss_threshold=1, ckpt_dir=str(ck))
    j_save(ck, 0, srv.params, placement=pj)
    first, _ = srv.prefill(jnp.asarray(prompts()))
    with pytest.warns(JDegraded, match="restoring from checkpoint"):
        toks = np.asarray(srv.decode(first, 8)[0])
    out["restore"] = dict(toks=toks, events=events(srv.recoveries), fps=fps(srv.placements))
    srv.close()
    # continuous, killed and rejoined
    _, pj = placements("redundant")
    jc, _ = cfgs(None, pj)
    srv = JContinuous(jc, batch=B, max_len=MAX_LEN, mesh=mesh(), params=j_params(tree, jc),
                      page_size=4, num_redundant_experts=E, miss_threshold=1,
                      fault_injector=JInjector(8, kill={3: 2}, rejoin={8: 2}))
    m = srv.serve_requests(requests(JRequest))
    out["cont"] = dict(m=m, events=events(srv.recoveries), fps=fps(srv.placements),
                       streams={i: np.asarray(srv.reqsched.tokens_for(i)) for i in range(4)})
    srv.close()
    return out


def requests(cls):
    return [cls(0, np.array([3, 5, 7], np.int32), 6),
            cls(1, np.array([11, 2], np.int32), 8),
            cls(2, np.array([9, 9, 9, 9, 1], np.int32), 5, arrival_step=4),
            cls(3, np.array([4], np.int32), 7, arrival_step=6)]


def port_server(tree, name, cls=DecodeServer, comm=None, **kw):
    pt, _ = placements(name)
    _, tc = cfgs(pt, None)
    extra = dict(page_size=4) if cls is ContinuousDecodeServer else {}
    where = dict(comm=comm) if comm is not None else dict(ep_size=N)
    return cls(tc, B, MAX_LEN, params=t_params(tree, tc), device="cpu",
               num_redundant_experts=0 if name == "identity" else E, **where, **extra, **kw)


def decode(srv, steps=GEN):
    first, _ = srv.prefill(prompts())
    return srv.decode(first, steps)[0]


@pytest.fixture(scope="module")
def port_base(tree):
    srv = port_server(tree, "redundant")
    toks = decode(srv)
    srv.close()
    return toks


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------

def test_base_equal_jax(port_base, jax_runs):
    np.testing.assert_array_equal(port_base, jax_runs["base"])


def test_kill_midserve_bitwise_tokens_and_rejoin(tree, port_base, jax_runs):
    srv = port_server(tree, "redundant", fault_injector=FaultInjector(8, kill={3: 2},
                                                                      rejoin={8: 2}),
                      miss_threshold=1)
    m = srv.serve(prompts(), GEN)
    np.testing.assert_array_equal(srv.last_tokens, port_base)
    want = jax_runs["kill"]
    assert events(srv.recoveries) == want["events"]
    assert [e["kind"] for e in srv.recoveries] == ["shrink", "expand"]
    assert all(e["lost_experts"] == [] and e["restored_from"] is None for e in srv.recoveries)
    assert fps(srv.placements) == want["fps"]
    degraded, expanded = srv.placements[-2:]
    assert degraded.dead_ranks() == (2,) and expanded.dead_ranks() == ()
    assert all(e == TPL.EMPTY for e in degraded.slot_expert[2])
    assert srv._degraded_steps == want["degraded"] == 5
    for k in FAULT_FIELDS:
        assert getattr(m, k) == getattr(want["m"], k), k
    assert events(m.recovery_events) == events(want["m"].recovery_events)
    assert m.recovery_latency_s > 0 and not m.preempted
    assert {"repack_s", "adopt_s"} <= set(srv.recoveries[0]["phases"])
    assert srv._serve_step is srv._step_cache[expanded] and len(srv._step_cache) <= 2
    assert len({*fps([placements("redundant")[0]]), *fps(srv.placements)}) == 3
    json.dumps(m.as_dict())
    srv.close()


def test_degraded_rows_are_zero_and_live_rows_equal_one_card_adoption(tree):
    """Part of the shrink: the dead rank's slots hold zeros (no source), the
    others equal the adoption of the logical tree into the degraded
    table."""
    srv = port_server(tree, "redundant", fault_injector=FaultInjector(8, kill={3: 2}),
                      miss_threshold=1)
    decode(srv, 6)
    pl = srv.cfg.moe.placement
    assert pl.dead_ranks() == (2,)
    _, tc = cfgs(pl, None)
    want = adopt_expert_params(params_from_jax(tree, logical(tc), device="cpu"),
                               lm_spec(logical(tc)), None, pl)
    S = pl.slots_per_rank
    for k in ("w_gate", "w_up", "w_down"):
        got = srv.params["moe_stack"]["moe"][k]
        assert torch.count_nonzero(got[:, 2 * S:3 * S]) == 0
        live = [i for i in range(pl.num_slots) if i // S != 2]
        assert torch.equal(got[:, live], want["moe_stack"]["moe"][k][:, live])
    srv.close()


def test_whole_pod_kill_recovers_without_checkpoint(tree, port_base, jax_runs):
    dom = TPL.domains_from_geometry(N, 4)
    srv = port_server(tree, "pods", comm=LocalComm(N, axes=PODS), min_replicas=2,
                      fault_domains=dom, miss_threshold=1,
                      fault_injector=FaultInjector(8, domains=dom, kill_domains={3: 1},
                                                   rejoin_domains={8: 1}))
    toks = decode(srv)
    want = jax_runs["pod"]
    np.testing.assert_array_equal(toks, port_base)
    np.testing.assert_array_equal(toks, want["toks"])
    assert events(srv.recoveries) == want["events"]
    shrink, expand = srv.recoveries
    assert shrink["died"] == [4, 5, 6, 7] and expand["rejoined"] == [4, 5, 6, 7]
    assert srv._ckpt_restores == 0 and shrink["restored_from"] is None
    assert fps(srv.placements) == want["fps"]
    assert srv._degraded_steps == want["degraded"]
    degraded, expanded = srv.placements[-2:]
    TPL.validate_floor(degraded, 2, dom)
    TPL.validate_floor(expanded, 2, dom)
    assert srv._detector.alive == tuple(range(8))
    srv.close()


def test_no_replica_death_warns_and_raises_without_checkpoint(tree):
    srv = port_server(tree, "identity", fault_injector=FaultInjector(8, kill={2: 2}),
                      miss_threshold=1)
    first, _ = srv.prefill(prompts())
    with pytest.warns(DegradedRecovery, match="lost every replica"):
        with pytest.raises(RuntimeError, match="unrecoverable"):
            srv.decode(first, 6)
    assert srv.recoveries[-1]["lost_experts"] == [2]
    srv.close()


def test_no_replica_death_restores_from_checkpoint(tree, port_base, jax_runs, tmp_path):
    pt, _ = placements("identity")
    srv = port_server(tree, "identity", fault_injector=FaultInjector(8, kill={2: 2}),
                      miss_threshold=1, ckpt_dir=str(tmp_path))
    save_checkpoint(tmp_path, 0, srv.params, placement=pt)
    first, _ = srv.prefill(prompts())
    with pytest.warns(DegradedRecovery, match="restoring from checkpoint"):
        toks = srv.decode(first, 8)[0]
    want = jax_runs["restore"]
    np.testing.assert_array_equal(toks, port_base[:, :9])
    np.testing.assert_array_equal(toks, want["toks"])
    assert events(srv.recoveries) == want["events"]
    assert fps(srv.placements) == want["fps"]
    ev = srv.recoveries[0]
    assert ev["kind"] == "shrink" and ev["restored_from"] == 0 and ev["lost_experts"] == [2]
    assert "restore_s" in ev["phases"] and srv._ckpt_restores == 1
    srv.close()


def test_preemption_drains_and_checkpoints(tree, tmp_path):
    pt, _ = placements("redundant")
    srv = port_server(tree, "redundant", pipeline_depth=2, ckpt_dir=str(tmp_path))
    try:
        first, _ = srv.prefill(prompts())
        signal.raise_signal(signal.SIGTERM)
        toks, _ = srv.decode(first, 16)
    finally:
        srv.close()
    assert srv.preempted and toks.shape[1] < 17
    assert toks.shape[1] == 2                # the first boundary, both steps drained
    step = latest_step(tmp_path)
    assert step == 1
    restored, idx = restore_checkpoint(tmp_path, step, lm_spec(srv.cfg), placement=pt,
                                       device="cpu")
    assert idx["expert_layout"]["fingerprint"] == pt.fingerprint()
    assert idx["extra"] == {"preempted": True, "alive_ranks": None}
    flat = lambda t: [v for _, v in sorted(_walk(t))]  # noqa: E731
    for a, b in zip(flat(srv.params), flat(restored)):
        assert torch.equal(a, b)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def test_continuous_batching_survives_kill_and_rejoin(tree, jax_runs):
    base = port_server(tree, "redundant", cls=ContinuousDecodeServer)
    base.serve_requests(requests(Request))
    want_streams = {i: base.reqsched.tokens_for(i) for i in range(4)}
    base.close()
    srv = port_server(tree, "redundant", cls=ContinuousDecodeServer, miss_threshold=1,
                      fault_injector=FaultInjector(8, kill={3: 2}, rejoin={8: 2}))
    m = srv.serve_requests(requests(Request))
    sched = srv.reqsched
    want = jax_runs["cont"]
    for i in range(4):
        np.testing.assert_array_equal(sched.tokens_for(i), want_streams[i])
        np.testing.assert_array_equal(sched.tokens_for(i), want["streams"][i])
    assert events(srv.recoveries) == want["events"]
    assert [e["kind"] for e in srv.recoveries] == ["shrink", "expand"]
    assert fps(srv.placements) == want["fps"]
    for k in FAULT_FIELDS + ("requests_completed", "serve_steps"):
        assert getattr(m, k) == getattr(want["m"], k), k
    assert m.recovery_count == 2 and m.degraded_steps > 0 and m.requests_completed == 4
    # the page tables come out clean
    assert sched.done
    assert sched.alloc.live_count == 0 and sched._reserved == 0
    assert sched.alloc.free_count == sched.alloc.num_pages
    assert np.all(sched._tbl == sched.alloc.pad_page)
    assert np.all(sched._active == 0)
    srv.close()


@pytest.mark.parametrize("cls", [DecodeServer, ContinuousDecodeServer])
def test_server_floor_and_fault_validation_gates_init(tree, cls):
    dom = TPL.domains_from_geometry(N, 4)
    pt, _ = placements("pods")
    _, tc = cfgs(pt, None)
    kw = dict(page_size=4) if cls is ContinuousDecodeServer else {}
    with pytest.raises(ValueError, match=r"num_redundant_experts >= "):
        cls(tc, B, MAX_LEN, ep_size=N, device="cpu", num_redundant_experts=0, min_replicas=2,
            fault_domains=dom, fault_injector=FaultInjector(8, kill={2: 1}), **kw)
    _, tc_id = cfgs(TPL.identity_placement(E, N), None)
    with pytest.raises(ValueError, match="violates the min-replica floor"):
        cls(tc_id, B, MAX_LEN, ep_size=N, device="cpu", num_redundant_experts=E,
            min_replicas=2, fault_domains=dom, fault_injector=FaultInjector(8, kill={2: 1}),
            **kw)
    with pytest.raises(ValueError, match="requires an MoE config on an EP mesh"):
        cls(tc, B, MAX_LEN, device="cpu", fault_injector=FaultInjector(8), **kw)
    from repro_torch.runtime.fault import FaultDetector
    with pytest.raises(ValueError, match="fault_detector watches 4 ranks"):
        cls(tc, B, MAX_LEN, ep_size=N, device="cpu", num_redundant_experts=E,
            fault_detector=FaultDetector(4), **kw)


# ---------------------------------------------------------------------------
# the capture guard over a step after a shrink and after an expand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("after", ["shrink", "expand"])
def test_recovered_step_has_no_host_sync(after):
    cfg = guard_config("nccl_ep")
    pl = TPL.redundant_placement(8, N, 8)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, placement=pl, params_physical=True, track_expert_heat=True))
    rejoin = {3: 2} if after == "expand" else {}
    srv = DecodeServer(cfg, batch=8, max_len=16, ep_size=N, device="cpu",
                       num_redundant_experts=8, miss_threshold=1,
                       fault_injector=FaultInjector(8, kill={1: 2}, rejoin=rejoin))
    first, _ = srv.prefill(np.zeros((8, 2), np.int32))
    toks, _ = srv.decode(first, 5)
    assert [e["kind"] for e in srv.recoveries] == (["shrink", "expand"] if rejoin
                                                   else ["shrink"])
    tok = srv.step(torch.as_tensor(toks[:, -1:]))       # the new step's warm-up
    guard = guarded(srv)
    srv.step(tok)
    assert guard.bad == [], f"host syncs inside the step after a {after}: {guard.bad}"
    srv.close()


# ---------------------------------------------------------------------------
# run_rebalancing's fault path against JAX's
# ---------------------------------------------------------------------------

NL, EL, K, T, H = 8, 16, 4, 16, 32


def _router(rng):
    router_w = rng.randn(H, EL).astype(np.float32)
    bump = np.zeros(EL, np.float32)
    bump[:4] = 3.0
    return router_w, bump


def t_make(router_w, bump):
    def t_router(x):
        p = torch.softmax(x @ torch.from_numpy(router_w) + torch.from_numpy(bump), -1)
        w, idx = torch.topk(p, K)
        return idx.to(torch.int32), w / w.sum(-1, keepdim=True)

    def make(group, params):
        L = group.local_experts

        def fn(window):
            outs, hs = [], 0.0
            for x in window:
                xt = [torch.from_numpy(v) for v in x]
                routed = [t_router(v) for v in xt]
                h = ep_create_handle(group, [r[0] for r in routed], [r[1] for r in routed])
                recv = ep_dispatch(group, h, xt)
                rows = params["w_gate"]
                out = ep_combine(group, h, [y * rows[r * L:(r + 1) * L][:, None, None]
                                            for r, (y, _) in zip(group.comm.ranks, recv)])
                outs.append(np.stack([o.numpy() for o in out]))
                hs = hs + TPL.heat_from_topk(torch.stack([r[0] for r in routed]), EL).numpy()
            return outs, hs
        return fn
    return make


def j_make(router_w, bump):
    m = mesh()
    jw, jb = jnp.asarray(router_w), jnp.asarray(bump)

    def make(group, params):
        L = group.local_experts

        def run(x, wv):
            x = x[0]
            w, idx = jax.lax.top_k(jax.nn.softmax(x @ jw + jb, -1), K)
            ti, wi = idx.astype(jnp.int32), w / w.sum(-1, keepdims=True)
            h = j_create_handle(group, ti, wi)
            y3d, _ = j_dispatch(group, h, x)
            me = jplan.my_rank(group)
            rows = jax.lax.dynamic_slice_in_dim(wv, me * L, L)
            out = j_combine(group, h, y3d * rows[:, None, None])
            return out[None], jax.lax.psum(JPL.heat_from_topk(ti, EL), "data")[None]
        f = jax.jit(jax.shard_map(run, mesh=m, in_specs=(P("data"), P(None)),
                                  out_specs=(P("data"), P("data"))))

        def fn(window):
            outs, hs = [], 0.0
            for x in window:
                o, hh = f(jnp.asarray(x), params["w_gate"])
                outs.append(np.asarray(o))
                hs = hs + np.asarray(hh)[0]
            return outs, hs
        return fn
    return make


def test_rebalancing_decode_loop_survives_injected_kill():
    from repro.runtime.decode import rebalancing_decode_loop as j_loop
    rng = np.random.RandomState(8)
    router_w, bump = _router(rng)
    w_log = rng.rand(EL).astype(np.float32) + 0.5
    xs = [rng.randn(NL, T, H).astype(np.float32) for _ in range(12)]
    dt, dj = TPL.domains_from_geometry(NL, 4), JPL.domains_from_geometry(NL, 4)
    pt = TPL.rebalance(np.ones(EL), NL, num_redundant=EL, min_replicas=2, domains=dt)
    pj = JPL.rebalance(np.ones(EL), NL, num_redundant=EL, min_replicas=2, domains=dj)
    base_t = EpGroupConfig(num_experts=EL, max_tokens_per_rank=T, hidden=H, top_k=K, mode="ll",
                           payload_dtype=torch.float32, placement=pt, fault_domains=dt)
    base_j = JCfg(num_experts=EL, max_tokens_per_rank=T, hidden=H, top_k=K, mode="ll",
                  payload_dtype=jnp.float32, placement=pj, fault_domains=dj)
    w_t = rebind_expert_leaves({"w_gate": torch.from_numpy(w_log)}, ("w_gate",),
                               dst_placement=pt)
    kw = dict(rebalance_every=2, ep_size=NL, num_redundant=EL, expert_keys=("w_gate",),
              donate_params=False, min_replicas=2)
    outs_a, pls_a = rebalancing_decode_loop(base_t, t_make(router_w, bump), xs,
                                            comm=LocalComm(NL), params=dict(w_t),
                                            fault_domains=dt, **kw)
    inj = FaultInjector(NL, kill={3: 3}, rejoin={4: 3})
    outs_b, pls_b = rebalancing_decode_loop(base_t, t_make(router_w, bump), xs,
                                            comm=LocalComm(NL), params=dict(w_t),
                                            fault_domains=dt, fault_injector=inj, **kw)
    for a, b in zip(outs_a, outs_b):
        np.testing.assert_array_equal(a, b)
    assert pls_b[3].dead_ranks() == () and pls_b[4].dead_ranks() == (3,)
    assert pls_b[5].dead_ranks() == ()
    for pl in dict.fromkeys(pls_b):
        TPL.validate_floor(pl, 2, dt)
    assert inj.log and inj.log[0][0] == 3
    # JAX's loop on the same inputs and schedule
    w_j = {"w_gate": JPL.expand_expert_params(jnp.asarray(w_log), pj)}
    j_outs, j_pls = j_loop(base_j, j_make(router_w, bump), xs, params=dict(w_j),
                           fault_domains=dj, fault_injector=JInjector(NL, kill={3: 3},
                                                                      rejoin={4: 3}), **kw)
    assert fps(pls_b) == fps(j_pls)
    for a, b in zip(outs_b, j_outs):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_run_rebalancing_no_replica_kill_raises():
    rng = np.random.RandomState(8)
    router_w, bump = _router(rng)
    w_log = rng.rand(EL).astype(np.float32) + 0.5
    xs = [rng.randn(NL, T, H).astype(np.float32) for _ in range(4)]
    base = EpGroupConfig(num_experts=EL, max_tokens_per_rank=T, hidden=H, top_k=K, mode="ll",
                         payload_dtype=torch.float32)
    with pytest.warns(DegradedRecovery) as got:
        with pytest.raises(ValueError, match="unrecoverable") as err:
            rebalancing_decode_loop(base, t_make(router_w, bump), xs, rebalance_every=2,
                                    ep_size=NL, comm=LocalComm(NL),
                                    params={"w_gate": torch.from_numpy(w_log)},
                                    expert_keys=("w_gate",), donate_params=False,
                                    fault_injector=FaultInjector(NL, kill={0: 2}))
    from repro.runtime.decode import rebalancing_decode_loop as j_loop
    with pytest.warns(JDegraded) as jgot:
        with pytest.raises(ValueError) as jerr:
            j_loop(JCfg(num_experts=EL, max_tokens_per_rank=T, hidden=H, top_k=K, mode="ll",
                        payload_dtype=jnp.float32), j_make(router_w, bump), xs,
                   rebalance_every=2, ep_size=NL, params={"w_gate": jnp.asarray(w_log)},
                   expert_keys=("w_gate",), donate_params=False,
                   fault_injector=JInjector(NL, kill={0: 2}))
    assert str(err.value) == str(jerr.value)
    assert [str(w.message) for w in got if issubclass(w.category, DegradedRecovery)] == \
           [str(w.message) for w in jgot if issubclass(w.category, JDegraded)]


# ---------------------------------------------------------------------------
# checkpoints: the JAX package's and the port's restore in each other
# ---------------------------------------------------------------------------

def expert_tree(pl):
    rng = np.random.default_rng(7)
    shapes = {"w_gate": (E, 6, 10), "w_up": (E, 6, 10), "w_down": (E, 10, 6)}
    logical_tree = {k: rng.standard_normal(s).astype(np.float32).astype(ml_dtypes.bfloat16)
                    for k, s in shapes.items()}
    return {k: np.take(v, TPL.tables(pl).slot_expert.reshape(-1), axis=0)
            for k, v in logical_tree.items()}


def as_torch(tree):
    return {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16) for k, v in tree.items()}


def as_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("rebind", [False, True], ids=["as_stored", "rebound"])
def test_checkpoint_interop(tmp_path, rebind):
    pt, pj = placements("redundant")
    dst_t = TPL.rebalance(np.arange(E, dtype=float) + 1, N, num_redundant=E)
    dst_j = JPL.rebalance(np.arange(E, dtype=float) + 1, N, num_redundant=E)
    assert dst_t.slot_expert == dst_j.slot_expert and dst_t.slot_expert != pt.slot_expert
    tree = expert_tree(pt)
    jd, td = tmp_path / "jax", tmp_path / "port"
    j_save(jd, 3, {k: jnp.asarray(v) for k, v in tree.items()}, placement=pj)
    save_checkpoint(td, 3, as_torch(tree), placement=pt)
    # the same bytes on disk, the same layout record
    for i in range(3):
        assert (jd / f"step_{3:08d}" / f"leaf_{i:05d}.npy").read_bytes() == \
               (td / f"step_{3:08d}" / f"leaf_{i:05d}.npy").read_bytes()
    ji = json.loads((jd / "step_00000003" / "index.json").read_text())
    ti = json.loads((td / "step_00000003" / "index.json").read_text())
    assert ji["expert_layout"] == ti["expert_layout"]
    assert ji["shapes"] == ti["shapes"] and ji["n_leaves"] == ti["n_leaves"]
    assert ji["treedef"] == ti["treedef"]
    tgt_t = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in tree.items()}
    tgt_j = {k: jnp.zeros(v.shape, jnp.bfloat16) for k, v in tree.items()}
    kw_t = dict(placement=dst_t) if rebind else {}
    kw_j = dict(placement=dst_j) if rebind else {}
    for src in (jd, td):
        got_t, _ = restore_checkpoint(src, 3, tgt_t, **kw_t)
        got_j, _ = j_restore(src, 3, tgt_j, **kw_j)
        for k in tree:
            np.testing.assert_array_equal(as_bits(got_t[k]),
                                          np.asarray(got_j[k]).view(np.uint16))
            if not rebind:
                np.testing.assert_array_equal(as_bits(got_t[k]), tree[k].view(np.uint16))


def test_checkpoint_save_checks_and_numpy_leaves(tmp_path):
    pt, _ = placements("redundant")
    logical_tree = {k: torch.zeros(E, 2, 2) for k in ("w_gate", "w_up", "w_down")}
    with pytest.raises(ValueError, match="not in this placement's physical layout"):
        save_checkpoint(tmp_path, 0, logical_tree, placement=pt)
    assert latest_step(tmp_path) is None and not list(tmp_path.iterdir())
    tree = {"step": np.int64(2**40), "heat": np.arange(3, dtype=np.float64),
            "w": [torch.arange(4, dtype=torch.int32), None]}
    save_checkpoint(tmp_path, 5, tree)
    save_checkpoint(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    got, idx = restore_checkpoint(tmp_path, 5, tree)
    assert isinstance(got["heat"], np.ndarray) and got["heat"].dtype == np.float64
    assert int(got["step"]) == 2**40 and got["w"][1] is None
    assert torch.equal(got["w"][0], tree["w"][0])
    assert idx["treedef"] == "PyTreeDef({'heat': *, 'step': *, 'w': [*, None]})"
