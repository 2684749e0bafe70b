"""Elastic EP with one EP rank per process: ``DistComm`` over gloo on the CPU
against ``LocalComm(4)`` and the JAX package.

Four worker processes are spawned once for the file (a ``file://``
rendezvous under ``tmp_path``, one thread each), as in
``tests/test_torch_dist_eplb.py``; rank 0 also runs the ``LocalComm``
references, the parent JAX's server on a mesh of four fake devices. DBRX's
smoke config in f32, physical expert weights, every expert on two ranks.

* the migration to a degraded table (rank 2 dead): no byte reaches rank 2,
  its slots come back zero, every other slot bitwise equal to the one-card
  adoption of the same table;
* a kill and a rejoin through ``DecodeServer(comm=DistComm)``: the stream
  equal to ``LocalComm(4)``'s and to JAX's, the recovery records equal to
  JAX's; every worker's events, alive sets and placement fingerprints
  equal;
* a wall-clock ``timeout_s`` detector that fires in one worker only: every
  worker takes the same shrink at the same step (and the expand after it);
* SIGTERM raised in one worker: all four stop at the same boundary with
  the same tokens;
* ``ckpt_dir`` over a ``DistComm`` is refused (ROADMAP A10d).

The workers import this module by name, so it imports no JAX at its top.
"""
import dataclasses
import datetime
import signal
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import adopt_expert_params, migrate_expert_params
from repro_torch.comm import DistComm, LocalComm
from repro_torch.core import placement as PL
from repro_torch.launch.mesh import init_process, spawn
from repro_torch.models.transformer import lm_spec
from repro_torch.runtime.fault import FaultDetector, FaultInjector
from repro_torch.runtime.server import DecodeServer
from repro_torch.weights import params_from_jax, shard_params
from test_torch_dist import config, np_params

N, E = 4, 8
WORLD = (("data", N),)
TIMEOUT = datetime.timedelta(seconds=60)
SLOTS, MAX_LEN, PROMPT, GEN = 8, 24, 4, 8
KILL, REJOIN, DEAD = 2, 5, 2
KEYS = ("w_gate", "w_up", "w_down")


def placement():
    return PL.redundant_placement(E, N, E)


def cfg_of(pl=None):
    return config("dbrx", track_expert_heat=True, params_physical=True,
                  placement=placement() if pl is None else pl)


def logical_spec(cfg):
    return lm_spec(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, params_physical=False, placement=None)))


def full_params(tree, cfg):
    """The whole physical tree of ``cfg``'s placement, on this process."""
    p = params_from_jax(tree, dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, params_physical=False, placement=None)), device="cpu")
    return adopt_expert_params(p, logical_spec(cfg), None, cfg.moe.placement)


def inputs() -> dict:
    cfg = cfg_of()
    rng = np.random.default_rng(2)
    return dict(tree=np_params(dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, params_physical=False, placement=None)), 11),
                prompts=rng.integers(0, cfg.vocab, (SLOTS, PROMPT)).astype(np.int32))


def degraded():
    """A table with rank DEAD's row all EMPTY, from skewed heat."""
    return PL.shrink_placement(np.arange(E, dtype=float) + 1, N, (DEAD,), num_redundant=E,
                               version=3)


class LateHeartbeat(FaultDetector):
    """A wall-clock detector whose heartbeat of rank 3 at step 3 arrives
    100 s late: with ``timeout_s`` 50 it declares rank 3 dead at that
    boundary, in this process only."""

    def heartbeat(self, rank, step, now=None):
        if rank == 3 and step == 3:
            now = time.perf_counter() - 100.0
        super().heartbeat(rank, step, now)


def serve(comm, inp, **kw):
    cfg = cfg_of()
    params = shard_params(full_params(inp["tree"], cfg), cfg, comm)
    srv = DecodeServer(cfg, SLOTS, MAX_LEN, comm=comm, params=params, device="cpu",
                       num_redundant_experts=E, **kw)
    try:
        m = srv.serve(inp["prompts"], GEN)
    finally:
        srv.close()
    return dict(tokens=srv.last_tokens,
                events=[{k: v for k, v in e.items() if k not in ("latency_s", "phases")}
                        for e in srv.recoveries],
                fps=[p.fingerprint() for p in srv.placements],
                alive=list(srv._detector.alive) if srv._detector is not None else None,
                degraded=m.degraded_steps, preempted=m.preempted,
                migrations=list(srv.migrations),
                rows={k: srv.params["moe_stack"]["moe"][k].clone() for k in KEYS})


def worker(rank: int, world: int, init_method: str, inp: dict) -> dict:
    torch.set_num_threads(1)
    init_process(WORLD, "cpu", init_method, rank=rank, world=world, timeout=TIMEOUT)
    comm = DistComm(WORLD, timeout=TIMEOUT)
    out = dict(ep_rank=comm.ranks[0])
    # Part 1: a migration to a degraded table moves nothing to the dead rank
    cfg = cfg_of()
    pl0, deg = cfg.moe.placement, degraded()
    params = shard_params(full_params(inp["tree"], cfg), cfg, comm)
    alive = tuple(r for r in range(N) if r != DEAD)
    params, stats = migrate_expert_params(params, logical_spec(cfg),
                                          PL.mask_placement(pl0, alive), deg, comm)
    out["migrate"] = dict(stats=stats,
                          rows={k: params["moe_stack"]["moe"][k].clone() for k in KEYS})
    # a kill and a rejoin
    out["kill"] = serve(comm, inp, miss_threshold=1,
                        fault_injector=FaultInjector(N, kill={KILL: DEAD},
                                                     rejoin={REJOIN: DEAD}))
    # a wall-clock detector that fires in this process only (rank 1)
    det = (LateHeartbeat if rank == 1 else FaultDetector)(N, miss_threshold=1000,
                                                          timeout_s=50.0)
    out["timeout"] = serve(comm, inp, fault_injector=FaultInjector(N), fault_detector=det)
    out["base"] = serve(comm, inp)
    # SIGTERM in this process only (rank 1), during its third decode step
    cfg = cfg_of()
    params = shard_params(full_params(inp["tree"], cfg), cfg, comm)
    srv = DecodeServer(cfg, SLOTS, MAX_LEN, comm=comm, params=params, device="cpu",
                       num_redundant_experts=E, pipeline_depth=2)
    first, _ = srv.prefill(inp["prompts"])
    inner, calls = srv.step, []

    def step(tok):
        calls.append(1)
        if rank == 1 and len(calls) == 3:
            signal.raise_signal(signal.SIGTERM)
        return inner(tok)
    srv.step = step
    try:
        toks, _ = srv.decode(first, GEN)
    finally:
        srv.close()
    out["sigterm"] = dict(tokens=toks, preempted=srv.preempted, steps=len(calls))
    try:
        DecodeServer(cfg, SLOTS, MAX_LEN, comm=comm, params=params, device="cpu",
                     ckpt_dir="unused")
    except NotImplementedError as e:
        out["refused"] = str(e)
    if rank == 0:
        lc = LocalComm(N)
        out["local"] = dict(
            adopt=adopt_expert_params(full_params(inp["tree"], cfg), logical_spec(cfg),
                                      pl0, deg),
            kill=serve(lc, inp, miss_threshold=1,
                       fault_injector=FaultInjector(N, kill={KILL: DEAD},
                                                    rejoin={REJOIN: DEAD})))
    return out


def jax_kill(inp):
    """JAX's server on four fake devices, the same weights and schedule."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import adopt_expert_params as j_adopt
    from repro.configs.dbrx_132b import smoke_config
    from repro.core import placement as JPL
    from repro.models.transformer import lm_spec as j_lm_spec
    from repro.runtime.fault import FaultInjector as JInjector
    from repro.runtime.server import DecodeServer as JServer
    pl = JPL.redundant_placement(E, N, E)
    jc = dataclasses.replace(smoke_config(), dtype=jnp.float32)
    jlog = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, ep_axis=("data",)))
    jc = dataclasses.replace(jlog, moe=dataclasses.replace(
        jlog.moe, track_expert_heat=True, params_physical=True, placement=pl))
    params = j_adopt(jax.tree.map(jnp.asarray, inp["tree"]), j_lm_spec(jlog), None, pl)
    mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,),
                         devices=jax.devices()[:N])
    srv = JServer(jc, batch=SLOTS, max_len=MAX_LEN, mesh=mesh, params=params,
                  num_redundant_experts=E, miss_threshold=1,
                  fault_injector=JInjector(N, kill={KILL: DEAD}, rejoin={REJOIN: DEAD}))
    try:
        first, _ = srv.prefill(jnp.asarray(inp["prompts"]))
        toks = np.asarray(srv.decode(first, GEN)[0])
    finally:
        srv.close()
    return dict(tokens=toks, fps=[p.fingerprint() for p in srv.placements],
                events=[{k: v for k, v in e.items() if k not in ("latency_s", "phases")}
                        for e in srv.recoveries], degraded=srv._degraded_steps)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inp = inputs()
    ranks = spawn(worker, N, inp, timeout=240, workdir=tmp_path_factory.mktemp("dist_elastic"))
    return dict(inp=inp, ranks=ranks, local=ranks[0]["local"], jax=jax_kill(inp))


def test_migration_to_degraded_table_sends_nothing_to_the_dead_rank(run):
    deg = degraded()
    S = deg.slots_per_rank
    want = run["local"]["adopt"]["moe_stack"]["moe"]
    assert all(e == PL.EMPTY for e in deg.slot_expert[DEAD])
    for r in run["ranks"]:
        m = r["migrate"]
        me = r["ep_rank"]
        if me == DEAD:
            assert m["stats"]["bytes_received"] == 0 and m["stats"]["bytes_local"] == 0
        for k in KEYS:
            got = m["rows"][k]
            if me == DEAD:
                assert torch.count_nonzero(got) == 0
            else:
                assert torch.equal(got, want[k][:, me * S:(me + 1) * S]), (me, k)
    assert sum(r["migrate"]["stats"]["bytes_sent"] for r in run["ranks"]) == \
           sum(r["migrate"]["stats"]["bytes_received"] for r in run["ranks"])


def test_kill_and_rejoin_equal_local_and_jax(run):
    local, jx = run["local"]["kill"], run["jax"]
    np.testing.assert_array_equal(local["tokens"], jx["tokens"])
    assert local["events"] == jx["events"] and local["fps"] == jx["fps"]
    assert local["degraded"] == jx["degraded"] == REJOIN - KILL
    assert [e["kind"] for e in local["events"]] == ["shrink", "expand"]
    for r in run["ranks"]:
        k = r["kill"]
        np.testing.assert_array_equal(k["tokens"], local["tokens"])
        np.testing.assert_array_equal(k["tokens"], r["base"]["tokens"])
        assert k["events"] == local["events"] and k["fps"] == local["fps"]
        assert k["alive"] == list(range(N)) and k["degraded"] == local["degraded"]


def test_shrink_moves_no_bytes_to_the_dead_rank(run):
    for r in run["ranks"]:
        moves = r["kill"]["migrations"]
        assert [m["kind"] for m in moves] == ["shrink", "expand"]
        if r["ep_rank"] == DEAD:
            assert moves[0]["bytes_received"] == 0 and moves[1]["bytes_received"] > 0
    # rows after the rejoin: this rank's slots of the LocalComm server's
    want = run["local"]["kill"]["rows"]
    for r in run["ranks"]:
        got, me = r["kill"]["rows"], r["ep_rank"]
        for k in KEYS:
            s = got[k].shape[1]
            assert torch.equal(got[k], want[k][:, me * s:(me + 1) * s])


def test_one_process_timeout_gives_one_common_shrink(run):
    first = run["ranks"][0]["timeout"]
    assert [(e["kind"], e["step"], e["died"], e["rejoined"]) for e in first["events"]] == \
           [("shrink", 3, [3], []), ("expand", 4, [], [3])]
    for r in run["ranks"]:
        t = r["timeout"]
        assert t["events"] == first["events"] and t["fps"] == first["fps"]
        np.testing.assert_array_equal(t["tokens"], r["base"]["tokens"])


def test_sigterm_in_one_process_stops_all_at_one_boundary(run):
    got = [r["sigterm"] for r in run["ranks"]]
    assert all(g["preempted"] for g in got)
    assert len({g["tokens"].shape[1] for g in got}) == 1
    assert len({g["steps"] for g in got}) == 1 and got[0]["steps"] == 3
    # every process stepped its own rows; they agree with the full serve's
    base = run["ranks"][0]["base"]["tokens"]
    for r, g in zip(run["ranks"], got):
        rows = slice(r["ep_rank"] * SLOTS // N, (r["ep_rank"] + 1) * SLOTS // N)
        np.testing.assert_array_equal(g["tokens"], base[rows, :g["tokens"].shape[1]])


def test_ckpt_dir_refused_over_dist_comm(run):
    for r in run["ranks"]:
        assert "A10d" in r["refused"] and "ckpt_dir" in r["refused"]
