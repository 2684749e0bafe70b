"""EPLB with one EP rank per process: ``DistComm`` over gloo on the CPU
against ``LocalComm``, both servers in the adopt-once physical layout.

Four worker processes are spawned once for the file (a ``file://``
rendezvous under ``tmp_path``, one thread each), as in
``tests/test_torch_dist_serve.py``; rank 0 also runs the ``LocalComm``
references. Each process counts the routing of its own rows; at a window
boundary the counts are summed over the token axes, and every process's
scheduler, fed the same heat, adopts the same table at the same step; the
physical expert rows then move between the processes (one
``all_to_all_single`` over the EP group per leaf and layer).

* placements equal in every process and to ``LocalComm``'s;
* streams bitwise equal to ``LocalComm``'s and to the serve without EPLB;
* each process's migrated rows bitwise equal to its shard of the
  ``LocalComm`` adoption, over ``data`` 4 and with expert-TP over
  ``(data 2, model 2)`` (the rows move along EP only, each F-slice with
  its own);
* logical-mode weights over a ``DistComm`` are refused.

The workers import this module by name, so it imports no JAX at its top.
"""
import dataclasses
import datetime

import numpy as np
import pytest
import torch

from repro_torch.comm import DistComm, LocalComm
from repro_torch.launch.mesh import init_process, spawn
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
from repro_torch.weights import params_from_jax, shard_params
from test_torch_dist import config, np_params

N = 4
WORLD = (("data", N),)
DATA_MODEL = (("data", 2), ("model", 2))
TIMEOUT = datetime.timedelta(seconds=60)
SLOTS, MAX_LEN, PAGE, PROMPT, GEN, EVERY = 8, 24, 4, 4, 8, 3
# name -> (mesh, EP axes, EP extent, redundant slots)
CASES = {"data4": (WORLD, None, 4, 4), "expert_tp": (DATA_MODEL, ("data",), 2, 2)}
KEYS = ("w_gate", "w_up", "w_down")


def cfg_of(heat=True, physical=True):
    cfg = config("dbrx")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, track_expert_heat=heat, params_physical=physical))


def inputs() -> dict:
    cfg = cfg_of()
    rng = np.random.default_rng(2)
    return dict(tree=np_params(cfg, 11),
                prompts=rng.integers(0, cfg.vocab, (SLOTS, PROMPT)).astype(np.int32),
                requests=[(i, rng.integers(0, cfg.vocab, int(rng.integers(1, 6))).astype(np.int32),
                           int(rng.integers(2, 7)), a)
                          for i, a in enumerate([0, 0, 0, 1, 2, 2, 3, 5, 6, 8])])


def serves(comm, inp: dict, r: int, eplb: bool = True) -> dict:
    """Both servers over ``comm``: the fixed batch's tokens and the
    continuous streams, the placements adopted, and the fixed server's
    expert rows after its last adoption."""
    cfg = cfg_of()
    kw = dict(rebalance_every=EVERY, num_redundant_experts=r) if eplb else {}
    out = {}
    params = shard_params(params_from_jax(inp["tree"], cfg, device="cpu"), cfg, comm)
    srv = DecodeServer(cfg, SLOTS, MAX_LEN, comm=comm, params=params, device="cpu", **kw)
    srv.serve(inp["prompts"], GEN)
    out["fixed"] = srv.last_tokens
    out["fixed_placements"] = [(p.slot_expert, p.version, p.fingerprint())
                               for p in srv.placements]
    out["rows"] = {k: srv.params["moe_stack"]["moe"][k].clone() for k in KEYS}
    out["migrations"] = srv.migrations
    params = shard_params(params_from_jax(inp["tree"], cfg, device="cpu"), cfg, comm)
    csrv = ContinuousDecodeServer(cfg, SLOTS, MAX_LEN, comm=comm, params=params,
                                  device="cpu", page_size=PAGE, **kw)
    csrv.serve_requests([Request(i, p, n, arrival_step=a) for i, p, n, a in inp["requests"]])
    out["streams"] = {rid: csrv.reqsched.tokens_for(rid) for rid in csrv.reqsched.finished}
    out["cont_placements"] = [(p.slot_expert, p.version, p.fingerprint())
                              for p in csrv.placements]
    return out


def worker(rank: int, world: int, init_method: str, inp: dict) -> dict:
    torch.set_num_threads(1)
    init_process(WORLD, "cpu", init_method, rank=rank, world=world, timeout=TIMEOUT)
    out = {}
    for name, (mesh, ep_axes, ep, r) in CASES.items():
        comm = DistComm(mesh, ep_axes=ep_axes, timeout=TIMEOUT)
        out[name] = serves(comm, inp, r)
        out[name]["coords"] = dict(comm.coords)
        out[name]["ep_rank"] = comm.ranks[0]
        if name == "data4":
            out[name]["plain"] = serves(comm, inp, r, eplb=False)["fixed"]
            logical = cfg_of(physical=False)
            try:
                DecodeServer(logical, SLOTS, MAX_LEN, comm=comm, device="cpu",
                             rebalance_every=EVERY, num_redundant_experts=r)
            except NotImplementedError as e:
                out["refused"] = str(e)
    if rank == 0:
        out["local"] = {name: serves(LocalComm(ep), inp, r)
                        for name, (_, _, ep, r) in CASES.items()}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inp = inputs()
    ranks = spawn(worker, N, inp, timeout=240, workdir=tmp_path_factory.mktemp("dist_eplb"))
    return dict(inp=inp, ranks=ranks, local=ranks[0]["local"])


@pytest.mark.parametrize("case", list(CASES))
def test_placements_equal_in_every_process_and_local(run, case):
    want = run["local"][case]
    assert len(want["fixed_placements"]) >= 1 and len(want["cont_placements"]) >= 1
    for r in run["ranks"]:
        assert r[case]["fixed_placements"] == want["fixed_placements"]
        assert r[case]["cont_placements"] == want["cont_placements"]


@pytest.mark.parametrize("case", list(CASES))
def test_streams_bitwise_equal_local(run, case):
    want = run["local"][case]
    for r in run["ranks"]:
        np.testing.assert_array_equal(r[case]["fixed"], want["fixed"])
        assert r[case]["streams"].keys() == want["streams"].keys()
        for rid, toks in want["streams"].items():
            np.testing.assert_array_equal(r[case]["streams"][rid], toks)
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["data4"]["plain"], run["local"]["data4"]["fixed"])


@pytest.mark.parametrize("case", list(CASES))
def test_migrated_rows_bitwise_equal_local_adoption(run, case):
    """Each process's expert rows after its last adoption are its EP rank's
    slots (and, under expert-TP, its F-slice) of the LocalComm server's
    physical weights, which ``adopt_expert_params`` rebound on one card."""
    want = run["local"][case]["rows"]
    for r in run["ranks"]:
        got, ep_rank = r[case]["rows"], r[case]["ep_rank"]
        for k in KEYS:
            s = got[k].shape[1]
            w = want[k][:, ep_rank * s:(ep_rank + 1) * s]
            if case == "expert_tp":
                f_dim = -1 if k != "w_down" else -2
                f = got[k].shape[f_dim]
                w = w.narrow(w.dim() + f_dim, r[case]["coords"]["model"] * f, f)
            assert torch.equal(got[k], w), (case, k)
        assert r[case]["migrations"] and all(m["bytes_sent"] >= 0
                                             for m in r[case]["migrations"])


def test_logical_mode_refused_over_dist_comm(run):
    for r in run["ranks"]:
        assert "params_physical=True" in r["refused"] and "A10b" in r["refused"]
