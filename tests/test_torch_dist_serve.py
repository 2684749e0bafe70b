"""Continuous batching and the hierarchical prefill forward with one EP rank
per process: ``comm.DistComm`` over gloo on the CPU, against ``LocalComm``
and the JAX package.

Four worker processes are spawned once for the whole file, as in
``tests/test_torch_dist.py`` (a ``file://`` rendezvous under ``tmp_path``,
one thread each, a timeout on the process group, its sub-groups and the
join). Each worker runs every case as one rank and returns what it
computed; rank 0 also runs the ``LocalComm(4)`` references, hosting all
four ranks in its process. The parent runs the JAX references while the
workers run. The workers import this module by name, so it imports no JAX
at its top.

* ``ContinuousDecodeServer(comm=DistComm)``: every process runs the one
  scheduler over the global slots, steps its own rows and observes the
  global tokens of each step. On DBRX's smoke config over ``data`` 4 (with
  the default page pool, and with one small enough that reservation-gated
  admission blocks), with expert-TP over ``(data 2, model 2)``, and on
  DeepSeek-V3's smoke config (the MLA pool, fp8 ``nccl_ep``) over ``data``
  4: every request's stream equal to ``LocalComm(4)``'s and to JAX's
  ``ContinuousDecodeServer`` on the same mesh; ``serve_steps``,
  ``requests_completed`` and ``pages_peak`` equal to JAX's; every rank's
  admission log, (step, rid, slot), the same; two requests that joined
  mid-stream, run alone through the same engine, give their streams.
* ``lm_forward`` on the hierarchical HT path over ``DistComm((("pod", 2),
  ("data", 2)))`` at 1 and 2 chunks: loss and aux within 1e-5 of JAX on a
  ("pod", "data") mesh of 2 x 2, and 2 chunks bitwise equal to 1.
"""
import dataclasses
import datetime
import threading

import numpy as np
import pytest
import torch

from repro_torch.comm import DistComm, LocalComm
from repro_torch.launch.mesh import init_process, spawn
from repro_torch.models import get_model
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer
from repro_torch.weights import params_from_jax, shard_params
from test_torch_dist import config, jax_mesh, np_params

N = 4
WORLD = (("data", N),)
POD_DATA = (("pod", 2), ("data", 2))
DATA_MODEL = (("data", 2), ("model", 2))
TIMEOUT = datetime.timedelta(seconds=60)
F32 = dict(rtol=1e-5, atol=1e-5)
SLOTS, MAX_LEN, PAGE = 8, 16, 4
TIGHT_PAGES = 6                 # admission waits for pages to come back
# requests that join after step 0 and leave before the last step, run again
# alone through the same engine
SOLO = (4, 7)
# DeepSeek-V3's serve variant: LL nccl_ep with fp8 dispatch, as decode_32k
DS_MOE = dict(ep_mode="ll", ll_layout="nccl_ep", quantize_dispatch=True,
              expert_capacity_factor=2.0)
# name -> (arch, MoE options, mesh, EP axes, page pool)
SERVE_CASES = {
    "dbrx": ("dbrx", {}, WORLD, None, None),
    "dbrx_tight_pool": ("dbrx", {}, WORLD, None, TIGHT_PAGES),
    "dbrx_expert_tp": ("dbrx", {}, DATA_MODEL, ("data",), None),
    "deepseek_fp8": ("deepseek", DS_MOE, WORLD, None, None),
}
HIER = dict(ep_mode="ht", ep_axis=("pod", "data"), ht_hierarchical=True,
            capacity_factor=1.25, expert_capacity_factor=1.25)
CHUNKS = (1, 2)
FWD_B, FWD_S = N, 32


def request_specs(vocab: int) -> list:
    """(rid, prompt, new tokens, arrival step) of ten requests from a
    numpy seed: staggered arrivals, so slots recycle and pages come back."""
    rng = np.random.default_rng(7)
    arrivals = [0, 0, 0, 1, 2, 2, 4, 5, 7, 9]
    return [(i, rng.integers(0, vocab, int(rng.integers(1, 7))).astype(np.int32),
             int(rng.integers(2, 8)), a) for i, a in enumerate(arrivals)]


def make_requests(cls, specs) -> list:
    return [cls(rid, prompt, new, arrival_step=a) for rid, prompt, new, a in specs]


def inputs() -> dict:
    dbrx, ds = config("dbrx"), config("deepseek", **DS_MOE)
    rng = np.random.default_rng(1)
    return dict(
        params={"dbrx": np_params(dbrx, 5), "deepseek": np_params(ds, 6)},
        requests={"dbrx": request_specs(dbrx.vocab), "deepseek": request_specs(ds.vocab)},
        fwd_params=np_params(config("dbrx", **HIER), 8),
        fwd_tokens=rng.integers(0, dbrx.vocab, (FWD_B, FWD_S)).astype(np.int32))


# ---------------------------------------------------------------------------
# the cases, over the ranks a communicator hosts
# ---------------------------------------------------------------------------

def serve_case(comm, name: str, inp: dict) -> dict:
    """Every request through ContinuousDecodeServer over ``comm``, then the
    SOLO requests alone through the same engine: streams, metrics and the
    admission log."""
    arch, moe, _, _, pages = SERVE_CASES[name]
    cfg = config(arch, **moe)
    params = shard_params(params_from_jax(inp["params"][arch], cfg, device="cpu"), cfg, comm)
    srv = ContinuousDecodeServer(cfg, SLOTS, MAX_LEN, comm=comm, params=params,
                                 device="cpu", page_size=PAGE, num_pages=pages)
    specs = inp["requests"][arch]
    m = srv.serve_requests(make_requests(Request, specs))
    sched = srv.reqsched
    out = dict(streams={rid: sched.tokens_for(rid) for rid in sched.finished},
               metrics=(m.serve_steps, m.requests_completed, m.pages_peak,
                        m.pages_dense_equiv, m.total_tokens),
               admissions=list(sched.admissions),
               returned=(sched.alloc.live_count, sched._reserved, sched.alloc.free_count),
               rows=(srv.rows.start, srv.rows.stop), feed=srv._feed["page_tbl"].shape)
    out["solo"] = {}
    for rid, prompt, new, _ in specs:
        if rid in SOLO:
            srv.serve_requests([Request(rid, prompt, new)])
            out["solo"][rid] = srv.reqsched.tokens_for(rid)
    return out


def forward_case(comm, nc: int, tree, tokens) -> tuple:
    cfg = config("dbrx", **HIER, ht_num_chunks=nc)
    params = shard_params(params_from_jax(tree, cfg, device="cpu"), cfg, comm)
    rows = comm.batch_rows(tokens.shape[0])
    loss, aux = get_model(cfg).forward(params, {"tokens": torch.from_numpy(tokens[rows])},
                                       cfg, comm)
    return loss.item(), aux["aux"].item()


def worker(rank: int, world: int, init_method: str, inp: dict) -> dict:
    torch.set_num_threads(1)
    init_process(WORLD, "cpu", init_method, rank=rank, world=world, timeout=TIMEOUT)
    comms = {WORLD: DistComm(WORLD, timeout=TIMEOUT),
             POD_DATA: DistComm(POD_DATA, timeout=TIMEOUT),
             DATA_MODEL: DistComm(DATA_MODEL, ep_axes=("data",), timeout=TIMEOUT)}
    out = dict(serve={name: serve_case(comms[mesh], name, inp)
                      for name, (_, _, mesh, _, _) in SERVE_CASES.items()},
               forward={nc: forward_case(comms[POD_DATA], nc, inp["fwd_params"],
                                         inp["fwd_tokens"]) for nc in CHUNKS},
               coords={str(m): dict(c.coords) for m, c in comms.items()})
    if rank == 0:               # while the parent runs JAX
        out["local"] = {name: serve_case(LocalComm(N), name, inp) for name in SERVE_CASES}
    return out


# ---------------------------------------------------------------------------
# the parent: spawn, JAX
# ---------------------------------------------------------------------------

def jax_continuous(name: str, inp: dict) -> dict:
    import jax.numpy as jnp

    from repro.configs.dbrx_132b import smoke_config as j_dbrx
    from repro.configs.deepseek_v3_671b import smoke_config as j_ds
    from repro.runtime.scheduler import Request as JRequest
    from repro.runtime.server import ContinuousDecodeServer as JaxContinuous
    arch, moe, mesh, _, pages = SERVE_CASES[name]
    jcfg = j_dbrx() if arch == "dbrx" else dataclasses.replace(j_ds(), d_model=128)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               moe=dataclasses.replace(jcfg.moe, **moe))
    srv = JaxContinuous(jcfg, batch=SLOTS, max_len=MAX_LEN, mesh=jax_mesh(mesh),
                        page_size=PAGE, num_pages=pages, params=inp["params"][arch])
    try:
        m = srv.serve_requests(make_requests(JRequest, inp["requests"][arch]))
        streams = {rid: srv.reqsched.tokens_for(rid) for rid in srv.reqsched.finished}
    finally:
        srv.close()
    return dict(streams=streams, metrics=(m.serve_steps, m.requests_completed, m.pages_peak,
                                          m.pages_dense_equiv, m.total_tokens))


def jax_hier_forward(nc: int, tree, tokens) -> tuple:
    import jax
    import jax.numpy as jnp

    from repro.configs.dbrx_132b import smoke_config as j_dbrx
    from repro.models import get_model as j_get_model
    jcfg = j_dbrx()
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, moe=dataclasses.replace(
        jcfg.moe, **HIER, ht_num_chunks=nc))
    fwd, m = j_get_model(jcfg).forward, jax_mesh(POD_DATA)
    loss, aux = jax.jit(lambda p, b: fwd(p, b, jcfg, m))(tree, {"tokens": jnp.asarray(tokens)})
    return float(loss), float(aux["aux"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the workers (rank 0 also runs the LocalComm references),
    compute the JAX references while they run, join."""
    inp = inputs()
    work = tmp_path_factory.mktemp("dist_serve")
    box = {}

    def go():
        try:
            box["ranks"] = spawn(worker, N, inp, timeout=240, workdir=work)
        except BaseException as e:               # re-raised in the test process
            box["error"] = e
    th = threading.Thread(target=go)
    th.start()
    try:
        jref = dict(serve={name: jax_continuous(name, inp) for name in SERVE_CASES},
                    forward={nc: jax_hier_forward(nc, inp["fwd_params"], inp["fwd_tokens"])
                             for nc in CHUNKS})
    finally:
        th.join(300)
    assert not th.is_alive(), "the workers did not end"
    if "error" in box:
        raise box["error"]
    return dict(inp=inp, ranks=box["ranks"], local=box["ranks"][0]["local"], jax=jref)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_continuous_streams_match_local_comm_and_jax(run, case):
    """Every request's token stream, in every process, equal to
    LocalComm(4)'s server and to JAX's ContinuousDecodeServer on the same
    mesh."""
    want = run["jax"]["serve"][case]["streams"]
    assert sorted(want) == list(range(10))
    local = run["local"][case]["streams"]
    assert local.keys() == want.keys()
    for rid, toks in want.items():
        np.testing.assert_array_equal(local[rid], toks, err_msg=f"LocalComm rid {rid}")
    for rank, r in enumerate(run["ranks"]):
        got = r["serve"][case]["streams"]
        assert got.keys() == want.keys()
        for rid, toks in want.items():
            np.testing.assert_array_equal(got[rid], toks, err_msg=f"rank {rank} rid {rid}")


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_continuous_metrics_match_jax(run, case):
    """serve_steps, requests_completed, pages_peak, the dense-equivalent
    pages and the token count equal JAX's in every process; every page and
    reservation comes back."""
    want = run["jax"]["serve"][case]["metrics"]
    pages = SERVE_CASES[case][4] or SLOTS * MAX_LEN // PAGE
    for got in [r["serve"][case] for r in run["ranks"]] + [run["local"][case]]:
        assert got["metrics"] == want
        assert got["returned"] == (0, 0, pages)


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_admission_logs_agree(run, case):
    """Every rank's (step, rid, slot) admission log is the same, and so is
    LocalComm's; the tight pool admits some request later than the
    default pool does."""
    logs = [r["serve"][case]["admissions"] for r in run["ranks"]]
    assert all(log == logs[0] for log in logs)
    assert logs[0] == run["local"][case]["admissions"]
    assert sorted(rid for _, rid, _ in logs[0]) == list(range(10))
    assert max(slot for _, _, slot in logs[0]) < SLOTS
    if case == "dbrx_tight_pool":
        roomy = {rid: step for step, rid, _ in run["ranks"][0]["serve"]["dbrx"]["admissions"]}
        assert any(step > roomy[rid] for step, rid, _ in logs[0])


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_mid_stream_requests_match_solo(run, case):
    """Two requests that joined after step 0 and left before the last step,
    served alone through the same DistComm engine, give their streams
    among co-residents bitwise."""
    specs = {rid: a for rid, _, _, a in run["inp"]["requests"][SERVE_CASES[case][0]]}
    logs = run["ranks"][0]["serve"][case]["admissions"]
    for rid in SOLO:
        assert specs[rid] > 0 and any(r == rid and s > 0 for s, r, _ in logs)
    for r in run["ranks"]:
        got = r["serve"][case]
        for rid in SOLO:
            np.testing.assert_array_equal(got["solo"][rid], got["streams"][rid])


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_each_process_steps_its_rows(run, case):
    """A process's step inputs hold its rows of the global slots: the
    batch split over the batch axes, processes that differ only in
    ``model`` stepping the same rows."""
    mesh = SERVE_CASES[case][2]
    nb = dict(mesh)["data"]
    b = SLOTS // nb
    for r in run["ranks"]:
        d = r["coords"][str(mesh)]["data"]
        got = r["serve"][case]
        assert got["rows"] == (d * b, (d + 1) * b)
        assert tuple(got["feed"]) == (b, MAX_LEN // PAGE)


@pytest.mark.parametrize("nc", CHUNKS)
def test_hier_lm_forward_matches_jax(run, nc):
    """lm_forward on the hierarchical HT path over DistComm((pod 2, data
    2)), capacity 1.25, each process its row: loss and aux within 1e-5 of
    JAX's on the same mesh, in every process."""
    want_loss, want_aux = run["jax"]["forward"][nc]
    for r in run["ranks"]:
        loss, aux = r["forward"][nc]
        np.testing.assert_allclose(loss, want_loss, **F32)
        np.testing.assert_allclose(aux, want_aux, **F32)


def test_hier_lm_forward_chunks_bitwise(run):
    """Two chunks give the one chunk's loss and aux bit for bit."""
    for r in run["ranks"]:
        assert r["forward"][2] == r["forward"][1]
