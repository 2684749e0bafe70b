"""DeepSeek-V3 with one EP rank per process: ``comm.DistComm`` over gloo on
the CPU, against ``LocalComm`` and the JAX package.

Four worker processes are spawned once for the whole file, as in
``tests/test_torch_dist.py`` (a ``file://`` rendezvous under ``tmp_path``,
one thread each, a timeout on the process group, its sub-groups and the
join). Each worker runs every case as one rank on its rows; rank 0 also runs
the ``LocalComm(4)`` reference. The parent runs the JAX references on four
fake CPU devices while the workers run. The workers import this module by
name, so it imports no JAX at its top.

The config is DeepSeek-V3's smoke config in f32 at d_model 128 (fp8 blocks
of 128): MLA, sigmoid group-limited routing with a nonzero selection bias,
a shared expert, a dense prefix and the MTP layer.

* ``lm_forward`` with MTP on the HT flat path with fp8 dispatch (the
  ``train_4k`` preset's options, capacity 1.25), two rows a process: loss
  and aux within 1e-5 of JAX's ``shard_map`` forward on a 4-device mesh and
  of ``LocalComm(4)``'s. The reference's MLA short branch is anti-causal
  (ROADMAP Queue C), so JAX runs its chunked branch at every S
  (``repro.models.attention.CHUNKED_ATTN_THRESHOLD`` set to 1); the port
  runs its chunked branch the same way (a ragged tail of KV chunks) and its
  short branch as it stands. With ``mtp=False`` the loss moves, by JAX's
  amount: the loss's sum over the processes covers the MTP term.
* ``DecodeServer(comm=DistComm)`` in the ``decode_32k`` preset's LL
  ``nccl_ep`` layout with fp8 dispatch: the token stream equal to JAX's
  server on the same mesh and to ``LocalComm(4)``'s.
* ``init_params(..., comm=)`` bitwise equal to ``shard_params`` of the full
  draw, over ``data`` 4 and with expert-TP over (data 2, model 2), stacked
  expert leaves drawn one layer at a time.
* ``launch.mesh.spawn`` fails at once when a rank raises while its peers
  wait in a collective.
"""
import dataclasses
import datetime
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.models.mla as TMLA
from repro_torch.comm import DistComm, LocalComm
from repro_torch.launch.mesh import init_process, spawn
from repro_torch.models import get_model
from repro_torch.runtime.server import DecodeServer
from repro_torch.weights import _leaves, init_params, params_from_jax, shard_params
from test_torch_dist import config, jax_mesh, np_params

N = 4
WORLD = (("data", N),)
DATA_MODEL = (("data", 2), ("model", 2))
TIMEOUT = datetime.timedelta(seconds=60)
F32 = dict(rtol=1e-5, atol=1e-5)
# the train_4k preset's MoE options; KV chunks of 8 over 20 tokens leave a
# ragged tail of 4
FWD_MOE = dict(ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25,
               quantize_dispatch=True)
FWD_B, FWD_S, KV_CHUNK = 2 * N, 20, 8
# the decode_32k preset's MoE options
SRV_MOE = dict(ep_mode="ll", ll_layout="nccl_ep", quantize_dispatch=True,
               expert_capacity_factor=2.0)
SRV_B, SRV_PROMPT, SRV_STEPS, SRV_MAX = 8, 3, 4, 12
# the port's forward variants: (mtp, chunked branch)
FWD_CASES = {"mtp_chunked": (True, True), "mtp_short": (True, False),
             "no_mtp_chunked": (False, True)}
INIT_CASES = {"data4": (WORLD, None), "expert_tp": (DATA_MODEL, ("data",))}


def fwd_config(mtp: bool = True):
    cfg = config("deepseek", **FWD_MOE)
    return dataclasses.replace(cfg, mtp=mtp,
                               attn=dataclasses.replace(cfg.attn, kv_chunk=KV_CHUNK))


def no_mtp(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if not k.startswith("mtp")}


def inputs() -> dict:
    fcfg, scfg = fwd_config(), config("deepseek", **SRV_MOE)
    rng = np.random.default_rng(21)
    return dict(fwd_params=np_params(fcfg, 22),
                fwd_tokens=rng.integers(0, fcfg.vocab, (FWD_B, FWD_S)).astype(np.int32),
                srv_params=np_params(scfg, 23),
                prompts=rng.integers(0, scfg.vocab, (SRV_B, SRV_PROMPT)).astype(np.int32))


# ---------------------------------------------------------------------------
# the cases, over the ranks a communicator hosts
# ---------------------------------------------------------------------------

def forward_case(comm, name: str, tree, tokens) -> tuple:
    """(loss, aux) of lm_forward on this process's rows."""
    mtp, chunked = FWD_CASES[name]
    cfg = fwd_config(mtp)
    params = shard_params(params_from_jax(tree if mtp else no_mtp(tree), cfg,
                                          device="cpu"), cfg, comm)
    rows = comm.batch_rows(tokens.shape[0])
    threshold = TMLA.CHUNKED_ATTN_THRESHOLD
    if chunked:
        TMLA.CHUNKED_ATTN_THRESHOLD = 1
    try:
        loss, aux = get_model(cfg).forward(params, {"tokens": torch.from_numpy(tokens[rows])},
                                           cfg, comm)
    finally:
        TMLA.CHUNKED_ATTN_THRESHOLD = threshold
    return loss.item(), aux["aux"].item()


def server_case(comm, tree, prompts) -> np.ndarray:
    cfg = config("deepseek", **SRV_MOE)
    params = shard_params(params_from_jax(tree, cfg, device="cpu"), cfg, comm)
    srv = DecodeServer(cfg, SRV_B, SRV_MAX, comm=comm, params=params, device="cpu")
    m = srv.serve(prompts, SRV_STEPS)
    assert m.total_tokens == SRV_B * (SRV_STEPS + 1)
    return srv.last_tokens


def init_case(comm) -> dict:
    """Whether init_params(comm=) equals shard_params of the full draw, leaf
    by leaf, and the shapes of the sharded expert leaves."""
    cfg = fwd_config()
    full = init_params(cfg, seed=7, device="cpu")
    want = dict(_leaves(shard_params(full, cfg, comm)))
    got = dict(_leaves(init_params(cfg, seed=7, device="cpu", comm=comm)))
    assert got.keys() == want.keys()
    return dict(equal={"/".join(k): bool(torch.equal(got[k], want[k])) for k in want},
                shapes={"/".join(k): tuple(got[k].shape) for k in got if k[-1] == "w_gate"})


def worker(rank: int, world: int, init_method: str, inp: dict) -> dict:
    torch.set_num_threads(1)
    init_process(WORLD, "cpu", init_method, rank=rank, world=world, timeout=TIMEOUT)
    flat = DistComm(WORLD, timeout=TIMEOUT)
    out = dict(forward={name: forward_case(flat, name, inp["fwd_params"], inp["fwd_tokens"])
                        for name in FWD_CASES},
               server=server_case(flat, inp["srv_params"], inp["prompts"]))
    out["init"] = {}
    for name, (mesh, ep_axes) in INIT_CASES.items():
        c = flat if mesh == WORLD else DistComm(mesh, ep_axes=ep_axes, timeout=TIMEOUT)
        out["init"][name] = init_case(c)
    if rank == 0:               # while the parent runs JAX
        out["local"] = dict(
            forward=forward_case(LocalComm(N), "mtp_chunked", inp["fwd_params"],
                                 inp["fwd_tokens"]),
            server=server_case(LocalComm(N), inp["srv_params"], inp["prompts"]))
    return out


# ---------------------------------------------------------------------------
# the parent: spawn, JAX
# ---------------------------------------------------------------------------

def jax_config(moe: dict, **kw):
    import jax.numpy as jnp

    from repro.configs.deepseek_v3_671b import smoke_config as j_ds
    jcfg = dataclasses.replace(j_ds(), d_model=128, dtype=jnp.float32, **kw)
    return dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))


def jax_forward(tree, tokens, mtp: bool) -> tuple:
    """JAX's lm_forward on the 4-device mesh, MLA on its chunked branch."""
    import jax
    import jax.numpy as jnp

    import repro.models.attention as JATT
    from repro.models import get_model as j_get_model
    jcfg = jax_config(FWD_MOE, mtp=mtp)
    jcfg = dataclasses.replace(jcfg, attn=dataclasses.replace(jcfg.attn, kv_chunk=KV_CHUNK))
    fwd, m = j_get_model(jcfg).forward, jax_mesh(WORLD)
    threshold = JATT.CHUNKED_ATTN_THRESHOLD
    JATT.CHUNKED_ATTN_THRESHOLD = 1
    try:
        loss, aux = jax.jit(lambda p, b: fwd(p, b, jcfg, m))(
            tree if mtp else no_mtp(tree), {"tokens": jnp.asarray(tokens)})
        return float(loss), float(aux["aux"])
    finally:
        JATT.CHUNKED_ATTN_THRESHOLD = threshold


def jax_server(tree, prompts) -> np.ndarray:
    import jax.numpy as jnp

    from repro.runtime.server import DecodeServer as JaxServer
    srv = JaxServer(jax_config(SRV_MOE), batch=SRV_B, max_len=SRV_MAX, mesh=jax_mesh(WORLD),
                    params=tree)
    try:
        first, _ = srv.prefill(jnp.asarray(prompts))
        toks, _ = srv.decode(first, SRV_STEPS)
    finally:
        srv.close()
    return np.asarray(toks)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the workers (rank 0 also runs the LocalComm references),
    compute the JAX references while they run, join."""
    inp = inputs()
    work = tmp_path_factory.mktemp("dist_deepseek")
    box = {}

    def go():
        try:
            box["ranks"] = spawn(worker, N, inp, timeout=240, workdir=work)
        except BaseException as e:               # re-raised in the test process
            box["error"] = e
    th = threading.Thread(target=go)
    th.start()
    try:
        jref = dict(forward={mtp: jax_forward(inp["fwd_params"], inp["fwd_tokens"], mtp)
                             for mtp in (True, False)},
                    server=jax_server(inp["srv_params"], inp["prompts"]))
    finally:
        th.join(300)
    assert not th.is_alive(), "the workers did not end"
    if "error" in box:
        raise box["error"]
    return dict(inp=inp, ranks=box["ranks"], local=box["ranks"][0]["local"], jax=jref)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_lm_forward_matches_jax(run, case):
    """Every process returns the global loss and aux: JAX's within 1e-5."""
    mtp, _ = FWD_CASES[case]
    want = run["jax"]["forward"][mtp]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["forward"][case], want, **F32)


def test_lm_forward_matches_local_comm(run):
    got = run["ranks"][0]["forward"]["mtp_chunked"]
    np.testing.assert_allclose(got, run["local"]["forward"], **F32)
    assert all(r["forward"]["mtp_chunked"] == got for r in run["ranks"])


def test_mtp_term_is_in_the_loss(run):
    """Without MTP the loss drops the 0.3-weighted MTP term and its layer's
    aux, by JAX's amount: the sum over the processes covers that term."""
    with_mtp = run["ranks"][0]["forward"]["mtp_chunked"]
    without = run["ranks"][0]["forward"]["no_mtp_chunked"]
    assert with_mtp[0] > without[0] and with_mtp[1] > without[1] > 0
    jw, jwo = run["jax"]["forward"][True], run["jax"]["forward"][False]
    np.testing.assert_allclose(with_mtp[0] - without[0], jw[0] - jwo[0], **F32)


def test_decode_server_matches_jax(run):
    want = run["jax"]["server"]
    assert want.shape == (SRV_B, SRV_STEPS + 1)
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["server"], want)
    np.testing.assert_array_equal(run["local"]["server"], want)


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_sharded_init_equals_shard_of_full_draw(run, case):
    cfg = fwd_config()
    mesh, _ = INIT_CASES[case]
    sizes = dict(mesh)
    L = cfg.moe.num_experts // sizes["data"]
    F = cfg.moe.d_ff_expert // sizes.get("model", 1)
    n_moe = cfg.num_layers - cfg.moe.first_k_dense
    for r in run["ranks"]:
        res = r["init"][case]
        assert all(res["equal"].values()), [k for k, v in res["equal"].items() if not v]
        assert res["shapes"]["moe_stack/moe/w_gate"] == (n_moe, L, cfg.d_model, F)
        assert res["shapes"]["mtp_layer/moe/w_gate"] == (L, cfg.d_model, F)


def _raise_or_wait(rank: int, world: int, init_method: str) -> None:
    """Rank 0 raises; the others wait in a barrier rank 0 never joins."""
    torch.set_num_threads(1)
    init_process((("data", world),), "cpu", init_method, rank=rank, world=world,
                 timeout=TIMEOUT)
    if rank == 0:
        raise RuntimeError("rank 0 fails")
    torch.distributed.barrier()


def test_spawn_fails_fast_when_a_rank_raises(tmp_path):
    """A rank that raises ends the spawn at once, with an error, while its
    peers still wait in a collective: not at the spawn's timeout."""
    t0 = time.perf_counter()
    with pytest.raises(Exception) as err:
        spawn(_raise_or_wait, 2, timeout=55, workdir=tmp_path)
    assert not isinstance(err.value, TimeoutError)
    assert time.perf_counter() - t0 < 45


@pytest.mark.parametrize("comm", [None, 4], ids=["no-comm", "localcomm-4"])
def test_init_params_draws_stacked_experts_by_layer(comm):
    """A stacked expert leaf is drawn one layer at a time: each layer equals
    a fresh draw of one layer's shape from the generator's state at that
    point, and a LocalComm, which hosts every rank, keeps the whole tree."""
    cfg = fwd_config()
    full = init_params(cfg, seed=3, device="cpu")
    if comm:
        got = init_params(cfg, seed=3, device="cpu", comm=LocalComm(comm))
        for path, t in _leaves(full):
            want = got
            for p in path:
                want = want[p]
            assert torch.equal(t, want), path
    w = full["moe_stack"]["moe"]["w_gate"]
    assert w.shape[0] == cfg.num_layers - cfg.moe.first_k_dense == 2
    assert not torch.equal(w[0], w[1])
    # replay the generator up to the stacked w_down leaf (the first expert
    # leaf in sorted order) and draw its layers one by one
    gen = torch.Generator().manual_seed(3)
    from repro_torch.models.transformer import lm_spec
    for path, s in _leaves(lm_spec(cfg)):
        if path == ("moe_stack", "moe", "w_down"):
            std = s.scale / np.sqrt(s.shape[-2])
            for i in range(s.shape[0]):
                layer = torch.empty(s.shape[1:], dtype=s.dtype).normal_(0.0, std, generator=gen)
                assert torch.equal(layer, full["moe_stack"]["moe"]["w_down"][i])
            break
        if s.init not in ("zeros", "ones"):
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            if len(s.shape) == 4 and path[-2] == "moe":
                for _ in range(s.shape[0]):
                    torch.empty(s.shape[1:], dtype=s.dtype).normal_(
                        0.0, s.scale / np.sqrt(fan_in), generator=gen)
            else:
                torch.empty(s.shape, dtype=s.dtype).normal_(0.0, s.scale / np.sqrt(fan_in),
                                                            generator=gen)
