"""Training with one EP rank per process: ``make_train_step`` and ``Trainer``
over ``comm.DistComm`` (gloo on the CPU), against the JAX package's
``make_train_step`` on a mesh of four fake devices and against
``LocalComm``.

Four worker processes are spawned once for the whole file (a ``file://``
rendezvous under ``tmp_path``, one thread each). Each runs every case as
one rank and returns what it computed as numpy arrays; rank 0 also runs
the ``LocalComm`` references. The parent runs JAX while they run, and
``launch/train.py --mesh 4`` end to end in a subprocess beside them. The
workers import this module by name, so it imports no JAX at its top.

DBRX's smoke config in f32, HT flat (capacity 1.25) and LL ``nccl_ep``, on
mesh data 4 and on (data 2, model 2) with expert-TP, HT flat with the
sequence split over ``model`` (EP over data and model), hierarchical HT
(2 chunks, capacity 1.25) on (pod 2, data 2) with EP over both, and the
baseline and LL ``deepep`` on mesh data 4 (``deepep`` against
``LocalComm`` only: the reference's ``deepep`` layer is faulty, ROADMAP
Queue C); and DeepSeek-V3's smoke config in f32, HT flat on mesh data 4
(MLA through ``MlaChunked`` over KV chunks of 16, the reference's MLA on its
chunked branch too; nonzero selection biases; the MTP layer):

* ``make_grad_step`` on micro-batch 0 (the forward, the backward and the
  gradient reduce) against ``jax.value_and_grad`` of the reference's
  ``lm_forward`` on the same mesh: the loss within 1e-5, every gradient
  within 1e-4 of its largest value; an expert leaf is held against its
  process's rows (and F-slice) of JAX's.
* Two steps of ``make_train_step`` (2 micro-batches, AdamW clipping at
  the global norm) against two of JAX's jitted ``make_train_step(cfg,
  mesh)``, and against two over ``LocalComm`` of the same EP extent:
  ``tests/test_torch_train_step.py``'s tolerance. Every replicated leaf
  bitwise equal over the four processes after each step.
* ``Trainer(comm=DistComm)``: the logged losses and gradient norms equal
  on every process and within 1e-5 of ``LocalComm(4)``'s ``Trainer``; its
  ``ckpt_dir`` refused (A10d).
"""
import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.comm import DistComm, LocalComm
from repro_torch.configs import dbrx_132b, deepseek_v3_671b
from repro_torch.launch.mesh import init_process, spawn
from repro_torch.models.transformer import lm_spec
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.steps import make_grad_step, make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.weights import _leaves, _set, _shard_leaf, is_cut, params_from_jax, shard_params

N = 4
WORLD = (("data", N),)
DATA_MODEL = (("data", 2), ("model", 2))
TIMEOUT = datetime.timedelta(seconds=60)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
HT = dict(ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25)
LL = dict(ep_mode="ll", ll_layout="nccl_ep")
POD_DATA = (("pod", 2), ("data", 2))
HIER = dict(HT, ht_hierarchical=True, ht_num_chunks=2)
# name -> (mesh, EP axes, MoE options, LocalComm's EP extent or None); the
# LocalComm of a case over POD_DATA hosts that mesh
CASES = {
    "data4_ht": (WORLD, ("data",), HT, 4),
    "data4_ll": (WORLD, ("data",), LL, 4),
    "tp_ht": (DATA_MODEL, ("data",), HT, 2),
    "tp_ll": (DATA_MODEL, ("data",), LL, 2),
    "seq_ht": (DATA_MODEL, ("data", "model"), HT, None),
    "hier_ht": (POD_DATA, ("pod", "data"), HIER, 4),
    "data4_baseline": (WORLD, ("data",), dict(ep_mode="baseline"), 4),
    "data4_deepep": (WORLD, ("data",), dict(ep_mode="ll", ll_layout="deepep"), 4),
    "ds_data4_ht": (WORLD, ("data",), HT, 4),
}
# the cases on DeepSeek-V3's smoke config (the others: DBRX's)
DS_CASES = ("ds_data4_ht",)
DS_KV_CHUNK = 16
# the reference's deepep layer is faulty (ROADMAP Queue C): held against
# LocalComm only
NO_JAX = ("data4_deepep",)
JAX_CASES = tuple(c for c in CASES if c not in NO_JAX)
MICRO, BATCH, SEQ, STEPS = 2, 8, 32, 2
# AdamW moves an element by about lr * g / (|g| + eps), whatever the size of
# g: where the clipped g is near eps the f32 noise of another summation
# order moves the update by a tenth of lr (data4_ht, step 1: 4.7e-8 against
# a largest 1.2e-2 in attn/wo), and at step 2 the first step's last-bit
# differences do so for a rare token's embedding row (2.9e-6 against 0.23).
# At eps 1e-4 such elements move by a hundredth of lr or less, so the
# tolerance below reads the port and not that noise; and the update is no
# longer blind to the clip's scale, which the global norm sets
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
TRAIN = dict(steps=3, global_batch=8, seq_len=16, log_every=1)


def config(name: str):
    """DBRX's smoke config in f32 (DeepSeek-V3's for DS_CASES, KV chunks of
    DS_KV_CHUNK), two micro-batches, the case's MoE."""
    _, ep, moe, _ = CASES[name]
    cfg = (deepseek_v3_671b if name in DS_CASES else dbrx_132b).smoke_config()
    cfg = dataclasses.replace(cfg, dtype=torch.float32, microbatch=MICRO)
    if name in DS_CASES:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, kv_chunk=DS_KV_CHUNK))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_axis=ep, **moe))


def np_params(cfg, seed: int) -> dict:
    """A numpy parameter tree for ``cfg`` (the reference's names and
    layouts) from a numpy seed; selection biases drawn nonzero (their
    initializer is zeros), so that their weight decay shows."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, s in _leaves(lm_spec(cfg)):
        if path[-1] == "sel_bias":
            a = 0.1 * rng.standard_normal(s.shape)
        elif s.init in ("zeros", "ones"):
            a = np.full(s.shape, 0.0 if s.init == "zeros" else 1.0)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            a = rng.standard_normal(s.shape) * s.scale / np.sqrt(max(fan_in, 1))
        _set(tree, path, a.astype(np.float32))
    return tree


def inputs() -> dict:
    """Every case's parameters and its STEPS batches [MICRO, BATCH/MICRO,
    SEQ] of tokens and targets, from seeds."""
    out = {}
    for i, name in enumerate(CASES):
        cfg = config(name)
        rng = np.random.default_rng(100 + i)
        batches = [{k: rng.integers(0, cfg.vocab, (MICRO, BATCH // MICRO, SEQ)).astype(np.int32)
                    for k in ("tokens", "targets")} for _ in range(STEPS)]
        out[name] = (np_params(cfg, i), batches)
    return out


def flat(tree) -> dict:
    return {"/".join(p): t.detach().numpy().copy() for p, t in _leaves(tree)}


# ---------------------------------------------------------------------------
# the worker: one rank, every case
# ---------------------------------------------------------------------------

def train_case(comm, name: str, tree, batches) -> dict:
    """This process's gradients of micro-batch 0 and its STEPS train steps
    from ``tree``; over a LocalComm the whole batch, else its rows. MLA
    takes its chunked branch, MlaChunked."""
    from repro_torch.models import mla
    mla.CHUNKED_ATTN_THRESHOLD = 1
    cfg = config(name)
    calls = mla.mla_chunked_bwd_calls
    params = shard_params(params_from_jax(tree, cfg, device="cpu"), cfg, comm)
    rows = comm.batch_rows(BATCH // MICRO)
    local = [{k: torch.from_numpy(v[:, rows]) for k, v in b.items()} for b in batches]
    loss, sums = make_grad_step(cfg, comm)(params, {k: v[:1] for k, v in local[0].items()})
    out = dict(loss=float(loss), grads=flat(sums), steps=[])
    step = make_train_step(cfg, comm, AdamWConfig(**OPT))
    opt = adamw_init(params, AdamWConfig(**OPT))
    for b in local:
        params, opt, m = step(params, opt, b)
        out["steps"].append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                 lr=float(m["lr"]), params=flat(params)))
    out["mla_bwd_calls"] = mla.mla_chunked_bwd_calls - calls
    return out


def trainer_cfg():
    return dataclasses.replace(config("data4_ht"), microbatch=1)


def trainer_run(comm) -> list:
    t = Trainer(trainer_cfg(), TrainerConfig(**TRAIN), comm=comm, device="cpu")
    t.run()
    return [(r["loss"], r["gnorm"]) for r in t.metrics_log]


def local_comm(name: str) -> LocalComm:
    """The case's LocalComm reference: its EP extent in one process, on the
    case's mesh when that is POD_DATA (the hierarchical path's axes)."""
    mesh, _, _, ep_n = CASES[name]
    return LocalComm(ep_n, axes=mesh if mesh == POD_DATA else None)


def worker(rank: int, world: int, init_method: str, inp: dict) -> dict:
    torch.set_num_threads(1)
    init_process(WORLD, "cpu", init_method, rank=rank, world=world, timeout=TIMEOUT)
    out = {"cases": {}, "comms": {}}
    for name, (mesh, ep, _, _) in CASES.items():
        comm = DistComm(mesh, ep_axes=ep, timeout=TIMEOUT)
        out["cases"][name] = train_case(comm, name, *inp[name])
        out["comms"][name] = dict(ranks=comm.ranks, size=comm.size, tp_axis=comm.tp_axis,
                                  mesh=comm.mesh, coords=dict(comm.coords))
    comm = DistComm(WORLD, timeout=TIMEOUT)
    out["trainer"] = trainer_run(comm)
    try:
        Trainer(trainer_cfg(), TrainerConfig(ckpt_dir="unused"), comm=comm, device="cpu")
    except NotImplementedError as e:
        out["ckpt_refusal"] = str(e)
    if rank == 0:               # while the parent runs JAX
        out["local"] = {name: train_case(local_comm(name), name, *inp[name])
                        for name, (_, _, _, ep_n) in CASES.items() if ep_n}
        out["local_trainer"] = trainer_run(LocalComm(N))
    return out


# ---------------------------------------------------------------------------
# the parent: spawn, JAX, the launcher
# ---------------------------------------------------------------------------

def jax_case(name: str, tree, batches) -> dict:
    """JAX's value_and_grad of lm_forward on micro-batch 0 and STEPS steps
    of its jitted make_train_step, on the case's mesh of fake devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import repro.models.attention as j_attention
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import get_model as j_get_model
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import adamw_init as j_adamw_init
    from repro.runtime.steps import make_train_step as j_make_train_step
    mesh_axes, ep, moe, _ = CASES[name]
    jcfg = j_get_smoke("deepseek-v3-671b" if name in DS_CASES else "dbrx-132b")
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, microbatch=MICRO,
                               attn=dataclasses.replace(jcfg.attn,
                                                        kv_chunk=config(name).attn.kv_chunk))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, ep_axis=ep, **moe))
    mesh = jax.make_mesh(tuple(s for _, s in mesh_axes), tuple(a for a, _ in mesh_axes),
                         axis_types=(jax.sharding.AxisType.Auto,) * len(mesh_axes),
                         devices=jax.devices()[:N])
    fwd = j_get_model(jcfg).forward

    def named(t):
        return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    # the inputs and outputs placed alike, so the second step reuses the
    # first one's executable
    rep = NamedSharding(mesh, P())
    micro0 = {k: v[0] for k, v in batches[0].items()}
    # the reference's MLA on its chunked branch (its short branch masks with
    # the transposed causal mask, tests/test_torch_mla.py)
    threshold = j_attention.CHUNKED_ATTN_THRESHOLD
    j_attention.CHUNKED_ATTN_THRESHOLD = 1 if name in DS_CASES else threshold
    try:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: fwd(p, b, jcfg, mesh), has_aux=True))(tree, micro0)
        out = dict(loss=float(loss), grads=named(grads), steps=[])
        step = jax.jit(j_make_train_step(jcfg, mesh, JAdamW(**OPT)), in_shardings=rep,
                       out_shardings=rep)
        params, opt = jax.device_put((tree, j_adamw_init(tree, JAdamW(**OPT))), rep)
        for b in batches:
            params, opt, m = step(params, opt, jax.device_put(b, rep))
            out["steps"].append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                     lr=float(m["lr"]), params=named(jax.device_get(params))))
    finally:
        j_attention.CHUNKED_ATTN_THRESHOLD = threshold
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the workers and start the launcher; compute the JAX
    references while they run; join both."""
    inp = inputs()
    work = tmp_path_factory.mktemp("dist_train")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    launch = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dbrx-132b", "--smoke",
         "--device", "cpu", "--mesh", str(N), "--steps", "10", "--global-batch", "8",
         "--seq", "16"], env=env, cwd=work, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    box = {}

    def go():
        try:
            # under the suite's parallel workers the spawn took 222 s of the
            # old 240 (DeepSeek-V3's case included); a hang still ends
            box["ranks"] = spawn(worker, N, inp, timeout=420, workdir=work)
        except BaseException as e:               # re-raised in the test process
            box["error"] = e
    th = threading.Thread(target=go)
    th.start()
    try:
        jref = {name: jax_case(name, *inp[name]) for name in JAX_CASES}
    finally:
        th.join(480)
        try:
            launch_out, _ = launch.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            launch.kill()
            launch_out, _ = launch.communicate()
    assert not th.is_alive(), "the workers did not end"
    if "error" in box:
        raise box["error"]
    return dict(inp=inp, ranks=box["ranks"], local=box["ranks"][0]["local"], jax=jref,
                launch=(launch.returncode, launch_out))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _rel_close(got, want, rel, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def _shard(path: str, a: np.ndarray, name: str, comm: dict) -> np.ndarray:
    """This process's part of the reference's full leaf ``a``."""
    c = types.SimpleNamespace(**comm)
    return _shard_leaf(tuple(path.split("/")), torch.from_numpy(np.array(a)), config(name),
                       c).numpy()


def _cut(path: str, name: str, comm: dict) -> bool:
    return is_cut(tuple(path.split("/")), config(name), types.SimpleNamespace(**comm))


def _params_close(got: dict, want: dict, what: str):
    """``tests/test_torch_train_step.py``'s tolerance: within 1e-5 but for
    at most one element in a thousand, and those within a tenth of the
    learning rate."""
    lr = OPT["lr"]
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0.1 * lr, err_msg=f"{what} {path}")
        assert (np.abs(g - w) > 1e-5 + 1e-5 * np.abs(w)).mean() <= 1e-3, f"{what} {path}"


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_gradients_match_jax(run, case):
    """The loss within 1e-5 and every reduced gradient within 1e-4 of its
    largest value of JAX's value_and_grad on the same mesh, on each
    process (expert leaves: its rows and F-slice of JAX's)."""
    want = run["jax"][case]
    for r in run["ranks"]:
        got, comm = r["cases"][case], r["comms"][case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert set(got["grads"]) == set(want["grads"])
        for path, g in got["grads"].items():
            _rel_close(g, _shard(path, want["grads"][path], case, comm), 1e-4, path)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_train_steps_match_jax(run, case):
    """Two steps against JAX's jitted make_train_step on the mesh: the
    loss within 1e-5, the global gradient norm within 1e-4 (the same on
    every process), the learning rate exactly, every parameter (this
    process's part) within test_torch_train_step's tolerance."""
    want = run["jax"][case]["steps"]
    for r in run["ranks"]:
        comm = r["comms"][case]
        for i, (got, w) in enumerate(zip(r["cases"][case]["steps"], want)):
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], w["grad_norm"], rtol=1e-4)
            assert got["lr"] == w["lr"]
            _params_close(got["params"], {p: _shard(p, a, case, comm)
                                          for p, a in w["params"].items()},
                          f"rank {r['comms'][case]['ranks']} step {i + 1}")


@pytest.mark.parametrize("case", sorted(c for c, v in CASES.items() if v[3]))
def test_train_steps_match_local_comm(run, case):
    """The same steps over LocalComm of the same EP extent, every rank in
    one process: the loss within 1e-5, the norm within 1e-4, each
    process's part of the parameters within the step tolerance."""
    local = run["local"][case]["steps"]
    for r in run["ranks"]:
        comm = r["comms"][case]
        for got, w in zip(r["cases"][case]["steps"], local):
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], w["grad_norm"], rtol=1e-4)
            _params_close(got["params"], {p: _shard(p, a, case, comm)
                                          for p, a in w["params"].items()}, "LocalComm")


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_leaves_bitwise_equal(run, case):
    """After each step every leaf a process holds whole is bitwise equal on
    the four processes, and so are the loss and the gradient norm; the
    cut leaves are the three expert leaves of each MoE layer stack (and of
    DeepSeek-V3's MTP layer)."""
    ranks = run["ranks"]
    for i in range(STEPS):
        steps = [r["cases"][case]["steps"][i] for r in ranks]
        assert len({(s["loss"], s["grad_norm"]) for s in steps}) == 1
        cut = 0
        for path, a in steps[0]["params"].items():
            if _cut(path, case, ranks[0]["comms"][case]):
                cut += 1
                continue
            for s in steps[1:]:
                np.testing.assert_array_equal(s["params"][path], a, err_msg=path)
        assert cut == 3 * (1 + config(case).mtp)


def test_deepseek_trains_through_mla_chunked(run):
    """The DeepSeek-V3 case's MLA backward is MlaChunked's: one call a row
    and a layer (the MTP layer's too), in the gradient step and in each
    micro-batch of the two train steps, on every process."""
    cfg = config("ds_data4_ht")
    per_row = cfg.num_layers + cfg.mtp
    for r in run["ranks"]:
        assert r["cases"]["ds_data4_ht"]["mla_bwd_calls"] == per_row * (1 + STEPS * MICRO)
        assert r["cases"]["data4_ht"]["mla_bwd_calls"] == 0


def test_trainer_over_dist_comm(run):
    """Trainer(comm=DistComm): every process logs the same losses and
    norms, within 1e-5 of LocalComm(4)'s Trainer on the same seed; a
    checkpoint directory over a DistComm is refused, naming A10d."""
    logs = [r["trainer"] for r in run["ranks"]]
    assert len(logs[0]) == TRAIN["steps"] and all(log == logs[0] for log in logs)
    local = run["ranks"][0]["local_trainer"]
    assert np.isfinite(np.array(logs[0])).all()
    np.testing.assert_allclose(np.array(logs[0]), np.array(local), rtol=1e-5)
    for r in run["ranks"]:
        assert "A10d" in r["ckpt_refusal"]


def test_launch_train_end_to_end(run):
    """launch/train.py --mesh 4 on the CPU: four gloo processes train 10
    steps; rank 0 alone prints the metric line."""
    rc, out = run["launch"]
    assert rc == 0, out
    lines = [ln for ln in out.splitlines() if ln.startswith("[train] step=")]
    assert len(lines) == 1 and lines[0].startswith("[train] step=10 loss="), out
