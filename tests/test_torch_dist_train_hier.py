"""Training hierarchical HT with a ``model`` axis over ``comm.DistComm``
(gloo on the CPU), against the JAX package on a (pod 2, data 2, model 2)
mesh of eight fake devices.

DBRX's smoke config in f32, hierarchical HT with 2 chunks and capacities
1.25, in the two forms the reference builds on that mesh:

* ``hier_tp``: EP over ("pod", "data"), the outer stage over pods; the
  ``model`` axis carries expert tensor parallelism (each process an
  F-slice of its experts, the partial sums all-reduced over ``model``).
* ``hier_seq``: EP over ("data", "model"), the outer stage over ``data``
  and the inner over ``model`` (DeepSeek-V3's train preset); ``model``
  splits the sequence inside the MoE layer and ``pod`` is a replica axis.

(EP over all three axes is not a form: the reference's hierarchical
exchange takes two EP axes, and over three its forward raises.)

Eight worker processes are spawned once for the file (a ``file://``
rendezvous under ``tmp_path``, one thread each); JAX runs in the parent
while they run. Each worker runs ``make_grad_step`` on micro-batch 0 and
two steps of ``make_train_step`` (2 micro-batches, AdamW clipping at the
global norm), held as ``tests/test_torch_dist_train.py`` holds its flat
cases: the loss within 1e-5, every gradient within 1e-4 of its largest
value (an expert leaf against its process's rows and F-slice of JAX's),
the steps within ``tests/test_torch_train_step.py``'s tolerance, and every
replicated leaf bitwise equal on the eight processes. The workers import
this module by name, so it imports no JAX at its top.
"""
import dataclasses
import datetime
import types

import numpy as np
import pytest
import torch

from repro_torch.comm import DistComm
from repro_torch.configs import dbrx_132b
from repro_torch.launch.mesh import init_process, spawn
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.steps import make_grad_step, make_train_step
from repro_torch.weights import _shard_leaf, is_cut, params_from_jax, shard_params
from test_torch_dist_train import OPT, _params_close, _rel_close, flat, np_params

N = 8
MESH = (("pod", 2), ("data", 2), ("model", 2))
TIMEOUT = datetime.timedelta(seconds=90)
HIER = dict(ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25,
            ht_hierarchical=True, ht_num_chunks=2)
# name -> the EP axes
CASES = {"hier_tp": ("pod", "data"), "hier_seq": ("data", "model")}
MICRO, BATCH, SEQ, STEPS = 2, 8, 32, 2


def config(name: str):
    """DBRX's smoke config in f32, two micro-batches, hierarchical HT over
    the case's EP axes."""
    cfg = dataclasses.replace(dbrx_132b.smoke_config(), dtype=torch.float32, microbatch=MICRO)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_axis=CASES[name],
                                                            **HIER))


def inputs() -> dict:
    """Every case's parameters and its STEPS batches [MICRO, BATCH/MICRO,
    SEQ] of tokens and targets, from seeds."""
    out = {}
    for i, name in enumerate(CASES):
        cfg = config(name)
        rng = np.random.default_rng(200 + i)
        batches = [{k: rng.integers(0, cfg.vocab, (MICRO, BATCH // MICRO, SEQ)).astype(np.int32)
                    for k in ("tokens", "targets")} for _ in range(STEPS)]
        out[name] = (np_params(cfg, 20 + i), batches)
    return out


def worker(rank: int, world: int, init_method: str, inp: dict) -> dict:
    torch.set_num_threads(1)
    init_process(MESH, "cpu", init_method, rank=rank, world=world, timeout=TIMEOUT)
    out = {}
    for name, ep in CASES.items():
        comm = DistComm(MESH, ep_axes=ep, timeout=TIMEOUT)
        tree, batches = inp[name]
        cfg = config(name)
        params = shard_params(params_from_jax(tree, cfg, device="cpu"), cfg, comm)
        rows = comm.batch_rows(BATCH // MICRO)
        local = [{k: torch.from_numpy(v[:, rows]) for k, v in b.items()} for b in batches]
        loss, sums = make_grad_step(cfg, comm)(params, {k: v[:1] for k, v in local[0].items()})
        res = dict(loss=float(loss), grads=flat(sums), steps=[],
                   comm=dict(ranks=comm.ranks, size=comm.size, tp_axis=comm.tp_axis,
                             seq_axis=comm.seq_axis, mesh=comm.mesh, coords=dict(comm.coords)))
        step = make_train_step(cfg, comm, AdamWConfig(**OPT))
        opt = adamw_init(params, AdamWConfig(**OPT))
        for b in local:
            params, opt, m = step(params, opt, b)
            res["steps"].append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                     lr=float(m["lr"]), params=flat(params)))
        out[name] = res
    return out


def jax_case(name: str, tree, batches) -> dict:
    """JAX's value_and_grad of lm_forward on micro-batch 0 and STEPS steps
    of its jitted make_train_step on the (pod, data, model) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.dbrx_132b import smoke_config as j_smoke
    from repro.models import get_model as j_get_model
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import adamw_init as j_adamw_init
    from repro.runtime.steps import make_train_step as j_make_train_step
    jcfg = dataclasses.replace(j_smoke(), dtype=jnp.float32, microbatch=MICRO)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, ep_axis=CASES[name],
                                                             **HIER))
    mesh = jax.make_mesh(tuple(s for _, s in MESH), tuple(a for a, _ in MESH),
                         axis_types=(jax.sharding.AxisType.Auto,) * len(MESH),
                         devices=jax.devices()[:N])
    fwd = j_get_model(jcfg).forward

    def named(t):
        return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    rep = NamedSharding(mesh, P())
    micro0 = {k: v[0] for k, v in batches[0].items()}
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
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the eight workers, compute JAX's references while they run,
    and join them."""
    import threading
    inp = inputs()
    work = tmp_path_factory.mktemp("dist_train_hier")
    box = {}

    def go():
        try:
            box["ranks"] = spawn(worker, N, inp, timeout=240, workdir=work)
        except BaseException as e:               # re-raised in the test process
            box["error"] = e
    th = threading.Thread(target=go)
    th.start()
    try:
        jref = {name: jax_case(name, *inp[name]) for name in CASES}
    finally:
        th.join(300)
    assert not th.is_alive(), "the workers did not end"
    if "error" in box:
        raise box["error"]
    return dict(ranks=box["ranks"], jax=jref)


def _shard(path: str, a: np.ndarray, name: str, comm: dict) -> np.ndarray:
    """This process's part of the reference's full leaf ``a``."""
    return _shard_leaf(tuple(path.split("/")), torch.from_numpy(np.array(a)), config(name),
                       types.SimpleNamespace(**comm)).numpy()


def test_forms_take_the_model_axis(run):
    """The two cases are the two forms: expert-TP over model with EP
    extent 4 over (pod, data), and the sequence split over model with EP
    extent 4 over (data, model); every process is a distinct EP rank of
    its pod in the first, a pair of processes shares one in the second."""
    for r in run["ranks"]:
        tp, seq = r["hier_tp"]["comm"], r["hier_seq"]["comm"]
        assert (tp["tp_axis"], tp["seq_axis"], tp["size"]) == ("model", None, 4)
        assert (seq["tp_axis"], seq["seq_axis"], seq["size"]) == (None, "model", 4)
    assert sorted({r["hier_seq"]["comm"]["ranks"] for r in run["ranks"]}) == [
        (0,), (1,), (2,), (3,)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(run, case):
    """The loss within 1e-5 and every reduced gradient within 1e-4 of its
    largest value of JAX's value_and_grad on the same mesh, on each
    process (expert leaves: its rows and F-slice of JAX's)."""
    want = run["jax"][case]
    for r in run["ranks"]:
        got = r[case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert set(got["grads"]) == set(want["grads"])
        for path, g in got["grads"].items():
            _rel_close(g, _shard(path, want["grads"][path], case, got["comm"]), 1e-4, path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(run, case):
    """Two steps against JAX's jitted make_train_step on the mesh: the loss
    within 1e-5, the global gradient norm within 1e-4, the learning rate
    exactly, every parameter (this process's part) within
    test_torch_train_step's tolerance."""
    want = run["jax"][case]["steps"]
    for r in run["ranks"]:
        comm = r[case]["comm"]
        for i, (got, w) in enumerate(zip(r[case]["steps"], want)):
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], w["grad_norm"], rtol=1e-4)
            assert got["lr"] == w["lr"]
            _params_close(got["params"], {p: _shard(p, a, case, comm)
                                          for p, a in w["params"].items()},
                          f"rank {comm['ranks']} step {i + 1}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_leaves_bitwise_equal(run, case):
    """After each step every leaf a process holds whole is bitwise equal on
    the eight processes, and so are the loss and the gradient norm; the
    three expert leaves are cut."""
    ranks = run["ranks"]
    for i in range(STEPS):
        steps = [r[case]["steps"][i] for r in ranks]
        assert len({(s["loss"], s["grad_norm"]) for s in steps}) == 1
        cut = 0
        for path, a in steps[0]["params"].items():
            if is_cut(tuple(path.split("/")), config(case),
                      types.SimpleNamespace(**ranks[0][case]["comm"])):
                cut += 1
                continue
            for s in steps[1:]:
                np.testing.assert_array_equal(s["params"][path], a, err_msg=path)
        assert cut == 3
