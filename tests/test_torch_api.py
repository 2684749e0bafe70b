"""The rest of the EP API surface against the JAX package.

``ep_handle_get_num_recv_tokens`` (the paper's
``ncclEpHandleGetNumRecvTokens``) must give JAX's receive count on the same
routing in every mode and layout, with and without fp8 dispatch: JAX runs its
8 EP ranks as fake CPU devices under shard_map (a ("pod", "data") mesh of
2 x 4 for the hierarchical HT path), the port hosts them in one process with
``LocalComm(8)``. It returns the handle's [] tensor without a host read-back,
so a captured step may call it. ``EpGroup``'s buffer byte counts (the paper's
Eq. 3, ``benchmarks/bench_memory.py``), ``registered_modes`` and DeepSeek-V3's
``update_selection_bias`` are held equal to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core as jcore
from repro.core.routing import update_selection_bias as j_update_bias
from repro_torch import core as tcore
from repro_torch.comm import LocalComm
from repro_torch.core.routing import update_selection_bias
from test_torch_decode import HostSyncGuard

No, Ni, E, K, T, H = 2, 4, 16, 4, 16, 32
N = No * Ni
VALID = T - 3          # the last rows of every rank are padding
MODES = {"ll_nccl_ep": dict(mode="ll"),
         "ll_deepep": dict(mode="ll", ll_layout="deepep"),
         "ht_flat": dict(mode="ht"),
         "ht_hier": dict(mode="ht", ep_axis=("pod", "data"), ht_hierarchical=True),
         "baseline": dict(mode="baseline")}


def routing(seed):
    rng = np.random.default_rng(seed)
    topk = np.stack([np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
                     for _ in range(N)]).astype(np.int32)
    w = rng.random((N, T, K)).astype(np.float32)
    return topk, w / w.sum(-1, keepdims=True)


def group_kw(name, fp8):
    return dict(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K,
                quantize_dispatch=fp8, quant_block=H, **MODES[name])


def jax_counts(name, fp8, topk, w):
    """JAX's per-rank receive count and tokens per local expert, [N, ...]."""
    hier = name == "ht_hier"
    group = jcore.ep_create_group(jcore.EpGroupConfig(**group_kw(name, fp8)), ep_size=N,
                                  **(dict(inner_size=Ni) if hier else {}))
    axes = ("pod", "data") if hier else ("data",)
    mesh = jax.make_mesh((No, Ni) if hier else (N,), axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    spec = P(axes)

    def step(tk, wt):
        h = jcore.ep_create_handle(group, tk[0], wt[0], VALID)
        return (jcore.ep_handle_get_num_recv_tokens(h)[None],
                h.tokens_per_expert[None])

    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec)))
    n, tpe = fn(jnp.asarray(topk), jnp.asarray(w))
    return np.asarray(n), np.asarray(tpe)


def torch_handles(name, fp8, topk, w):
    comm = (LocalComm(N, axes=(("pod", No), ("data", Ni))) if name == "ht_hier"
            else LocalComm(N))
    group = tcore.ep_create_group(tcore.EpGroupConfig(payload_dtype=torch.float32,
                                                      **group_kw(name, fp8)), comm)
    return tcore.ep_create_handle(group, [torch.from_numpy(a) for a in topk],
                                  [torch.from_numpy(a) for a in w], VALID)


@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
@pytest.mark.parametrize("name", sorted(MODES))
def test_num_recv_tokens_matches_jax(name, fp8):
    topk, w = routing(3)
    want_n, want_tpe = jax_counts(name, fp8, topk, w)
    handles = torch_handles(name, fp8, topk, w)
    got = [tcore.ep_handle_get_num_recv_tokens(h) for h in handles]
    assert all(g.dim() == 0 for g in got)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want_n)
    np.testing.assert_array_equal(np.stack([h.tokens_per_expert.numpy() for h in handles]),
                                  want_tpe)
    # the receive count is the sum of the per-expert counts
    assert int(want_n.sum()) == int(want_tpe.sum()) > 0
    for h in handles:
        assert tcore.ep_handle_destroy(h) is None


@pytest.mark.parametrize("name", sorted(MODES))
def test_num_recv_tokens_has_no_host_read_back(name):
    """The query returns the handle's own device tensor, and reads nothing
    back, so it is legal inside a captured step."""
    topk, w = routing(5)
    handles = torch_handles(name, False, topk, w)
    with HostSyncGuard() as guard:
        got = [tcore.ep_handle_get_num_recv_tokens(h) + 0 for h in handles]
    assert guard.bad == []
    for g, h in zip(got, handles):
        assert torch.equal(g, h.num_recv_tokens)
        assert tcore.ep_handle_get_num_recv_tokens(h) is h.num_recv_tokens


# bench_memory.py's (N, E, K) grid at H 7168, B 128, and narrower groups
GRID = [(8, 256, 8), (16, 256, 8), (32, 256, 8), (64, 256, 8), (64, 512, 8),
        (16, 64, 4), (32, 128, 6), (4, 16, 4)]
PAYLOADS = {"bf16": dict(), "fp8": dict(quantize_dispatch=True),
            "fp8_block64": dict(quantize_dispatch=True, quant_block=64),
            "f32": dict(payload_dtype="float32")}


@pytest.mark.parametrize("cf", [None, 2.0], ids=["zero_drop", "cf2"])
@pytest.mark.parametrize("payload", sorted(PAYLOADS))
@pytest.mark.parametrize("nek", GRID, ids=[f"N{n}_E{e}_K{k}" for n, e, k in GRID])
def test_buffer_bytes_match_jax(nek, payload, cf):
    n, e, k = nek
    extra = dict(PAYLOADS[payload])
    dt = extra.pop("payload_dtype", "bfloat16")
    kw = dict(num_experts=e, max_tokens_per_rank=128, hidden=7168, top_k=k, mode="ll",
              capacity_factor=cf, **extra)
    jg = jcore.ep_create_group(jcore.EpGroupConfig(payload_dtype=getattr(jnp, dt), **kw),
                               ep_size=n)
    tg = tcore.ep_create_group(tcore.EpGroupConfig(payload_dtype=getattr(torch, dt), **kw),
                               ep_size=n)
    for f in ("payload_bytes_per_token", "ll_dispatch_buffer_bytes",
              "ll_combine_buffer_bytes"):
        got, want = getattr(tg, f)(), getattr(jg, f)()
        assert type(got) is int and got == want, (f, got, want)


def test_registered_modes_match_jax():
    assert tcore.registered_modes() == jcore.registered_modes() == ("baseline", "ht", "ll")
    for mode in tcore.registered_modes():
        assert tcore.get_backend(mode).mode == mode


def test_core_exports_the_reference_surface():
    """Everything ``repro.core`` exports that the port has; placement's
    exports wait for EPLB, and ``EpBackend`` is a typing protocol."""
    names = ("EpGroup", "EpGroupConfig", "EpHandle", "EpPending", "ep_create_group",
             "ep_create_handle", "ep_handle_refresh", "ep_dispatch", "ep_combine",
             "ep_complete", "ep_handle_get_num_recv_tokens", "ep_handle_destroy",
             "ep_dispatch_tensors", "ep_combine_tensors", "registered_modes",
             "BaseBackend", "get_backend", "register_backend", "EpPlan", "build_plan",
             "routing_hash", "RouterConfig", "RouterOutput", "route", "EpTensor",
             "EpTensorTag", "ep_tensor_create")
    assert [n for n in names if not hasattr(jcore, n)] == []
    assert [n for n in names if not hasattr(tcore, n)] == []


@pytest.mark.parametrize("rate", [1e-3, 0.05])
@pytest.mark.parametrize("e", [8, 64, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_selection_bias_bitwise(seed, e, rate):
    rng = np.random.default_rng(seed)
    bias = (rng.standard_normal(e) * 1e-2).astype(np.float32)
    load = rng.integers(0, 9, e).astype(np.float32) / 8.0
    load[: e // 4] = load[: e // 4].mean()      # some experts sit near the mean
    want = np.asarray(j_update_bias(jnp.asarray(bias), jnp.asarray(load), rate))
    got = update_selection_bias(torch.from_numpy(bias), torch.from_numpy(load), rate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_update_selection_bias_default_rate():
    bias = torch.zeros(4)
    load = torch.tensor([0.0, 0.25, 0.25, 0.5])
    got = update_selection_bias(bias, load)
    want = np.asarray(j_update_bias(jnp.zeros(4), jnp.asarray(load.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1] == 0 and got[0] > 0 > got[3]
