"""The port's HT flat path against the JAX package on the same routing.

JAX runs its 8 EP ranks as fake CPU devices under shard_map; the port hosts
its 8 ranks in one process with ``LocalComm(8)``. Every EpPlan map of every
rank and the dispatch output [L, A, H] must match bit for bit, fp8 payloads
included, with and without capacity drops. The round trip must satisfy the
oracle (each expert e scales its rows by 1+e, so token t comes back as
x[t]·Σ_k w[t,k]·(1+topk[t,k]) over its kept entries), and the HT MoE block
must equal JAX's within 1e-5 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.core import ht as jht
from repro.core.group import EpGroupConfig as JCfg
from repro.core.group import ep_create_group as j_create_group
from repro.models.moe import moe_block as jax_moe_block
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.core import (EpGroupConfig, ep_combine, ep_complete,
                              ep_create_group, ep_create_handle, ep_dispatch)
from repro_torch.kernels import ref
from repro_torch.models.moe import _moe_dense_fallback, ep_group, moe_block
from repro_torch.weights import params_from_jax

N = 8
E, K, T, H = 16, 4, 64, 32
MAPS = ("disp_send_gmap", "disp_recv_gmap", "disp_counts", "comb_send_gmap",
        "comb_recv_rows")
F32 = dict(rtol=1e-5, atol=1e-5)


def routing(seed, h=H, skew=False):
    """Per-rank routing [N, T, K] (distinct experts per token), normalised
    weights and tokens, from a numpy seed. ``skew`` favours experts 0 and 1
    (both on rank 0), so the pair and expert capacities overflow."""
    rng = np.random.default_rng(seed)
    p = np.ones(E)
    if skew:
        p[:2] = 12.0
    p /= p.sum()
    topk = np.stack([np.stack([rng.choice(E, K, replace=False, p=p) for _ in range(T)])
                     for _ in range(N)]).astype(np.int32)
    w = rng.random((N, T, K)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    x = rng.standard_normal((N, T, h)).astype(np.float32)
    return topk, w, x


def configs(hidden=H, **kw):
    base = dict(num_experts=E, max_tokens_per_rank=T, hidden=hidden, top_k=K, mode="ht")
    return (EpGroupConfig(payload_dtype=torch.float32, **base, **kw),
            JCfg(payload_dtype=jnp.float32, **base, **kw))


def jax_run(jcfg, topk, w, x, roundtrip=False):
    """Per-rank plan maps and dispatch output (and the round trip) through
    the JAX production path, stacked [N, ...] as numpy."""
    group = j_create_group(jcfg, ep_size=N)
    mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))

    def step(tk, wt, xs):
        h = jht.ht_create_handle(group, tk[0], wt[0])
        out = {f: getattr(h.plan, f)[None] for f in MAPS}
        out["tokens_per_expert"] = h.tokens_per_expert[None]
        y3d, _ = jht.ht_dispatch(group, h, xs[0])
        out["y3d"] = y3d[None]
        if roundtrip:
            L = group.local_experts
            e_glob = jax.lax.axis_index("data") * L + jnp.arange(L)
            out["out"] = jht.ht_combine(
                group, h, y3d * (1.0 + e_glob)[:, None, None].astype(y3d.dtype))[None]
        return out

    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P("data"),) * 3,
                               out_specs=P("data")))
    res = fn(jnp.asarray(topk), jnp.asarray(w), jnp.asarray(x))
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
            for k, v in res.items()}


def torch_run(tcfg, topk, w, x, comm=None):
    group = ep_create_group(tcfg, comm or LocalComm(N))
    handles = ep_create_handle(group, [torch.from_numpy(t) for t in topk],
                               [torch.from_numpy(t) for t in w])
    xs = [torch.from_numpy(r) for r in x]
    recv = ep_complete(group, handles, ep_dispatch(group, handles, xs, send_only=True))
    L = group.local_experts
    y3ds = [y * (1.0 + torch.arange(r * L, (r + 1) * L)).to(y.dtype)[:, None, None]
            for r, (y, _) in zip(group.comm.ranks, recv)]
    outs = ep_complete(group, handles, ep_combine(group, handles, y3ds, send_only=True))
    return group, handles, recv, outs


def oracle(x, topk, w, kept=None):
    f = w * (1.0 + topk)
    if kept is not None:
        f = f * kept
    return x * f.sum(-1)[..., None]


# name -> (group options, skewed routing, whether entries must be dropped)
CASES = {
    "zero_drop": (dict(), False, False),
    "dbrx_preset": (dict(capacity_factor=1.25, expert_capacity_factor=1.25), False, False),
    "drops": (dict(capacity_factor=1.25, expert_capacity_factor=0.5), True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ht_flat_maps_and_dispatch_match_jax(case):
    kw, skew, must_drop = CASES[case]
    tcfg, jcfg = configs(**kw)
    topk, w, x = routing(20, skew=skew)
    want = jax_run(jcfg, topk, w, x)
    group, handles, recv, _ = torch_run(tcfg, topk, w, x)
    for name in MAPS:
        got = np.stack([getattr(h.plan, name).numpy() for h in handles])
        assert got.dtype == want[name].dtype == np.int32, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    np.testing.assert_array_equal(np.stack([h.tokens_per_expert.numpy() for h in handles]),
                                  want["tokens_per_expert"])
    np.testing.assert_array_equal(np.stack([y.numpy() for y, _ in recv]), want["y3d"])
    A = group.ht_expert_cap
    kept = sum(int(h.plan.disp_counts.clamp(max=A).sum()) for h in handles)
    assert (kept < N * T * K) == must_drop, (kept, N * T * K)


def test_ht_fp8_dispatch_bitwise():
    """fp8 payload: the dispatch output, dequantized in recv_unpack, is bit
    equal to JAX's, drops included."""
    tcfg, jcfg = configs(hidden=256, quantize_dispatch=True, capacity_factor=1.25,
                         expert_capacity_factor=0.5)
    topk, w, x = routing(21, h=256, skew=True)
    want = jax_run(jcfg, topk, w, x)
    _, _, recv, _ = torch_run(tcfg, topk, w, x)
    assert recv[0][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(np.stack([y.float().numpy() for y, _ in recv]), want["y3d"])


def test_ht_roundtrip_oracle_with_drops():
    """Dropped entries contribute exactly nothing: each token comes back as
    the oracle over the entries its rank's plan kept, and equals JAX's."""
    tcfg, jcfg = configs(capacity_factor=1.25, expert_capacity_factor=0.5)
    topk, w, x = routing(22, skew=True)
    want = jax_run(jcfg, topk, w, x, roundtrip=True)["out"]
    group, handles, _, outs = torch_run(tcfg, topk, w, x)
    got = np.stack([o.numpy() for o in outs])
    np.testing.assert_allclose(got, want, **F32)
    # entry (t, k) of rank s survives iff its pair slot (dst, c) exists and
    # dst's expert region holds recv row s*C + c
    C = group.ht_pair_cap
    held = [set(h.plan.disp_recv_gmap.flatten().tolist()) for h in handles]
    kept = np.zeros(topk.shape, bool)
    for s, h in enumerate(handles):
        for (t, k), r in np.ndenumerate(h.plan.comb_recv_rows.numpy()):
            kept[s, t, k] = r < N * C and s * C + r % C in held[r // C]
    assert 0 < (~kept).sum() < kept.size
    np.testing.assert_allclose(got, oracle(x, topk, w, kept), **F32)


def test_ht_roundtrip_fp8_close_to_dequantized_oracle():
    """Zero drop, fp8 payload: lossy only by the quantization, so the round
    trip matches the oracle of the plain quantize->dequantize of x within
    the JAX package's fp8 tolerance (2e-2, tests/test_ep_ht.py)."""
    tcfg, _ = configs(hidden=256, quantize_dispatch=True)
    topk, w, x = routing(23, h=256)
    *_, outs = torch_run(tcfg, topk, w, x)
    q, s = ref.quantize_fp8(torch.from_numpy(x), 128)
    xq = ref.dequantize_fp8(q, s).float().numpy()
    got = np.stack([o.float().numpy() for o in outs])
    np.testing.assert_allclose(got, oracle(xq, topk, w), rtol=2e-2, atol=2e-2)


def test_hierarchical_and_baseline_refused():
    """Neither is refused any more. The hierarchical group (two pods of
    four) is created with the reference's stage capacities and takes the
    two-stage path; the baseline's handle carries the a2a plan."""
    for kw in (dict(), dict(capacity_factor=1.25, expert_capacity_factor=1.25),
               dict(ht_num_chunks=2)):
        tcfg, jcfg = configs(ep_axis=("pod", "data"), ht_hierarchical=True, **kw)
        got = ep_create_group(tcfg, LocalComm(N, axes=(("pod", 2), ("data", 4))))
        want = j_create_group(jcfg, ep_size=N, inner_size=4)
        assert got.hierarchical and (got.outer_size, got.inner_size) == (2, 4)
        for f in ("ht_pair_cap", "ht_expert_cap", "ht_stage1_cap", "ht_stage2_cap",
                  "local_experts", "inner_size", "outer_size"):
            assert getattr(got, f) == getattr(want, f), f
    tcfg, _ = configs(ep_axis=("pod", "data"), ht_hierarchical=True)
    with pytest.raises(ValueError, match="pods"):   # no sub-group axes to exchange over
        ep_create_group(tcfg, LocalComm(N), inner_size=4)
    assert ep_create_group(configs()[0], LocalComm(N)).outer_size == 1   # one pod: flat
    mcfg = smoke_config()
    hier = dataclasses.replace(mcfg, moe=dataclasses.replace(
        mcfg.moe, ep_mode="ht", ep_axis=("pod", "data"), ht_hierarchical=True))
    assert ep_group(hier, LocalComm(N, axes=(("pod", 2), ("data", 4))), T).hierarchical
    assert not ep_group(hier, LocalComm(N), T).hierarchical    # one EP axis: flat
    # the baseline was refused until its backend landed; its handle now
    # carries the a2a plan: [N, L·Ce] send blocks, positional recv (no map)
    base, _ = configs()
    base = dataclasses.replace(base, mode="baseline")
    topk, w, _ = routing(24)
    hs = ep_create_handle(ep_create_group(base, LocalComm(N)),
                          [torch.from_numpy(t) for t in topk], [torch.from_numpy(t) for t in w])
    assert hs[0].plan.disp_send_gmap.shape == (N, E // N * T)
    assert hs[0].plan.disp_recv_gmap is None


@pytest.mark.parametrize("fp8", [False, True])
def test_flat_over_two_axes_equals_one_axis(fp8):
    """HT over ("pod", "data") without ``ht_hierarchical`` is the flat path
    over all 8 ranks (JAX's ``_hierarchical`` is false): every map, the
    dispatch tensor and the round trip bitwise equal to the one-axis group."""
    h = 256 if fp8 else H
    kw = dict(hidden=h, quantize_dispatch=fp8, capacity_factor=1.25,
              expert_capacity_factor=1.25)
    one, _ = configs(**kw)
    two, _ = configs(ep_axis=("pod", "data"), ht_hierarchical=False, **kw)
    topk, w, x = routing(25, h=h)
    g1, h1, r1, o1 = torch_run(one, topk, w, x)
    g2, h2, r2, o2 = torch_run(two, topk, w, x, LocalComm(N, axes=(("pod", 2), ("data", 4))))
    assert not g2.hierarchical and g2.outer_size == 2
    for a, b in zip(h1, h2):
        for name in MAPS:
            assert torch.equal(getattr(a.plan, name), getattr(b.plan, name)), name
    for (ya, ca), (yb, cb), oa, ob in zip(r1, r2, o1, o2):
        assert torch.equal(ya, yb) and torch.equal(ca, cb) and torch.equal(oa, ob)


def _ht_smoke_cfgs(fp8: bool):
    """The DBRX smoke config in f32 with the train preset's EP options: HT,
    capacities 1.25, fp8 dispatch if asked (d_model 128 for the 128-wide
    block)."""
    ep = dict(ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25,
              quantize_dispatch=fp8)
    jcfg, tcfg = jax_smoke(), smoke_config()
    jcfg = dataclasses.replace(jcfg, d_model=128, dtype=jnp.float32,
                               moe=dataclasses.replace(jcfg.moe, **ep))
    tcfg = dataclasses.replace(tcfg, d_model=128, dtype=torch.float32,
                               moe=dataclasses.replace(tcfg.moe, **ep))
    return jcfg, tcfg


@pytest.mark.parametrize("fp8", [False, True])
def test_moe_block_ht_matches_jax(fp8):
    """The HT MoE layer (capacity 1.25) on 8 ranks: JAX on 8 fake devices
    against LocalComm(8). In f32 within 1e-5; with fp8 dispatch the expert
    input is dequantized to bf16 (bitwise equal, above) and the expert
    GEMMs round to bf16, where a last-bit difference of the two packages'
    f32 sums flips a rounding now and then: within 2e-2 there."""
    jcfg, tcfg = _ht_smoke_cfgs(fp8)
    tol = dict(rtol=2e-2, atol=2e-2) if fp8 else F32
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(5), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tcfg, device="cpu")
    p_np = jax.tree.map(lambda a: a[0], tree["moe_stack"]["moe"])
    p_t = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    x = np.random.default_rng(6).standard_normal((N, 32, 128)).astype(np.float32)
    mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    want, want_aux = jax.jit(lambda p, x: jax_moe_block(p, x, jcfg, mesh))(p_np, jnp.asarray(x))
    got, aux = moe_block(p_t, torch.from_numpy(x), tcfg, LocalComm(N))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(aux.item(), float(want_aux), **F32)
    # lossy only by fp8 (and by any capacity drop): near the dense layer
    dense = _moe_dense_fallback(p_t, torch.from_numpy(x), tcfg).numpy()
    assert np.linalg.norm(got.numpy() - dense) / np.linalg.norm(dense) < 0.1
