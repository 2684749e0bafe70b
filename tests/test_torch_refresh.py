"""The port's handle refresh (``ep_handle_refresh``) against the JAX package.

JAX runs its 8 EP ranks as fake CPU devices under shard_map; the port hosts
its 8 ranks in one process with ``LocalComm(8)``. On the same routing, the
refreshed handle's every plan map, its counts and its routing hash must
equal JAX's bit for bit, and the round trip through it must agree with
JAX's within 1e-5 in f32 and satisfy the oracle: with each expert e scaling
its rows by (1+e), token t comes back as x[t]·Σ_k w[t,k]·(1+topk[t,k]).

The port decides the fast path on the device (``torch.where`` over every
map): a replayed routing must give the cached maps, a changed one a fresh
build's, in every mode. The hierarchical HT plan carries the one
weight-dependent field, ``h_w_slot``: a refresh rebinds it through
``h_entry_slot`` (JAX on a ("pod", "data") mesh of 2 x 4, the port on
``LocalComm`` with the same axes). The placement refresh tests of
``tests/test_refresh.py`` have their counterparts in
``tests/test_torch_eplb.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import ep_combine as j_combine
from repro.core import ep_create_handle as j_create_handle
from repro.core import ep_dispatch as j_dispatch
from repro.core import ep_handle_refresh as j_refresh
from repro.core import plan as jplan
from repro.core.group import EpGroupConfig as JCfg
from repro.core.group import ep_create_group as j_create_group
from repro_torch.comm import LocalComm
from repro_torch.core import (EpGroupConfig, ep_combine, ep_create_group,
                              ep_create_handle, ep_dispatch, ep_handle_refresh)
from repro_torch.core import plan as tplan

N, E, K, T, H = 8, 16, 4, 16, 32
F32 = dict(rtol=1e-5, atol=1e-5)
MAPS = ("disp_send_gmap", "disp_recv_gmap", "disp_counts", "comb_send_gmap",
        "comb_recv_rows")
MODES = [("ll", "nccl_ep"), ("ll", "deepep"), ("ht", "nccl_ep"), ("baseline", "nccl_ep")]


def mesh():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


def routing(seed, t=T):
    """Per-rank routing [N, t, K] of distinct experts, normalised weights
    and tokens [N, t, H], from a numpy seed."""
    rng = np.random.default_rng(seed)
    topk = np.stack([np.stack([rng.choice(E, K, replace=False) for _ in range(t)])
                     for _ in range(N)]).astype(np.int32)
    w = rng.random((N, t, K)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    x = rng.standard_normal((N, t, H)).astype(np.float32)
    return topk, w, x


def oracle(x, topk, w):
    return x * (w * (1.0 + topk)).sum(-1)[..., None]


def configs(mode, layout):
    base = dict(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K, mode=mode,
                ll_layout=layout)
    return (EpGroupConfig(payload_dtype=torch.float32, **base),
            JCfg(payload_dtype=jnp.float32, **base))


def jax_refresh(jcfg, topk, w, x, topk2=None, w2=None):
    """JAX: create a handle on (topk, w), refresh it with w2 (and topk2 if
    given), and return the refreshed handle's maps, counts and hash and the
    round trip of x through it, stacked [N, ...] as numpy."""
    group = j_create_group(jcfg, ep_size=N)
    weights_only = topk2 is None
    if weights_only:
        topk2 = topk

    def step(tk, wt, tk2, wt2, xs):
        h = j_create_handle(group, tk[0], wt[0])
        h2 = j_refresh(group, h, wt2[0], None if weights_only else tk2[0])
        out = {f: getattr(h2.plan, f)[None] for f in MAPS
               if getattr(h2.plan, f) is not None}
        out["tokens_per_expert"] = h2.tokens_per_expert[None]
        out["routing_hash"] = h2.routing_hash[None]
        y3d, _ = j_dispatch(group, h2, xs[0])
        L = group.local_experts
        e_glob = jax.lax.axis_index("data") * L + jnp.arange(L)
        out["out"] = j_combine(group, h2, y3d * (1.0 + e_glob)[:, None, None])[None]
        return out

    fn = jax.jit(jax.shard_map(step, mesh=mesh(), in_specs=(P("data"),) * 5,
                               out_specs=P("data")))
    res = fn(*(jnp.asarray(a) for a in (topk, w, topk2, w2, x)))
    return {k: np.asarray(v) for k, v in res.items()}


def t_list(a, dtype=None):
    return [torch.from_numpy(r) if dtype is None else torch.from_numpy(r).to(dtype)
            for r in a]


def roundtrip(group, handles, x):
    L = group.local_experts
    recv = ep_dispatch(group, handles, t_list(x))
    y3ds = [y * (1.0 + torch.arange(r * L, (r + 1) * L))[:, None, None]
            for r, (y, _) in zip(group.comm.ranks, recv)]
    return np.stack([o.numpy() for o in ep_combine(group, handles, y3ds)])


def check_against_jax(handles, want):
    for f in MAPS:
        got = [getattr(h.plan, f) for h in handles]
        if got[0] is None:
            continue
        got = np.stack([g.numpy() for g in got])
        assert got.dtype == want[f].dtype == np.int32, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)
    np.testing.assert_array_equal(np.stack([h.tokens_per_expert.numpy() for h in handles]),
                                  want["tokens_per_expert"])
    np.testing.assert_array_equal(np.stack([h.routing_hash.numpy() for h in handles]),
                                  want["routing_hash"].astype(np.int64))


@pytest.mark.parametrize("mode,layout", MODES)
def test_weights_refresh_reuses_plan_object(mode, layout):
    """topk_idx None: every plan object and hash is reused, only the weights
    change, and the round trip follows the new weights."""
    tcfg, jcfg = configs(mode, layout)
    topk, w, x = routing(0)
    _, w2, _ = routing(1)
    group = ep_create_group(tcfg, LocalComm(N))
    h = ep_create_handle(group, t_list(topk), t_list(w))
    w2t = t_list(w2)
    h2 = ep_handle_refresh(group, h, w2t)
    for a, b, wt in zip(h, h2, w2t):
        assert b.plan is a.plan and b.routing_hash is a.routing_hash
        assert b.topk_weights is wt
    # each rank's own topk tensors count as "no new routing" too
    h3 = ep_handle_refresh(group, h, w2t, [a.topk_idx for a in h])
    assert all(c.plan is a.plan for a, c in zip(h, h3))
    want = jax_refresh(jcfg, topk, w, x, w2=w2)
    check_against_jax(h2, want)
    got = roundtrip(group, h2, x)
    np.testing.assert_allclose(got, want["out"], **F32)
    np.testing.assert_allclose(got, oracle(x, topk, w2), **F32)


@pytest.mark.parametrize("mode,layout", MODES)
def test_refresh_same_routing_matches_original(mode, layout):
    """The same routing values in new tensors take the hash's fast path:
    every map equals the original handle's and JAX's."""
    tcfg, jcfg = configs(mode, layout)
    topk, w, x = routing(2)
    _, w2, _ = routing(3)
    group = ep_create_group(tcfg, LocalComm(N))
    h = ep_create_handle(group, t_list(topk), t_list(w))
    h2 = ep_handle_refresh(group, h, t_list(w2), t_list(topk.copy()))
    for a, b in zip(h, h2):
        assert b.plan is not a.plan
        for f in MAPS:
            if getattr(a.plan, f) is not None:
                assert torch.equal(getattr(b.plan, f), getattr(a.plan, f)), f
    want = jax_refresh(jcfg, topk, w, x, topk2=topk, w2=w2)
    check_against_jax(h2, want)
    got = roundtrip(group, h2, x)
    np.testing.assert_allclose(got, want["out"], **F32)
    np.testing.assert_allclose(got, oracle(x, topk, w2), **F32)


@pytest.mark.parametrize("mode,layout", MODES)
def test_refresh_changed_routing_rebuilds(mode, layout):
    """A changed routing must give exactly a fresh handle on it."""
    tcfg, jcfg = configs(mode, layout)
    topk, w, x = routing(4)
    topk2, w2, _ = routing(5)
    group = ep_create_group(tcfg, LocalComm(N))
    h = ep_create_handle(group, t_list(topk), t_list(w))
    h_ref = ep_handle_refresh(group, h, t_list(w2), t_list(topk2))
    h_new = ep_create_handle(group, t_list(topk2), t_list(w2))
    for a, b in zip(h_ref, h_new):
        for f in MAPS:
            if getattr(b.plan, f) is not None:
                assert torch.equal(getattr(a.plan, f), getattr(b.plan, f)), f
    want = jax_refresh(jcfg, topk, w, x, topk2=topk2, w2=w2)
    check_against_jax(h_ref, want)
    got = roundtrip(group, h_ref, x)
    np.testing.assert_array_equal(got, roundtrip(group, h_new, x))
    np.testing.assert_allclose(got, want["out"], **F32)
    np.testing.assert_allclose(got, oracle(x, topk2, w2), **F32)


def test_refresh_detects_single_rank_routing_change():
    """The hash covers the gathered routing: when one rank's routing
    changes, every rank's maps (recv maps encode the peers' choices) must
    take the rebuild."""
    tcfg, jcfg = configs("ll", "nccl_ep")
    topk, w, x = routing(6)
    topk2 = topk.copy()
    topk2[1] = routing(7)[0][1]
    group = ep_create_group(tcfg, LocalComm(N))
    h = ep_create_handle(group, t_list(topk), t_list(w))
    h2 = ep_handle_refresh(group, h, t_list(w), t_list(topk2))
    h_new = ep_create_handle(group, t_list(topk2), t_list(w))
    changed = 0
    for a, b, c in zip(h, h2, h_new):
        assert torch.equal(b.plan.disp_recv_gmap, c.plan.disp_recv_gmap)
        changed += not torch.equal(a.plan.disp_recv_gmap, c.plan.disp_recv_gmap)
    assert changed > 1                        # not only rank 1's maps moved
    want = jax_refresh(jcfg, topk, w, x, topk2=topk2, w2=w)
    check_against_jax(h2, want)
    got = roundtrip(group, h2, x)
    np.testing.assert_array_equal(got, roundtrip(group, h_new, x))
    np.testing.assert_allclose(got, want["out"], **F32)


def test_refresh_different_token_count_rebuilds():
    """A refresh on T/2 tokens cannot reuse maps of another shape: it
    rebuilds unconditionally."""
    tcfg, jcfg = configs("ll", "nccl_ep")
    topk, w, _ = routing(8)
    half = T // 2
    topk2, w2, x2 = (a[:, :half] for a in routing(9))
    topk2, w2, x2 = (np.ascontiguousarray(a) for a in (topk2, w2, x2))
    group = ep_create_group(tcfg, LocalComm(N))
    h = ep_create_handle(group, t_list(topk), t_list(w))
    h2 = ep_handle_refresh(group, h, t_list(w2), t_list(topk2))
    assert h2[0].topk_idx.shape == (half, K) and h2[0].plan.comb_recv_rows.shape == (half, K)
    want = jax_refresh(jcfg, topk, w, x2, topk2=topk2, w2=w2)
    check_against_jax(h2, want)
    got = roundtrip(group, h2, x2)
    np.testing.assert_allclose(got, want["out"], **F32)
    np.testing.assert_allclose(got, oracle(x2, topk2, w2), **F32)


def test_refresh_num_tokens_requires_topk_idx():
    tcfg, _ = configs("ll", "nccl_ep")
    topk, w, _ = routing(10)
    group = ep_create_group(tcfg, LocalComm(N))
    h = ep_create_handle(group, t_list(topk), t_list(w))
    with pytest.raises(ValueError, match="num_tokens requires topk_idx"):
        ep_handle_refresh(group, h, t_list(w), num_tokens=4)
    with pytest.raises(ValueError, match="per-rank values"):
        ep_handle_refresh(group, h[:3], t_list(w)[:3])
    # with topk_idx a padded count is taken, as at creation
    h2 = ep_handle_refresh(group, h, t_list(w), t_list(topk.copy()), num_tokens=4)
    h_new = ep_create_handle(group, t_list(topk), t_list(w), num_tokens=4)
    for a, b in zip(h2, h_new):
        assert a.num_tokens == b.num_tokens == 4
        for f in MAPS:
            if getattr(b.plan, f) is not None:
                assert torch.equal(getattr(a.plan, f), getattr(b.plan, f)), f


def test_routing_hash_sensitivity():
    """The hash equals JAX's, matches on equal input and changes on any
    entry or order change."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, E, (T, K)).astype(np.int32)
    h = tplan.routing_hash(torch.from_numpy(a))
    np.testing.assert_array_equal(h.numpy(),
                                  np.asarray(jplan.routing_hash(jnp.asarray(a))).astype(np.int64))
    assert torch.equal(h, tplan.routing_hash(torch.from_numpy(a.copy())))
    b = a.copy()
    b[3, 1] = (b[3, 1] + 1) % E
    assert not torch.equal(h, tplan.routing_hash(torch.from_numpy(b)))
    c = a.copy()
    c[0, 0], c[0, 1] = a[0, 1], a[0, 0]
    if a[0, 0] != a[0, 1]:
        assert not torch.equal(h, tplan.routing_hash(torch.from_numpy(c)))


def test_refresh_select_is_bitwise_both_ways():
    """The device-side select: with a replayed routing every map is the
    cached tensor's values, with a changed one the rebuild's, in one and
    the same code path (no host branch decides)."""
    tcfg, _ = configs("ll", "nccl_ep")
    topk, w, _ = routing(12)
    topk2, _, _ = routing(13)
    group = ep_create_group(tcfg, LocalComm(N))
    h = ep_create_handle(group, t_list(topk), t_list(w))
    fresh = ep_create_handle(group, t_list(topk2), t_list(w))
    same = ep_handle_refresh(group, h, t_list(w), t_list(topk.copy()))
    moved = ep_handle_refresh(group, h, t_list(w), t_list(topk2))
    for hs, ref in ((same, h), (moved, fresh)):
        for a, b in zip(hs, ref):
            for f in dataclasses.fields(a.plan):
                x, y = getattr(a.plan, f.name), getattr(b.plan, f.name)
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(x, y), f.name


# --------------------------------------------------------------------------
# hierarchical HT (tests/test_refresh.py:231 and :259)
# --------------------------------------------------------------------------

HIER = dict(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K, mode="ht",
            ep_axis=("pod", "data"), ht_hierarchical=True)
HMAPS = ("disp_recv_gmap", "disp_counts", "h_gmap1", "h_gmap2", "h_slot_tgt",
         "h_w_slot", "h_rail_dst_rows", "h_rail_src_rows", "h_src_rows", "h_entry_slot")


def jax_hier_refresh(topk, w, x, topk2, w2, weights_only):
    """JAX's hierarchical refresh on the 2 x 4 mesh: the refreshed plan's
    maps and the round trip through it, stacked [N, ...] as numpy."""
    group = j_create_group(JCfg(payload_dtype=jnp.float32, **HIER), ep_size=N, inner_size=4)
    m = jax.make_mesh((2, 4), ("pod", "data"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    spec = P(("pod", "data"))

    def step(tk, wt, tk2, wt2, xs):
        h = j_create_handle(group, tk[0], wt[0])
        h2 = j_refresh(group, h, wt2[0], None if weights_only else tk2[0])
        out = {f: getattr(h2.plan, f)[None] for f in HMAPS}
        y3d, _ = j_dispatch(group, h2, xs[0])
        L = group.local_experts
        me = jax.lax.axis_index("pod") * 4 + jax.lax.axis_index("data")
        out["out"] = j_combine(group, h2, y3d * (1.0 + me * L + jnp.arange(L))[:, None, None])[None]
        return out

    fn = jax.jit(jax.shard_map(step, mesh=m, in_specs=(spec,) * 5, out_specs=spec))
    res = fn(*(jnp.asarray(a) for a in (topk, w, topk2, w2, x)))
    return {k: np.asarray(v) for k, v in res.items()}


def hier_group():
    return ep_create_group(EpGroupConfig(payload_dtype=torch.float32, **HIER),
                           LocalComm(N, axes=(("pod", 2), ("data", 4))))


def check_hier(handles, want):
    for f in HMAPS:
        np.testing.assert_array_equal(np.stack([getattr(h.plan, f).numpy() for h in handles]),
                                      want[f], err_msg=f)


def test_refresh_hierarchical_weight_rebind():
    """h_w_slot is the one weight-carrying plan field: a weights-only
    refresh rebinds it through h_entry_slot into a new plan and reuses
    every map by identity; the rebound weights flow into combine."""
    topk, w, x = routing(3)
    _, w2, _ = routing(13)
    want = jax_hier_refresh(topk, w, x, topk, w2, weights_only=True)
    group = hier_group()
    hs = ep_create_handle(group, t_list(topk), t_list(w))
    hs2 = ep_handle_refresh(group, hs, t_list(w2))
    for a, b in zip(hs, hs2):
        assert b.plan is not a.plan
        assert b.plan.disp_recv_gmap is a.plan.disp_recv_gmap
        assert not torch.equal(b.plan.h_w_slot, a.plan.h_w_slot)
    check_hier(hs2, want)
    got = roundtrip(group, hs2, x)
    np.testing.assert_allclose(got, want["out"], **F32)
    np.testing.assert_allclose(got, oracle(x, topk, w2), rtol=2e-5, atol=2e-5)


def test_refresh_changed_routing_rebuilds_hier():
    """A changed routing through the select's rebuild side: the refreshed
    handle equals a fresh one bit for bit, its maps equal JAX's refresh,
    and the round trip the oracle of the new routing."""
    topk, w, x = routing(8)
    topk2, w2, _ = routing(18)
    want = jax_hier_refresh(topk, w, x, topk2, w2, weights_only=False)
    group = hier_group()
    hs = ep_create_handle(group, t_list(topk), t_list(w))
    hs2 = ep_handle_refresh(group, hs, t_list(w2), t_list(topk2))
    fresh = ep_create_handle(group, t_list(topk2), t_list(w2))
    for a, b in zip(hs2, fresh):
        for f in dataclasses.fields(tplan.EpPlan):
            va, vb = getattr(a.plan, f.name), getattr(b.plan, f.name)
            assert (va is None) == (vb is None) and (va is None or torch.equal(va, vb)), f.name
    check_hier(hs2, want)
    got = roundtrip(group, hs2, x)
    np.testing.assert_array_equal(got, roundtrip(group, fresh, x))
    np.testing.assert_allclose(got, want["out"], **F32)
    np.testing.assert_allclose(got, oracle(x, topk2, w2), rtol=2e-5, atol=2e-5)
