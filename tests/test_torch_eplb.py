"""EPLB placement through the port's EP layer, refresh, weights and drivers,
against the JAX package on shared numpy inputs (``tests/test_placement.py``
and the placement cases of ``tests/test_refresh.py`` are the reference's).

* the placed EP layer in every mode (LL ``nccl_ep`` and ``deepep``, HT flat
  and hierarchical, baseline): the plan maps bitwise equal to JAX's under a
  redundant placement; an identity placement bitwise equal to the
  contiguous default; permuted and redundant placements equal to the
  oracle (each expert e scales its rows by 1+e, token t comes back as
  x[t]·Σ_k w[t,k]·(1+topk[t,k])); a redundant placement lowering the
  largest per-rank receive on a hot-expert routing;
* the refresh: a swap forces the rebuild, a replay under an unchanged
  placement keeps the fast path;
* the weights: expand/collapse, the spec-driven adoption (in place when
  donated), ``init_params`` and ``params_from_jax`` of a physical tree;
* the drivers: ``rebalancing_decode_loop`` in adopt-once mode equal to the
  per-step expansion and to JAX's outputs and placement sequence;
  ``rebalancing_prefill`` equal to ``sequential_prefill``;
* the refusals that remain name ROADMAP A10b.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import ep_combine as j_combine
from repro.core import ep_create_handle as j_create_handle
from repro.core import ep_dispatch as j_dispatch
from repro.core import placement as JPL
from repro.core import plan as jplan
from repro.core.group import EpGroupConfig as JCfg
from repro.core.group import ep_create_group as j_create_group
from repro_torch.checkpoint import adopt_expert_params, rebind_expert_leaves
from repro_torch.comm import LocalComm
from repro_torch.core import (EpGroupConfig, ep_combine, ep_create_group, ep_create_handle,
                              ep_dispatch, ep_handle_refresh)
from repro_torch.core import placement as TPL
from repro_torch.models.config import ParamSpec

N, E, K, T, H = 8, 16, 4, 16, 32
F32 = dict(rtol=2e-5, atol=2e-5)
BACKENDS = {
    "ll": dict(mode="ll"),
    "ll/deepep": dict(mode="ll", ll_layout="deepep"),
    "ht": dict(mode="ht"),
    "ht/hier": dict(mode="ht", ep_axis=("pod", "data"), ht_hierarchical=True),
    "baseline": dict(mode="baseline"),
}
MAPS = ("disp_send_gmap", "disp_recv_gmap", "disp_counts", "comb_send_gmap",
        "comb_recv_rows", "h_gmap1", "h_gmap2", "h_slot_tgt", "h_w_slot",
        "h_rail_dst_rows", "h_rail_src_rows", "h_src_rows", "h_entry_slot")


@pytest.fixture(autouse=True)
def _quiet():
    # the greedy policy warns when a hot expert's replicas must share a rank
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def oracle(x, topk, w):
    return x * (w * (1.0 + topk)).sum(-1)[..., None]


def rand_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, T, H).astype(np.float32)
    topk = np.stack([np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
                     for _ in range(N)]).astype(np.int32)
    w = rng.randn(N, T, K).astype(np.float32)
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    return x, topk, w


def placements(kind, seed=1):
    """(port, JAX) placements of a hot first-rank neighbourhood."""
    rng = np.random.RandomState(seed)
    heat = np.ones(E)
    heat[:4] += 100.0 * rng.rand(4)
    if kind == "identity":
        return TPL.identity_placement(E, N), JPL.identity_placement(E, N)
    r = 8 if kind == "redundant" else 0
    return TPL.rebalance(heat, N, num_redundant=r), JPL.rebalance(heat, N, num_redundant=r)


def slot_experts(placement):
    """[N, L] logical expert of each slot."""
    if placement is None:
        return np.arange(E).reshape(N, -1)
    return TPL.tables(placement).slot_expert


def torch_run(kw, placement, x, topk, w):
    """Dispatch -> scale each slot by 1 + its logical expert -> combine over
    LocalComm(8); returns (out [N, T, H], counts [N, L], plans)."""
    hier = len(kw.get("ep_axis", ("data",))) > 1
    cfg = EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K,
                        payload_dtype=torch.float32, placement=placement, **kw)
    comm = LocalComm(N, axes=(("pod", 2), ("data", 4)) if hier else None)
    group = ep_create_group(cfg, comm)
    se = torch.from_numpy(slot_experts(placement)).float()
    hs = ep_create_handle(group, [torch.from_numpy(t) for t in topk],
                          [torch.from_numpy(v) for v in w])
    recv = ep_dispatch(group, hs, [torch.from_numpy(v) for v in x])
    y3ds = [y * (1.0 + se[r])[:, None, None] for r, (y, _) in zip(comm.ranks, recv)]
    out = ep_combine(group, hs, y3ds)
    return (np.stack([o.numpy() for o in out]),
            np.stack([c.numpy() for _, c in recv]), [h.plan for h in hs])


def jax_run(kw, placement, x, topk, w):
    """The reference: the same cycle under shard_map; returns (out, counts,
    the plan's maps stacked [N, ...])."""
    hier = len(kw.get("ep_axis", ("data",))) > 1
    cfg = JCfg(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K,
               payload_dtype=jnp.float32, placement=placement, **kw)
    group = j_create_group(cfg, ep_size=N, inner_size=4 if hier else None)
    se = jnp.asarray(slot_experts(placement) if placement is None
                     else JPL.tables(placement).slot_expert)
    if hier:
        mesh = jax.make_mesh((2, 4), ("pod", "data"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        spec = P(("pod", "data"))
    else:
        mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
        spec = P("data")

    def step(x, topk, w):
        h = j_create_handle(group, topk[0], w[0])
        y3d, counts = j_dispatch(group, h, x[0])
        me = jplan.my_rank(group)
        y3d = y3d * (1.0 + se[me])[:, None, None].astype(y3d.dtype)
        maps = {f: getattr(h.plan, f)[None] for f in MAPS if getattr(h.plan, f) is not None}
        return j_combine(group, h, y3d)[None], counts[None], maps

    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(spec,) * 3,
                              out_specs=(spec, spec, spec)))
    out, counts, maps = f(jnp.asarray(x), jnp.asarray(topk), jnp.asarray(w))
    return np.asarray(out), np.asarray(counts), {k: np.asarray(v) for k, v in maps.items()}


@pytest.mark.parametrize("name", sorted(BACKENDS), ids=sorted(BACKENDS))
def test_placed_maps_and_output_equal_jax(name):
    """Under a redundant placement every plan map JAX builds equals the
    port's bitwise, the counts too, and the output JAX's within f32."""
    x, topk, w = rand_inputs(0)
    pl_t, pl_j = placements("redundant")
    out, counts, plans = torch_run(BACKENDS[name], pl_t, x, topk, w)
    want, wcounts, wmaps = jax_run(BACKENDS[name], pl_j, x, topk, w)
    np.testing.assert_array_equal(counts, wcounts)
    compared = 0
    for f, m in wmaps.items():
        got = [getattr(p, f) for p in plans]
        if got[0] is None:
            continue    # the port's positional layouts read no recv map
        got = np.stack([g.numpy() for g in got]).reshape(m.shape)
        np.testing.assert_array_equal(got, m, err_msg=f)
        compared += 1
    assert compared >= 3
    np.testing.assert_allclose(out, want, **F32)
    np.testing.assert_allclose(out, oracle(x, topk, w), **F32)


@pytest.mark.parametrize("name", sorted(BACKENDS), ids=sorted(BACKENDS))
def test_identity_placement_bitwise_matches_contiguous(name):
    """An explicit identity placement goes through the tables and must give
    the contiguous default's outputs, counts and maps bitwise."""
    x, topk, w = rand_inputs(0)
    base, cb, pb = torch_run(BACKENDS[name], None, x, topk, w)
    ident, ci, pi = torch_run(BACKENDS[name], placements("identity")[0], x, topk, w)
    np.testing.assert_array_equal(base, ident)
    np.testing.assert_array_equal(cb, ci)
    for a, b in zip(pb, pi):
        for f in MAPS:
            if getattr(a, f) is not None:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_allclose(base, oracle(x, topk, w), **F32)


@pytest.mark.parametrize("name", sorted(BACKENDS), ids=sorted(BACKENDS))
@pytest.mark.parametrize("kind", ["rebalanced", "redundant"])
def test_placed_ep_matches_oracle(name, kind):
    x, topk, w = rand_inputs(1)
    out, counts, _ = torch_run(BACKENDS[name], placements(kind)[0], x, topk, w)
    np.testing.assert_allclose(out, oracle(x, topk, w), **F32)
    assert counts.sum() == N * T * K          # every entry lands once


def test_redundant_placement_reduces_max_rank_recv():
    rng = np.random.RandomState(2)
    x = rng.randn(N, T, H).astype(np.float32)
    topk = np.stack([np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, E), K - 1, replace=False)]) for _ in range(T)])
        for _ in range(N)]).astype(np.int32)
    w = np.full((N, T, K), 1.0 / K, np.float32)
    _, c_base, _ = torch_run(BACKENDS["ht"], None, x, topk, w)
    heat = TPL.fold_slot_counts(None, c_base)
    pl = TPL.rebalance(heat, N, num_redundant=8)
    _, c_reb, _ = torch_run(BACKENDS["ht"], pl, x, topk, w)
    assert c_reb.sum() == c_base.sum() == N * T * K
    assert c_reb.sum(1).max() < c_base.sum(1).max()
    np.testing.assert_array_equal(TPL.fold_slot_counts(pl, c_reb), heat)


def test_group_config_validation():
    cfg = EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K,
                        mode="ll", num_redundant_experts=8)
    with pytest.raises(ValueError, match="requires an explicit placement"):
        ep_create_group(cfg, ep_size=N)
    pl = TPL.redundant_placement(E, N, 8)
    with pytest.raises(ValueError, match="contradicts"):
        ep_create_group(dataclasses.replace(cfg, placement=pl, num_redundant_experts=4),
                        ep_size=N)
    g = ep_create_group(dataclasses.replace(cfg, placement=pl), ep_size=N)
    assert g.local_experts == 3 and g.physical_experts == E + 8
    assert g.placement_salt == pl.fingerprint() != 0
    assert g.ll_comb_cap == j_create_group(
        JCfg(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K, mode="ll",
             placement=JPL.redundant_placement(E, N, 8)), ep_size=N).ll_comb_cap
    with pytest.raises(ValueError, match="spans"):
        ep_create_group(dataclasses.replace(cfg, num_redundant_experts=0,
                                            placement=TPL.identity_placement(E, 4)),
                        ep_size=N)
    with pytest.raises(ValueError, match="fault_domains cover"):
        ep_create_group(dataclasses.replace(cfg, num_redundant_experts=0,
                                            fault_domains=TPL.trivial_domains(4)),
                        ep_size=N)
    hier = ep_create_group(EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H,
                                         top_k=K, mode="ht", ht_hierarchical=True,
                                         ep_axis=("pod", "data")), ep_size=8, inner_size=4)
    assert hier.fault_domains().domain_of == (0, 0, 0, 0, 1, 1, 1, 1)
    flat = ep_create_group(dataclasses.replace(cfg, num_redundant_experts=0), ep_size=N)
    assert flat.fault_domains().domain_of == tuple(range(8))


# --------------------------------------------------------------------------
# the refresh
# --------------------------------------------------------------------------

def _ll_cfg(placement=None):
    return EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K,
                         mode="ll", payload_dtype=torch.float32, placement=placement)


@pytest.mark.parametrize("num_redundant", [0, 8], ids=["same-slot-count",
                                                       "changed-slot-count"])
def test_refresh_placement_swap_rebuilds(num_redundant):
    """A refresh under a different placement rebuilds even when the routing
    replays bit for bit (the salted hash differs, or the map shapes do),
    and equals a fresh handle under the new placement."""
    x, topk, w = rand_inputs(12)
    heat = np.ones(E)
    heat[:4] = 50.0
    pl = TPL.rebalance(heat, N, num_redundant=num_redundant)
    g_old = ep_create_group(_ll_cfg(), LocalComm(N))
    g_new = ep_create_group(_ll_cfg(pl), LocalComm(N))
    tk = [torch.from_numpy(t) for t in topk]
    wt = [torch.from_numpy(v) for v in w]
    old = ep_create_handle(g_old, tk, wt)
    got = ep_handle_refresh(g_new, old, wt, [t.clone() for t in tk])
    fresh = ep_create_handle(g_new, tk, wt)
    for a, b, o in zip(got, fresh, old):
        assert not torch.equal(a.routing_hash, o.routing_hash)
        torch.testing.assert_close(a.routing_hash, b.routing_hash, rtol=0, atol=0)
        for f in MAPS:
            if getattr(b.plan, f) is not None:
                assert torch.equal(getattr(a.plan, f), getattr(b.plan, f)), f
    if num_redundant:
        with pytest.raises(ValueError, match="different physical slot layout"):
            ep_handle_refresh(g_new, old, wt)
    se = torch.from_numpy(slot_experts(pl)).float()
    recv = ep_dispatch(g_new, got, [torch.from_numpy(v) for v in x])
    out = ep_combine(g_new, got, [y * (1.0 + se[r])[:, None, None]
                                  for r, (y, _) in enumerate(recv)])
    np.testing.assert_allclose(np.stack([o.numpy() for o in out]), oracle(x, topk, w), **F32)


def test_refresh_same_placement_replay_keeps_fast_path():
    """Under an unchanged placement: a weights-only refresh reuses the plan
    objects, and a replayed routing takes the cached maps (equal to the
    original's; the hash is the original's) and equals JAX's salted hash."""
    x, topk, w = rand_inputs(13)
    pl = TPL.rebalance(np.arange(E, dtype=float) + 1.0, N, num_redundant=8)
    group = ep_create_group(_ll_cfg(pl), LocalComm(N))
    tk = [torch.from_numpy(t) for t in topk]
    wt = [torch.from_numpy(v) for v in w]
    h = ep_create_handle(group, tk, wt)
    h2 = ep_handle_refresh(group, h, wt)
    assert all(b.plan is a.plan for a, b in zip(h, h2))
    h3 = ep_handle_refresh(group, h, wt, [t.clone() for t in tk])
    for a, c in zip(h, h3):
        assert torch.equal(a.routing_hash, c.routing_hash)
        for f in MAPS:
            if getattr(a.plan, f) is not None:
                assert torch.equal(getattr(a.plan, f), getattr(c.plan, f)), f
    jpl = JPL.rebalance(np.arange(E, dtype=float) + 1.0, N, num_redundant=8)
    want = np.asarray(jplan.routing_hash(jnp.asarray(topk), jpl.fingerprint()))
    assert h[0].routing_hash.tolist() == want.astype(np.int64).tolist()


# --------------------------------------------------------------------------
# the weights
# --------------------------------------------------------------------------

def test_expand_collapse_round_trip():
    w = torch.from_numpy(np.random.RandomState(3).randn(E, 5).astype(np.float32))
    pl = TPL.redundant_placement(E, N, 8)
    phys = TPL.expand_expert_params(w, pl)
    assert phys.shape == (E + 8, 5)
    assert torch.equal(TPL.collapse_expert_params(phys, pl), w)
    se = TPL.tables(pl).slot_expert.reshape(-1)
    assert torch.equal(phys, w[torch.from_numpy(se).long()])


def test_adopt_expert_params_spec_driven_axes():
    """Leaves whose spec names an "expert" axis rebind along it (stacked
    leaves included); a chain of adoptions collapses back to the logical
    weights bitwise; a donated adoption at an unchanged slot count permutes
    the leaf in place, and one without donation leaves its input as it
    was."""
    rng = np.random.RandomState(5)
    logical = dict(stacked=torch.from_numpy(rng.randn(3, E, 4).astype(np.float32)),
                   flat=torch.from_numpy(rng.randn(E, 2).astype(np.float32)),
                   other=torch.from_numpy(rng.randn(7).astype(np.float32)))
    specs = dict(stacked=ParamSpec((3, E, 4), torch.float32, axes=("stack", "expert", None)),
                 flat=ParamSpec((E, 2), torch.float32, axes=("expert", None)),
                 other=ParamSpec((7,), torch.float32))
    pl_a = TPL.redundant_placement(E, N, 8)
    pl_b = TPL.rebalance(np.arange(E, dtype=float) + 1.0, N, num_redundant=8)
    keep = {k: v.clone() for k, v in logical.items()}
    phys_a = adopt_expert_params(logical, specs, None, pl_a, donate=False)
    assert all(torch.equal(logical[k], keep[k]) for k in keep)
    assert phys_a["stacked"].shape == (3, E + 8, 4) and phys_a["flat"].shape == (E + 8, 2)
    se_a = torch.from_numpy(TPL.tables(pl_a).slot_expert.reshape(-1)).long()
    assert torch.equal(phys_a["stacked"], keep["stacked"][:, se_a])
    assert phys_a["other"] is logical["other"]
    ptr = phys_a["stacked"].data_ptr()
    phys_b = adopt_expert_params(phys_a, specs, pl_a, pl_b)          # donated
    assert phys_b is phys_a and phys_b["stacked"].data_ptr() == ptr
    se_b = torch.from_numpy(TPL.tables(pl_b).slot_expert.reshape(-1)).long()
    assert torch.equal(phys_b["stacked"], keep["stacked"][:, se_b])
    back = adopt_expert_params(phys_b, specs, pl_b, None)
    for k in keep:
        assert torch.equal(back[k], keep[k]), k
    # the JAX package's rebind of the same tree, leaf by leaf
    from repro.checkpoint import rebind_expert_leaves as j_rebind
    want = j_rebind({"flat": jnp.asarray(keep["flat"].numpy())}, ("flat",),
                    dst_placement=JPL.redundant_placement(E, N, 8))
    got = rebind_expert_leaves({"flat": keep["flat"]}, ("flat",), dst_placement=pl_a)
    np.testing.assert_array_equal(got["flat"].numpy(), np.asarray(want["flat"]))


def _physical_cfg(cfg, pl):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, placement=pl, params_physical=True))


def test_init_params_and_params_from_jax_physical():
    """``init_params`` under params_physical draws the logical tree and
    adopts once (replicas identical, collapse = the logical draw);
    ``params_from_jax`` takes JAX's physical tree as it is."""
    from repro.checkpoint import adopt_expert_params as j_adopt
    from repro.configs.dbrx_132b import smoke_config as j_smoke
    from repro.models.transformer import lm_spec as j_lm_spec
    from repro.parallel.sharding import init_from_specs
    from repro_torch.configs.dbrx_132b import smoke_config
    from repro_torch.weights import init_params, params_from_jax
    cfg = dataclasses.replace(smoke_config(), dtype=torch.float32)
    pl = TPL.rebalance(np.arange(8, dtype=float) + 1, 4, num_redundant=4)
    logical = init_params(cfg, 3, "cpu")
    phys = init_params(_physical_cfg(cfg, pl), 3, "cpu")
    se = torch.from_numpy(TPL.tables(pl).slot_expert.reshape(-1)).long()
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(phys["moe_stack"]["moe"][k], logical["moe_stack"]["moe"][k][:, se])
    assert torch.equal(phys["embed"], logical["embed"])
    jcfg = dataclasses.replace(j_smoke(), dtype=jnp.float32)
    jpl = JPL.rebalance(np.arange(8, dtype=float) + 1, 4, num_redundant=4)
    jtree = init_from_specs(jax.random.PRNGKey(0), j_lm_spec(jcfg))
    jphys = jax.device_get(j_adopt(jtree, j_lm_spec(jcfg), None, jpl, donate=False))
    got = params_from_jax(jphys, _physical_cfg(cfg, pl), device="cpu")
    log_t = params_from_jax(jax.device_get(jtree), cfg, device="cpu")
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(got["moe_stack"]["moe"][k], log_t["moe_stack"]["moe"][k][:, se])
    with pytest.raises(ValueError, match="the spec wants"):
        params_from_jax(jax.device_get(jtree), _physical_cfg(cfg, pl), device="cpu")


# --------------------------------------------------------------------------
# the drivers
# --------------------------------------------------------------------------

def _router(rng):
    router_w = rng.randn(H, E).astype(np.float32)
    bump = np.zeros(E, np.float32)
    bump[:4] = 3.0
    return router_w, bump


def test_rebalancing_decode_adopt_once_matches_expansion_and_jax():
    """The decode driver with ``params`` (adopt-once: rows rebound once per
    placement) equals the per-step expansion of logical rows, and JAX's
    driver: the same outputs (f32) and the same placement sequence."""
    from repro.runtime.decode import rebalancing_decode_loop as j_loop
    from repro_torch.runtime.decode import rebalancing_decode_loop
    rng = np.random.RandomState(8)
    router_w, bump = _router(rng)
    w_log = (rng.rand(E).astype(np.float32) + 0.5)
    xs = [rng.randn(N, T, H).astype(np.float32) for _ in range(6)]

    def t_router(x):
        p = torch.softmax(x @ torch.from_numpy(router_w) + torch.from_numpy(bump), -1)
        w, idx = torch.topk(p, K)
        return idx.to(torch.int32), w / w.sum(-1, keepdim=True)

    def make(group, rows_of):
        L = group.local_experts

        def fn(window):
            outs, hs = [], 0.0
            for x in window:
                xt = [torch.from_numpy(v) for v in x]
                routed = [t_router(v) for v in xt]
                hs_ = ep_create_handle(group, [r[0] for r in routed], [r[1] for r in routed])
                recv = ep_dispatch(group, hs_, xt)
                rows = rows_of(fn.wv)
                out = ep_combine(group, hs_, [y * rows[r * L:(r + 1) * L][:, None, None]
                                              for r, (y, _) in zip(group.comm.ranks, recv)])
                outs.append(np.stack([o.numpy() for o in out]))
                hs = hs + TPL.heat_from_topk(torch.stack([r[0] for r in routed]), E).numpy()
            return outs, hs
        return fn

    def make_expand(group):
        pl = group.placement
        fn = make(group, lambda wv: TPL.expand_expert_params(wv, pl) if pl is not None else wv)
        fn.wv = torch.from_numpy(w_log)
        return fn

    def make_adopt(group, params):
        fn = make(group, lambda wv: wv)
        fn.wv = params["w_gate"]
        return fn

    base = EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K,
                         mode="ll", payload_dtype=torch.float32)
    outs_a, pls_a = rebalancing_decode_loop(base, make_expand, xs, rebalance_every=2,
                                            ep_size=N, comm=LocalComm(N), num_redundant=8)
    outs_b, pls_b = rebalancing_decode_loop(
        base, make_adopt, xs, rebalance_every=2, ep_size=N, comm=LocalComm(N),
        num_redundant=8, params={"w_gate": torch.from_numpy(w_log)}, expert_keys=("w_gate",))
    assert [p.fingerprint() if p else 0 for p in pls_a] == \
           [p.fingerprint() if p else 0 for p in pls_b]
    assert any(p is not None for p in pls_b)
    for a, b in zip(outs_a, outs_b):
        np.testing.assert_array_equal(a, b)

    # JAX's driver on the same inputs
    mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    j_router_w, j_bump = jnp.asarray(router_w), jnp.asarray(bump)

    def j_router(x):
        w, idx = jax.lax.top_k(jax.nn.softmax(x @ j_router_w + j_bump, -1), K)
        return idx.astype(jnp.int32), w / w.sum(-1, keepdims=True)

    def j_make(group):
        pl = group.placement
        rows = (JPL.expand_expert_params(jnp.asarray(w_log), pl) if pl is not None
                else jnp.asarray(w_log))
        L = group.local_experts

        def run(x):
            ti, wi = j_router(x[0])
            h = j_create_handle(group, ti, wi)
            y3d, _ = j_dispatch(group, h, x[0])
            me = jplan.my_rank(group)
            r = jax.lax.dynamic_slice_in_dim(rows, me * L, L)
            out = j_combine(group, h, y3d * r[:, None, None])
            return out[None], jax.lax.psum(JPL.heat_from_topk(ti, E), "data")[None]
        f = jax.jit(jax.shard_map(run, mesh=mesh, in_specs=(P("data"),),
                                  out_specs=(P("data"), P("data"))))

        def fn(window):
            outs, hs = [], 0.0
            for x in window:
                o, hh = f(jnp.asarray(x))
                outs.append(np.asarray(o))
                hs = hs + np.asarray(hh)[0]
            return outs, hs
        return fn

    j_outs, j_pls = j_loop(JCfg(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K,
                                mode="ll", payload_dtype=jnp.float32),
                           j_make, xs, rebalance_every=2, ep_size=N, num_redundant=8)
    assert [(p.slot_expert, p.version, p.fingerprint()) if p else None for p in pls_b] == \
           [(p.slot_expert, p.version, p.fingerprint()) if p else None for p in j_pls]
    for a, b in zip(outs_b, j_outs):
        np.testing.assert_allclose(a, b, **F32)


def test_rebalancing_prefill_matches_sequential():
    from repro_torch.runtime.prefill import (prefill_moe, rebalancing_prefill,
                                             sequential_prefill)
    rng = np.random.RandomState(6)
    router_w, bump = _router(rng)

    def router_fn(x):
        p = torch.softmax(x @ torch.from_numpy(router_w) + torch.from_numpy(bump), -1)
        w, idx = torch.topk(p, K)
        return idx.to(torch.int32), w / w.sum(-1, keepdim=True)

    def expert_fn_for(placement):
        se = torch.from_numpy(slot_experts(placement)).float()

        def expert_fn(rank, y3d, counts):
            return y3d * (1.0 + se[rank])[:, None, None]
        return expert_fn

    base = EpGroupConfig(num_experts=E, max_tokens_per_rank=T // 2, hidden=H, top_k=K,
                         mode="ht", payload_dtype=torch.float32)
    batches = [[torch.from_numpy(v) for v in rng.randn(N, T, H).astype(np.float32)]
               for _ in range(3)]

    def make_layer(group):
        efn = expert_fn_for(group.placement)

        def layer(xs):
            out = prefill_moe(group, router_fn, efn, xs, 2)
            heat = TPL.heat_from_topk(torch.stack([router_fn(x)[0] for x in xs]), E)
            return [o.numpy() for o in out], heat
        return layer

    outs, pls = rebalancing_prefill(base, make_layer, batches, rebalance_every=1,
                                    ep_size=N, comm=LocalComm(N), num_redundant=8)
    assert pls[0] is None and pls[1] is not None and pls[1].num_redundant == 8
    for i, xs in enumerate(batches):
        group = ep_create_group(dataclasses.replace(base, placement=pls[i]), LocalComm(N))
        want = sequential_prefill(group, router_fn, expert_fn_for(pls[i]), xs, 2)
        for a, b in zip(outs[i], want):
            np.testing.assert_array_equal(a, b.numpy())


# --------------------------------------------------------------------------
# refusals that stay: ROADMAP A10b
# --------------------------------------------------------------------------

def test_refusals_name_a10b():
    from repro_torch.configs.dbrx_132b import smoke_config
    from repro_torch.models.moe import _expert_weights
    from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
    cfg = smoke_config()
    for kw in (dict(fault_injector=object()), dict(fault_detector=object()),
               dict(ckpt_dir="x"), dict(miss_threshold=2)):
        for cls in (DecodeServer, ContinuousDecodeServer):
            with pytest.raises(NotImplementedError, match="ROADMAP A10b"):
                cls(cfg, 8, 8, device="cpu", **kw)
    base = EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K)
    with pytest.raises(NotImplementedError, match="ROADMAP A10b"):
        TPL.run_rebalancing(base, None, [1], advance_every=1, ep_size=N,
                            fault_injector=object())

    class OneRank:       # a process of a four-rank mesh, as DistComm is
        ranks, size = (1,), 4
    pl = TPL.redundant_placement(8, 4, 4)
    m = dataclasses.replace(cfg.moe, placement=pl)
    w = torch.zeros(8, 2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A10b"):
        _expert_weights(dict(w_gate=w, w_up=w, w_down=w), m, OneRank(), 3)
