"""The port's placement engine (``repro_torch/core/placement.py``) against
the JAX package's (``repro/core/placement.py``): on the same heat arrays,
made from numpy seeds, every function must give exactly the same result,
and every raised error the same type and message; a warning the same
category name and message. Placements are compared by table, version and
fingerprint. The cases mirror ``tests/test_placement.py`` and the placement
cases of ``tests/test_fault_domains.py``.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import placement as JPL
from repro_torch.core import placement as TPL

N, E = 8, 16


def norm(x):
    """A result in a form both packages' outputs compare in."""
    if isinstance(x, (JPL.EpPlacement, TPL.EpPlacement)):
        return ("placement", x.num_experts, x.slot_expert, x.version, x.fingerprint())
    if isinstance(x, (JPL.FaultDomains, TPL.FaultDomains)):
        return ("domains", x.domain_of)
    if isinstance(x, (JPL.PlacementTables, TPL.PlacementTables)):
        return ("tables",) + tuple(norm(a) for a in x)
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if hasattr(x, "__array__") and not isinstance(x, (list, tuple)):
        a = np.asarray(x)
        return ("array", str(a.dtype) if a.dtype.kind != "i" else "int", a.shape, a.tolist())
    if isinstance(x, (list, tuple)):
        return type(x).__name__, tuple(norm(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, norm(v)) for k, v in x.items()))
    return x


def outcome(fn):
    """(result or error, warnings) of fn(), comparable across packages."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            res = ("ok", norm(fn()))
        except Exception as e:      # noqa: BLE001 - the type is compared
            res = ("err", type(e).__name__, str(e))
    return res, [(type(w.message).__name__, str(w.message)) for w in rec]


def same(name, *args, **kw):
    """PL.<name>(*args, **kw) of both packages: equal outcomes."""
    got = outcome(lambda: getattr(TPL, name)(*args, **kw))
    want = outcome(lambda: getattr(JPL, name)(*args, **kw))
    assert got == want, (name, got, want)
    return got


def heat_of(kind: str, seed: int = 0, e: int = E):
    rng = np.random.default_rng(seed)
    h = np.ones(e)
    if kind == "hot":
        h[0] = 40.0
    elif kind == "neighborhood":
        h[0] = h[1] = 20.0
    elif kind == "random":
        h = rng.random(e) * 10.0 ** rng.integers(0, 3, e)
    elif kind == "skewed":
        h = np.arange(e, dtype=float) + 1.0
    return h


GEO = JPL.domains_from_geometry(8, 4).domain_of
REBALANCE = {
    "uniform R0": ("uniform", N, {}),
    "neighborhood R0": ("neighborhood", N, {}),
    "hot R8": ("hot", N, dict(num_redundant=8)),
    "skewed R16 v3": ("skewed", N, dict(num_redundant=16, version=3)),
    "random R8": ("random", N, dict(num_redundant=8)),
    "floor 2 pods": ("random", N, dict(num_redundant=16, min_replicas=2, domains=GEO)),
    "floor 2 flat": ("hot", N, dict(num_redundant=16, min_replicas=2)),
    "floor 2 headroom 6": ("uniform", N, dict(num_redundant=16, min_replicas=2,
                                              domains=GEO, max_slots_per_rank=6)),
    "floor 2 headroom 8": ("uniform", N, dict(num_redundant=16, min_replicas=2,
                                              domains=GEO, max_slots_per_rank=8)),
    "floor too few redundant": ("uniform", N, dict(num_redundant=4, min_replicas=2,
                                                   domains=GEO)),
    "floor one alive": ("uniform", N, dict(num_redundant=8, min_replicas=2,
                                           alive_ranks=(0,))),
    "alive subset": ("hot", N, dict(num_redundant=8, alive_ranks=(0, 1, 2, 3, 5, 6))),
    "indivisible": ("uniform", N, dict(num_redundant=3)),
    "negative R": ("uniform", N, dict(num_redundant=-1)),
    "bad alive": ("uniform", N, dict(alive_ranks=(9,))),
    "uneven pods": ("random", N, dict(num_redundant=16, min_replicas=3,
                                      domains=(0, 0, 0, 0, 1, 1, 2, 2))),
}


@pytest.mark.parametrize("case", sorted(REBALANCE), ids=sorted(REBALANCE))
def test_rebalance_equals_jax(case):
    kind, n, kw = REBALANCE[case]
    kw = dict(kw)
    dom = kw.pop("domains", None)
    h = heat_of(kind, 1)
    got = outcome(lambda: TPL.rebalance(h, n, domains=None if dom is None
                                        else TPL.FaultDomains(dom), **kw))
    want = outcome(lambda: JPL.rebalance(h, n, domains=None if dom is None
                                         else JPL.FaultDomains(dom), **kw))
    assert got == want


def test_rebalance_pigeonhole_and_cohost_equal_jax():
    """S > E: a loud co-hosting warning without the floor, an error under
    it, in both packages."""
    (res, warns) = same("rebalance", np.ones(2), 2, num_redundant=4)
    assert res[0] == "ok" and warns and warns[0][0] == "DegradedRecovery"
    (res, _) = same("rebalance", np.ones(2), 2, num_redundant=4, min_replicas=2)
    assert res[0] == "err" and "exceed the 2 experts" in res[2]


@pytest.mark.parametrize("seed", range(4))
def test_rebalance_random_floor_equals_jax(seed):
    rng = np.random.RandomState(seed)
    h = rng.rand(16) * (10.0 ** rng.randint(0, 3, 16))
    for r, m in ((0, 1), (8, 1), (16, 2)):
        tpl = TPL.rebalance(h, 8, num_redundant=r, min_replicas=m,
                            domains=TPL.FaultDomains(GEO) if m > 1 else None)
        jpl = JPL.rebalance(h, 8, num_redundant=r, min_replicas=m,
                            domains=JPL.FaultDomains(GEO) if m > 1 else None)
        assert norm(tpl) == norm(jpl)


@pytest.mark.parametrize("args", [(E, N, 0), (E, N, 8), (16, 4, 4), (8, 8, 8), (E, N, 3)],
                         ids=str)
def test_redundant_placement_equals_jax(args):
    same("redundant_placement", *args)


def test_placement_validation_and_jsonable_equal_jax():
    for tbl in (((0, 1), (2, 0)), ((0, 1), (2, 4)), ((0, 1, 2), (3,)), ((0, 1), (2, 3)),
                ((0, -1), (1, 2)), ()):
        got = outcome(lambda: TPL.EpPlacement(4 if 3 in sum(tbl, ()) else 3, tbl))
        want = outcome(lambda: JPL.EpPlacement(4 if 3 in sum(tbl, ()) else 3, tbl))
        assert got == want, tbl
    pl = TPL.rebalance(heat_of("hot"), N, num_redundant=8)
    d = TPL.placement_to_jsonable(pl)
    assert d == JPL.placement_to_jsonable(JPL.placement_from_jsonable(d))
    assert TPL.placement_from_jsonable(d) == pl
    red = TPL.EpPlacement(3, ((0, 1), (2, 0)))
    assert red.num_redundant == 1 and not red.is_identity()
    assert TPL.identity_placement(E, N).is_identity()
    same("identity_placement", E, 3)


def test_fingerprint_and_tables_equal_jax():
    for pl_t, pl_j in ((TPL.identity_placement(E, N), JPL.identity_placement(E, N)),
                       (TPL.redundant_placement(E, N, 8, version=2),
                        JPL.redundant_placement(E, N, 8, version=2)),
                       (TPL.EpPlacement(3, ((0, 1), (2, 0))),
                        JPL.EpPlacement(3, ((0, 1), (2, 0))))):
        assert pl_t.fingerprint() == pl_j.fingerprint() != 0
        assert norm(TPL.tables(pl_t)) == norm(JPL.tables(pl_j))
        assert (pl_t.dead_ranks(), pl_t.alive_ranks(), pl_t.num_empty) == \
               (pl_j.dead_ranks(), pl_j.alive_ranks(), pl_j.num_empty)
    a = TPL.identity_placement(E, N)
    fps = {a.fingerprint(), dataclasses.replace(a, version=1).fingerprint(),
           TPL.rebalance(np.arange(E, dtype=float), N).fingerprint()}
    assert len(fps) == 3


@pytest.mark.parametrize("kind", ["identity", "redundant", "degraded"])
def test_assign_equals_jax(kind):
    rng = np.random.default_rng(5)
    if kind == "identity":
        pls = (TPL.identity_placement(E, N), JPL.identity_placement(E, N))
    elif kind == "redundant":
        pls = (TPL.rebalance(heat_of("hot"), N, num_redundant=8),
               JPL.rebalance(heat_of("hot"), N, num_redundant=8))
    else:
        pls = (TPL.shrink_placement(heat_of("random"), N, (2, 5), num_redundant=8),
               JPL.shrink_placement(heat_of("random"), N, (2, 5), num_redundant=8))
    experts = rng.integers(0, E + 1, (N, 6, 3)).astype(np.int32)   # E = sentinel
    src = np.arange(N, dtype=np.int32)[:, None, None]
    r_t, s_t = TPL.assign(pls[0], torch.from_numpy(experts), torch.from_numpy(src))
    r_j, s_j = JPL.assign(pls[1], jnp.asarray(experts), jnp.asarray(src))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    r_t, s_t = TPL.assign(pls[0], torch.from_numpy(experts), 3)      # an int source
    r_j, s_j = JPL.assign(pls[1], jnp.asarray(experts), 3)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_heat_fold_tracker_loads_equal_jax():
    rng = np.random.default_rng(7)
    topk = rng.integers(0, E + 1, (5, 4, 3)).astype(np.int32)
    got = TPL.heat_from_topk(torch.from_numpy(topk), E)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JPL.heat_from_topk(jnp.asarray(topk), E)))
    pl = (TPL.EpPlacement(3, ((0, 1), (2, 0))), JPL.EpPlacement(3, ((0, 1), (2, 0))))
    c = [[5, 1], [2, 3]]
    np.testing.assert_array_equal(TPL.fold_slot_counts(pl[0], c), JPL.fold_slot_counts(pl[1], c))
    np.testing.assert_array_equal(TPL.fold_slot_counts(None, c), JPL.fold_slot_counts(None, c))
    deg = (TPL.shrink_placement(heat_of("hot"), N, (1,)),
           JPL.shrink_placement(heat_of("hot"), N, (1,)))
    counts = rng.integers(0, 9, (N, deg[0].slots_per_rank))
    np.testing.assert_array_equal(TPL.fold_slot_counts(deg[0], counts),
                                  JPL.fold_slot_counts(deg[1], counts))
    for decay in (0.0, 0.5, 0.9):
        tt, tj = TPL.HeatTracker(E, decay=decay), JPL.HeatTracker(E, decay=decay)
        for _ in range(4):
            h = rng.random(E) * 100
            np.testing.assert_array_equal(tt.update(torch.from_numpy(h)), tj.update(h))
        assert tt.totals.dtype == np.float64
    for bad in (1.0, -0.1):
        assert outcome(lambda: TPL.HeatTracker(E, decay=bad)) == \
               outcome(lambda: JPL.HeatTracker(E, decay=bad))
    assert outcome(lambda: TPL.HeatTracker(4).update(np.zeros(5))) == \
           outcome(lambda: JPL.HeatTracker(4).update(np.zeros(5)))
    h = heat_of("random", 3)
    for p_t, p_j in ((None, None), (TPL.redundant_placement(E, N, 8),
                                    JPL.redundant_placement(E, N, 8)), deg):
        lt, lj = TPL.rank_loads(h, p_t, N), JPL.rank_loads(h, p_j, N)
        np.testing.assert_array_equal(lt, lj)
        assert TPL.imbalance(lt) == JPL.imbalance(lj)
    assert TPL.imbalance(np.zeros(4)) == JPL.imbalance(np.zeros(4)) == 1.0


def test_domains_equal_jax():
    for ep, ni in [(8, 4), (8, 2), (12, 3), (16, 8), (8, 3), (8, 0)]:
        same("domains_from_geometry", ep, ni)
    for n in (4, 1, 0):
        same("trivial_domains", n)
    for dom in ((), (0, -1), (0, 0, 1, 1, 2, 2, 3, 3)):
        assert outcome(lambda: TPL.FaultDomains(dom)) == outcome(lambda: JPL.FaultDomains(dom))
    d_t, d_j = TPL.FaultDomains((0, 0, 1, 1, 2)), JPL.FaultDomains((0, 0, 1, 1, 2))
    assert (d_t.num_domains, d_t.domains(), d_t.ranks_in(1), d_t.live_domains((0, 4)),
            d_t.describe()) == (d_j.num_domains, d_j.domains(), d_j.ranks_in(1),
                                d_j.live_domains((0, 4)), d_j.describe())


@pytest.mark.parametrize("args", [(8, 8, 7, 1), (8, 8, 7, 2), (8, 8, 8, 2), (16, 16, 4, 2),
                                  (16, 0, 6, 1), (8, 0, 7, 1)], ids=str)
def test_fit_redundant_equals_jax(args):
    e, r, n, m = args
    same("fit_redundant", e, r, n, min_replicas=m)


def test_required_domain_span_equals_jax():
    uneven = ((0, 0, 0, 0, 1, 1, 2, 2), {0: 12, 1: 6, 2: 6})
    for dom, caps, m in ((uneven[0], uneven[1], 3), (uneven[0], {0: 8, 1: 8, 2: 8}, 2),
                         (None, None, 2), (GEO, None, 4)):
        got = outcome(lambda: TPL.required_domain_span(
            8, m, tuple(range(8)), dom and TPL.FaultDomains(dom), caps, warn=True))
        want = outcome(lambda: JPL.required_domain_span(
            8, m, tuple(range(8)), dom and JPL.FaultDomains(dom), caps, warn=True))
        assert got == want


def test_floor_checks_equal_jax():
    h = heat_of("random", 2)
    pls = (TPL.rebalance(h, N, num_redundant=16, min_replicas=2,
                         domains=TPL.FaultDomains(GEO)),
           JPL.rebalance(h, N, num_redundant=16, min_replicas=2,
                         domains=JPL.FaultDomains(GEO)))
    weak = (TPL.redundant_placement(E, N, 8), JPL.redundant_placement(E, N, 8))
    for (pt, pj), m, dom in ((pls, 2, GEO), (weak, 2, None), (weak, 2, GEO), (pls, 3, None),
                             (weak, 1, None), (pls, 2, (0, 0, 0, 0))):
        got = outcome(lambda: TPL.validate_floor(pt, m, dom and TPL.FaultDomains(dom)))
        want = outcome(lambda: JPL.validate_floor(pj, m, dom and JPL.FaultDomains(dom)))
        assert got == want
    for kw in (dict(domains=GEO, min_replicas=2, placement=0),
               dict(domains=GEO, min_replicas=2, placement=1),
               dict(domains=GEO, min_replicas=2, max_slots_per_rank=6),
               dict(min_replicas=1), dict(min_replicas=2, placement=1),
               dict(domains=(0, 0, 0, 0), min_replicas=2)):
        for fn in ("shrink_feasibility", "assert_shrink_feasible"):
            def call(PL, pl_pair_i):
                k = dict(kw)
                if "domains" in k:
                    k["domains"] = PL.FaultDomains(k["domains"])
                if "placement" in k:
                    k["placement"] = (pls if k["placement"] == 0 else weak)[pl_pair_i]
                n = len(kw["domains"]) if "domains" in kw else N
                return getattr(PL, fn)(E if n == N else 16, 16, n, **k)
            assert outcome(lambda: call(TPL, 0)) == outcome(lambda: call(JPL, 1)), (fn, kw)


def test_elastic_tables_equal_jax():
    """lost_experts, mask_placement, shrink_placement, expand_placement:
    the pure functions A10b's recovery will call."""
    h = heat_of("random", 4)
    red = (TPL.rebalance(h, N, num_redundant=8), JPL.rebalance(h, N, num_redundant=8))
    ident = (TPL.identity_placement(E, N), JPL.identity_placement(E, N))
    for (pt, pj), alive in ((red, (0, 1, 2, 3)), (red, tuple(range(1, 8))),
                            (ident, tuple(range(1, 8))), (ident, tuple(range(8)))):
        assert TPL.lost_experts(pt, alive) == JPL.lost_experts(pj, alive)
        assert outcome(lambda: TPL.mask_placement(pt, alive)) == \
               outcome(lambda: JPL.mask_placement(pj, alive))
    assert TPL.lost_experts(None, (0,)) == JPL.lost_experts(None, (0,)) == ()
    for dead, kw in (((2,), {}), ((2, 5), dict(num_redundant=8)),
                     ((4, 5, 6, 7), dict(num_redundant=16, min_replicas=2,
                                         domains=GEO, max_slots_per_rank=8)),
                     (tuple(range(8)), {})):
        def sh(PL):
            k = dict(kw)
            if "domains" in k:
                k["domains"] = PL.FaultDomains(k["domains"])
            return PL.shrink_placement(h, N, dead, version=2, **k)
        assert outcome(lambda: sh(TPL)) == outcome(lambda: sh(JPL))
    for kw in ({}, dict(num_redundant=5), dict(num_redundant=16, min_replicas=2, domains=GEO)):
        def ex(PL):
            k = dict(kw)
            if "domains" in k:
                k["domains"] = PL.FaultDomains(k["domains"])
            return PL.expand_placement(h, N, version=4, **k)
        assert outcome(lambda: ex(TPL)) == outcome(lambda: ex(JPL))


def test_rebalance_scheduler_equals_jax():
    """The dedup: an unchanged table returns the same object (version and
    fingerprint kept), a changed one a new object with the version bumped;
    the same sequence in both packages, degraded tables included."""
    rng = np.random.default_rng(9)
    st = TPL.RebalanceScheduler(E, N, num_redundant=8, decay=0.5)
    sj = JPL.RebalanceScheduler(E, N, num_redundant=8, decay=0.5)
    hot = heat_of("hot")
    seq = [hot, hot, hot, rng.random(E) * 500, hot * 100, hot * 100]
    prev_t = prev_j = None
    for i, h in enumerate(seq):
        st.observe(torch.from_numpy(h) if i % 2 else h)
        sj.observe(h)
        if i == 4:
            st.set_alive(range(1, 8))
            sj.set_alive(range(1, 8))
        pt, pj = st.advance(), sj.advance()
        assert norm(pt) == norm(pj), i
        assert (pt is prev_t) == (pj is prev_j), i
        prev_t, prev_j = pt, pj
    for bad in ((), (9,)):
        assert outcome(lambda: st.set_alive(bad)) == outcome(lambda: sj.set_alive(bad))
    for kw in (dict(min_replicas=0), dict(domains=(0, 1))):
        def mk(PL):
            k = dict(kw)
            if "domains" in k:
                k["domains"] = PL.FaultDomains(k["domains"])
            return PL.RebalanceScheduler(E, N, **k)
        assert outcome(lambda: mk(TPL)) == outcome(lambda: mk(JPL))


def test_expand_collapse_equal_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(2, E, 5).astype(np.float32)
    for pl_t, pl_j in ((TPL.redundant_placement(E, N, 8), JPL.redundant_placement(E, N, 8)),
                       (TPL.shrink_placement(heat_of("hot"), N, (3,)),
                        JPL.shrink_placement(heat_of("hot"), N, (3,)))):
        phys_t = TPL.expand_expert_params(torch.from_numpy(w), pl_t, axis=1)
        phys_j = JPL.expand_expert_params(jnp.asarray(w), pl_j, axis=1)
        np.testing.assert_array_equal(phys_t.numpy(), np.asarray(phys_j))
        np.testing.assert_array_equal(TPL.expand_expert_params(w, pl_t, axis=1),
                                      np.asarray(phys_j))
        back = TPL.collapse_expert_params(phys_t, pl_t, axis=1)
        np.testing.assert_array_equal(back.numpy(), w)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(JPL.collapse_expert_params(phys_j, pl_j, axis=1)))
