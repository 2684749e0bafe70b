"""The port's hierarchical, chunked HT path against the JAX package.

JAX runs its 8 EP ranks as fake CPU devices on a ("pod", "data") mesh of
2 x 4 under shard_map; the port hosts them in one process with
``LocalComm(8, axes=(("pod", 2), ("data", 4)))``. Every hierarchical plan
map of every rank, the dispatch tensor, its counts and the fp8 stage-2
scales must match bit for bit, for 1, 2 and 4 chunks, in f32 and with fp8
dispatch, with and without capacity drops; the combined output within 1e-5
(f32). Then the port's own contracts, as the JAX package's tests state them
(``tests/test_ep_ht.py``, ``tests/test_ht_chunked.py``,
``tests/test_moe_block.py``): the round trip against the dense oracle,
hierarchical equal to flat, chunked bitwise equal to monolithic at zero
drop, the staged and the pipelined prefill surfaces; and the hierarchical
MoE layer and a small ``lm_forward`` against JAX's within 1e-5 in f32.
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
from repro.models import get_model as jax_get_model
from repro.models.moe import moe_block as jax_moe_block
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.core import (EpGroupConfig, ep_combine, ep_complete, ep_create_group,
                              ep_create_handle, ep_dispatch, ep_handle_refresh)
from repro_torch.core import plan as PM
from repro_torch.kernels import ref
from repro_torch.models import get_model
from repro_torch.models.moe import _moe_dense_fallback, _resolve_chunks, moe_block
from repro_torch.runtime.prefill import prefill_moe, sequential_prefill
from repro_torch.weights import params_from_jax

No, Ni, E, K, T, H = 2, 4, 16, 4, 16, 32
N = No * Ni
F32 = dict(rtol=1e-5, atol=1e-5)
ORACLE = dict(rtol=2e-4, atol=2e-4)      # the reference's round-trip tolerance
HMAPS = ("h_gmap1", "h_gmap2", "h_slot_tgt", "h_rail_dst_rows", "h_rail_src_rows",
         "h_src_rows", "h_entry_slot", "disp_recv_gmap", "disp_counts")


def comm(no=No, ni=Ni, names=("pod", "data")):
    return LocalComm(no * ni, axes=((names[0], no), (names[1], ni)))


def inputs(seed, n=N, t=T, k=K, e=E, h=H, skew=False):
    """x [n, t, h], distinct top-k experts [n, t, k] and softmax weights,
    from a numpy seed. ``skew`` favours experts 0 and 1 so capacities
    overflow."""
    rng = np.random.default_rng(seed)
    p = np.ones(e)
    if skew:
        p[:2] = 12.0
    p /= p.sum()
    x = rng.standard_normal((n, t, h)).astype(np.float32)
    topk = np.stack([np.stack([rng.choice(e, k, replace=False, p=p) for _ in range(t)])
                     for _ in range(n)]).astype(np.int32)
    logits = rng.standard_normal((n, t, k)).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return x, topk, w.astype(np.float32)


def oracle(x, topk, w):
    return x * (w * (1.0 + topk)).sum(-1)[..., None]


def base_kw(nc=1, fp8=False, t=T, e=E, k=K, h=H, **kw):
    return dict(num_experts=e, max_tokens_per_rank=t, hidden=h, top_k=k, mode="ht",
                ep_axis=("pod", "data"), ht_hierarchical=True, ht_num_chunks=nc,
                quantize_dispatch=fp8, quant_block=h, **kw)


def tcfg(**kw):
    return EpGroupConfig(payload_dtype=torch.float32, **base_kw(**kw))


def torch_roundtrip(cfg, x, topk, w, c=None, staged=True):
    """Dispatch -> expert e scales its rows by 1+e -> combine over the
    port's group. Returns (group, handles, pendings, [(y3d, counts)], outs)."""
    group = ep_create_group(cfg, c or comm())
    hs = ep_create_handle(group, [torch.from_numpy(a) for a in topk],
                          [torch.from_numpy(a) for a in w])
    xs = [torch.from_numpy(a) for a in x]
    pend = ep_dispatch(group, hs, xs, send_only=True)
    recv = ep_complete(group, hs, pend) if staged else ep_dispatch(group, hs, xs)
    L = group.local_experts
    ys = [y * (1.0 + torch.arange(r * L, (r + 1) * L)).to(y.dtype)[:, None, None]
          for r, (y, _) in zip(group.comm.ranks, recv)]
    outs = (ep_complete(group, hs, ep_combine(group, hs, ys, send_only=True)) if staged
            else ep_combine(group, hs, ys))
    return group, hs, pend, recv, outs


def jax_roundtrip(jcfg, x, topk, w):
    """The JAX production path on the 2 x 4 mesh: per-rank plan maps, the
    stage-2 scales of an fp8 dispatch, the dispatch tensor, its counts and
    the round trip, stacked [N, ...] as numpy."""
    group = j_create_group(jcfg, ep_size=N, inner_size=Ni)
    mesh = jax.make_mesh((No, Ni), ("pod", "data"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    spec = P(("pod", "data"))

    def step(tk, wt, xs):
        h = jht.ht_create_handle(group, tk[0], wt[0])
        out = {f: getattr(h.plan, f)[None] for f in HMAPS + ("h_w_slot",)}
        pend = jht.ht_dispatch(group, h, xs[0], send_only=True)
        if pend.recv_scales is not None:
            out["recv_scales"] = pend.recv_scales[None]
        y3d, counts = jht.ht_dispatch_complete(group, h, pend)
        out["y3d"], out["counts"] = y3d[None], counts[None]
        L = group.local_experts
        me = jax.lax.axis_index("pod") * Ni + jax.lax.axis_index("data")
        e = me * L + jnp.arange(L)
        out["out"] = jht.ht_combine(group, h, y3d * (1.0 + e)[:, None, None]
                                    .astype(y3d.dtype))[None]
        return out

    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
    res = fn(jnp.asarray(topk), jnp.asarray(w), jnp.asarray(x))
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
            for k, v in res.items()}


def as_division(scales, x, block):
    """JAX's fp8 scales with each block's ``amax * (1/448)`` replaced by
    ``amax / 448``. Under jit XLA turns JAX's ``amax / 448.0`` into a
    multiply by the reciprocal, which rounds the last bit of about half the
    scales otherwise; the port (and its kernel) divides. Every scale JAX
    moved must be the reciprocal form of a block of x (or 0 for an empty
    slot, 1 for an all-zero block), so the replacement checks where each
    scale came from as well."""
    g = np.abs(x.reshape(-1, x.shape[-1] // block, block)).max(-1).reshape(-1)
    rec = g * np.float32(1 / 448)
    div = g / np.float32(448)
    table = dict(zip(rec.tolist(), div.tolist()))
    assert all(table[r] == d for r, d in zip(rec.tolist(), div.tolist())), "ambiguous"
    table.update({0.0: 0.0, 1.0: 1.0})
    out = np.vectorize(lambda v: table[float(v)], otypes=[np.float32])(scales)
    return out.astype(np.float32)


# name -> (chunks, fp8, capacity options, skewed routing); the drops case
# runs 64 tokens a rank so its halved stage capacities fall below the
# zero-drop bounds (they never go under the slot alignment of 8)
CASES = {"nc1-f32": (1, False, {}, False), "nc2-f32": (2, False, {}, False),
         "nc4-f32": (4, False, {}, False), "nc1-fp8": (1, True, {}, False),
         "nc2-fp8": (2, True, {}, False), "nc4-fp8": (4, True, {}, False),
         "nc2-drops": (2, False, dict(t=64, capacity_factor=0.5,
                                      expert_capacity_factor=0.5), True)}


@pytest.mark.parametrize("case", list(CASES))
def test_hier_matches_jax(case):
    """Plan maps, dispatch tensor, counts and fp8 stage-2 scales bitwise;
    combined output within 1e-5 of JAX's and, at zero drop in f32, within
    the reference's 2e-4 of the oracle."""
    nc, fp8, caps, skew = CASES[case]
    h = 128 if fp8 else H
    t = caps.get("t", T)
    x, topk, w = inputs(30 + nc, t=t, h=h, skew=skew)
    kw = base_kw(nc=nc, fp8=fp8, h=h, **caps)
    want = jax_roundtrip(JCfg(payload_dtype=jnp.float32, **kw), x, topk, w)
    group, hs, pend, recv, outs = torch_roundtrip(
        EpGroupConfig(payload_dtype=torch.float32, **kw), x, topk, w)
    assert group.hierarchical
    for name in HMAPS:
        got = np.stack([getattr(hd.plan, name).numpy() for hd in hs])
        assert got.dtype == want[name].dtype == np.int32, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    np.testing.assert_array_equal(np.stack([hd.plan.h_w_slot.numpy() for hd in hs]),
                                  want["h_w_slot"])
    np.testing.assert_array_equal(np.stack([y.float().numpy() for y, _ in recv]), want["y3d"])
    np.testing.assert_array_equal(np.stack([c.numpy() for _, c in recv]), want["counts"])
    if fp8:
        assert pend[0].recv.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(np.stack([p.recv_scales.numpy() for p in pend]),
                                      as_division(want["recv_scales"], x, h))
    got = np.stack([o.float().numpy() for o in outs])
    np.testing.assert_allclose(got, want["out"], **F32)
    if not fp8 and not skew:
        np.testing.assert_allclose(got, oracle(x, topk, w), **ORACLE)
    if skew:
        A = group.ht_expert_cap
        kept = sum(int(hd.plan.disp_counts.clamp(max=A).sum()) for hd in hs)
        assert kept < N * t * K


def test_inverse_maps_are_the_scatters():
    """The port's fixed-order gather maps hold exactly the contributors of
    JAX's scatter-adds: each stage-2 row's y3d slots in ascending order,
    each rail row's stage-2 row per pod."""
    x, topk, w = inputs(40)
    _, hs, *_ = torch_roundtrip(tcfg(nc=2), x, topk, w)
    for hd in hs:
        pl = hd.plan
        M2, LA = pl.h_slot_rows.shape[0], pl.h_slot_tgt.shape[0]
        for r in range(M2):
            want = [s for s in range(LA) if int(pl.h_slot_tgt[s]) == r]
            got = [int(s) for s in pl.h_slot_rows[r] if s < LA]
            assert got == want
        nc, R1, no = pl.h_rail_rows.shape
        sentinel = no * pl.h_gmap2.shape[-1]
        for c in range(nc):
            for o in range(no):
                pairs = {int(d): int(s) for d, s in zip(pl.h_rail_dst_rows[c, o],
                                                        pl.h_rail_src_rows[c, o]) if d < R1}
                col = pl.h_rail_rows[c, :, o].tolist()
                assert {d: s for d, s in enumerate(col) if s < sentinel} == pairs


# ---- tests/test_ep_ht.py, hierarchical cases -----------------------------

@pytest.mark.parametrize("no,ni", [(2, 4), (4, 2)])
@pytest.mark.parametrize("e,k", [(16, 4), (8, 3)])
def test_ht_hierarchical_roundtrip(no, ni, e, k):
    x, topk, w = inputs(2, k=k, e=e)
    cfg = tcfg(e=e, k=k)
    group, _, _, recv, outs = torch_roundtrip(cfg, x, topk, w, c=comm(no, ni))
    assert (group.outer_size, group.inner_size) == (no, ni)
    np.testing.assert_allclose(np.stack([o.numpy() for o in outs]), oracle(x, topk, w),
                               **ORACLE)
    assert sum(int(c.sum()) for _, c in recv) == N * T * k


def test_ht_hier_matches_flat():
    """The hierarchical path computes the flat path's function."""
    x, topk, w = inputs(3, t=8)
    flat = EpGroupConfig(num_experts=E, max_tokens_per_rank=8, hidden=H, top_k=K,
                         mode="ht", payload_dtype=torch.float32)
    *_, out_f = torch_roundtrip(flat, x, topk, w, c=LocalComm(N))
    *_, out_h = torch_roundtrip(tcfg(t=8), x, topk, w)
    np.testing.assert_allclose(np.stack([o.numpy() for o in out_h]),
                               np.stack([o.numpy() for o in out_f]), **ORACLE)


@pytest.mark.parametrize("nc", [1, 2])
def test_ht_hier_fp8_stage2_scales_bitwise(nc):
    """fp8 stays fp8 across both hops and the scales ride the stage-2 fan:
    the dispatch tensor is bit equal to the flat path's, and every row of an
    expert region is the quantize->dequantize round trip of a token routed
    to that expert."""
    x, topk, w = inputs(11)
    flat = EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K,
                         mode="ht", payload_dtype=torch.float32, quantize_dispatch=True,
                         quant_block=H)
    _, _, _, rf, _ = torch_roundtrip(flat, x, topk, w, c=LocalComm(N))
    _, _, _, rh, _ = torch_roundtrip(tcfg(nc=nc, fp8=True), x, topk, w)
    for (yf, cf), (yh, ch) in zip(rf, rh):
        assert torch.equal(cf, ch) and torch.equal(yf, yh)
    xq = ref.dequantize_fp8(*ref.quantize_fp8(torch.from_numpy(x).reshape(N * T, H), H))
    xq = xq.float().numpy().reshape(N, T, H)
    L = E // N
    for r, (y, c) in enumerate(rf):
        for le in range(L):
            rows = y[le, :int(c[le])].float().numpy()
            want = np.stack([xq[s, t] for s in range(N) for t in range(T)
                             if (topk[s, t] == r * L + le).any()])
            np.testing.assert_array_equal(np.sort(rows, 0), np.sort(want, 0))


def test_ht_hier_fp8_roundtrip_close():
    """fp8 dispatch, 2 chunks: lossy only by the quantization (2e-2 of the
    oracle over the plain quantize->dequantize round trip of x)."""
    x, topk, w = inputs(12)
    *_, outs = torch_roundtrip(tcfg(nc=2, fp8=True), x, topk, w)
    xq = ref.dequantize_fp8(*ref.quantize_fp8(torch.from_numpy(x), H)).float().numpy()
    np.testing.assert_allclose(np.stack([o.float().numpy() for o in outs]),
                               oracle(xq, topk, w), rtol=2e-2, atol=2e-2)


# ---- tests/test_ht_chunked.py --------------------------------------------

@pytest.mark.parametrize("fp8", [False, True], ids=["f32", "fp8"])
@pytest.mark.parametrize("nc", [2, 4])
def test_chunked_bitwise_matches_monolithic(nc, fp8):
    """Same dispatch tensor, counts and combined output, bit for bit."""
    x, topk, w = inputs(0)
    *_, r1, o1 = torch_roundtrip(tcfg(nc=1, fp8=fp8), x, topk, w)
    *_, rc, oc = torch_roundtrip(tcfg(nc=nc, fp8=fp8), x, topk, w)
    for (a, ca), (b, cb), oa, ob in zip(r1, rc, o1, oc):
        assert torch.equal(a, b) and torch.equal(ca, cb) and torch.equal(oa, ob)


def test_chunked_roundtrip_matches_oracle():
    x, topk, w = inputs(1)
    *_, recv, outs = torch_roundtrip(tcfg(nc=2), x, topk, w)
    np.testing.assert_allclose(np.stack([o.numpy() for o in outs]), oracle(x, topk, w),
                               **ORACLE)
    assert sum(int(c.sum()) for _, c in recv) == N * T * K


def test_chunk_maps_have_chunk_axis():
    x, topk, w = inputs(2)
    group, hs, *_ = torch_roundtrip(tcfg(nc=2), x, topk, w)
    L, A = group.local_experts, group.ht_expert_cap
    C1, C2 = group.ht_stage1_cap, group.ht_stage2_cap
    for hd in hs:
        p = hd.plan
        assert p.h_gmap1.shape == (2, Ni, C1) and p.h_gmap2.shape == (2, No, C2)
        assert p.h_slot_tgt.shape == p.h_w_slot.shape == (L * A,)
        assert p.h_rail_dst_rows.shape == p.h_rail_src_rows.shape
        assert p.h_rail_dst_rows.shape[0] == 2
        assert p.h_src_rows.shape == (T, Ni)
        assert p.h_slot_rows.shape == (2 * No * C2, min(K, L))
        assert p.h_rail_rows.shape == (2, Ni * C1, No)


def test_chunk_slices_survive_refresh():
    """A weights-only refresh rebinds h_w_slot through h_entry_slot and
    reuses every chunk slice by identity."""
    x, topk, w = inputs(3)
    _, _, w2 = inputs(33)
    group = ep_create_group(tcfg(nc=2), comm())
    hs = ep_create_handle(group, [torch.from_numpy(a) for a in topk],
                          [torch.from_numpy(a) for a in w])
    hs2 = ep_handle_refresh(group, hs, [torch.from_numpy(a) for a in w2])
    for a, b in zip(hs, hs2):
        for f in ("h_gmap1", "h_gmap2", "h_slot_tgt", "disp_recv_gmap", "h_slot_rows",
                  "h_rail_rows", "h_src_rows"):
            assert getattr(b.plan, f) is getattr(a.plan, f), f
        assert b.plan is not a.plan
    recv = ep_dispatch(group, hs2, [torch.from_numpy(a) for a in x])
    L = group.local_experts
    ys = [y * (1.0 + torch.arange(r * L, (r + 1) * L)).float()[:, None, None]
          for r, (y, _) in enumerate(recv)]
    out = np.stack([o.numpy() for o in ep_combine(group, hs2, ys)])
    np.testing.assert_allclose(out, oracle(x, topk, w2), rtol=2e-5, atol=2e-5)


def test_chunks_must_divide_tokens():
    with pytest.raises(ValueError, match="must divide max_tokens_per_rank"):
        ep_create_group(tcfg(nc=3), comm())
    with pytest.warns(UserWarning, match="monolithic"):
        assert _resolve_chunks(3, T) == 1
    assert _resolve_chunks(4, T) == 4


def test_staged_hier_chunked_equals_eager():
    x, topk, w = inputs(4)
    *_, rs, os_ = torch_roundtrip(tcfg(nc=2), x, topk, w, staged=True)
    *_, re, oe = torch_roundtrip(tcfg(nc=2), x, topk, w, staged=False)
    for (a, _), (b, _), oa, ob in zip(rs, re, os_, oe):
        assert torch.equal(a, b) and torch.equal(oa, ob)


def test_no_atomic_accumulation_on_the_hierarchical_path():
    """The combine's sums run through B4 over fixed-order maps: neither the
    hierarchical phases nor the hierarchical plan call an accumulating
    scatter (CUDA atomics would make the sums' order run-dependent)."""
    import inspect
    from repro_torch.core import ht
    fns = (ht, PM.rank_pod, PM._set_true, PM._hier_geometry, PM._hier_recv_chain,
           PM._ht_hier_plan, PM._slot_rows, PM._rail_rows, PM.rebind_weights)
    for fn in fns:
        src = inspect.getsource(fn)
        for name in ("index_add", "scatter_add", "accumulate=True", "scatter_reduce"):
            assert name not in src, (getattr(fn, "__name__", fn), name)


def test_hand_built_handles_derive_their_plans():
    """Handles without a plan get theirs derived at the phase, the
    hierarchical weights gathered from the handles: the same round trip,
    bit for bit."""
    x, topk, w = inputs(6)
    group, hs, _, recv, outs = torch_roundtrip(tcfg(nc=2), x, topk, w)
    bare = [dataclasses.replace(h, plan=None) for h in hs]
    recv2 = ep_dispatch(group, bare, [torch.from_numpy(a) for a in x])
    L = group.local_experts
    ys = [y * (1.0 + torch.arange(r * L, (r + 1) * L)).float()[:, None, None]
          for r, (y, _) in enumerate(recv2)]
    for (a, _), (b, _), oa, ob in zip(recv, recv2, outs, ep_combine(group, bare, ys)):
        assert torch.equal(a, b) and torch.equal(oa, ob)


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
def test_prefill_pipeline_matches_sequential(hier):
    """The skewed micro-batch schedule is a pure reordering: bitwise equal
    to the sequential loop, over the flat and the hierarchical group."""
    MB = 2
    cfg = (tcfg(nc=2, t=T // MB) if hier else
           EpGroupConfig(num_experts=E, max_tokens_per_rank=T // MB, hidden=H, top_k=K,
                         mode="ht", payload_dtype=torch.float32))
    group = ep_create_group(cfg, comm() if hier else LocalComm(N))
    assert group.hierarchical == hier
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(a) for a in rng.standard_normal((N, T, H)).astype(np.float32)]
    router_w = torch.from_numpy(rng.standard_normal((H, E)).astype(np.float32))

    def router_fn(xt):
        w, idx = torch.topk(torch.softmax(xt @ router_w, -1), K)
        return idx.to(torch.int32), w / w.sum(-1, keepdim=True)

    L = group.local_experts

    def expert_fn(rank, y3d, counts):
        return y3d * (1.0 + torch.arange(rank * L, (rank + 1) * L)).to(y3d.dtype)[:, None, None]

    pipe = prefill_moe(group, router_fn, expert_fn, xs, MB)
    seq = sequential_prefill(group, router_fn, expert_fn, xs, MB)
    for a, b in zip(pipe, seq):
        assert torch.equal(a, b)


# ---- the hierarchical MoE layer and lm_forward ---------------------------

def _smoke(fp8=False, nc=2, axes=("pod", "data"), **moe):
    """The DBRX smoke config in f32 with the hierarchical HT options."""
    ep = dict(ep_mode="ht", ep_axis=axes, ht_hierarchical=True, ht_num_chunks=nc,
              quantize_dispatch=fp8, **moe)
    jcfg, tcfg_ = jax_smoke(), smoke_config()
    jcfg = dataclasses.replace(jcfg, d_model=128, dtype=jnp.float32,
                               moe=dataclasses.replace(jcfg.moe, **ep))
    tcfg_ = dataclasses.replace(tcfg_, d_model=128, dtype=torch.float32,
                                moe=dataclasses.replace(tcfg_.moe, **ep))
    return jcfg, tcfg_


def _mesh(shape=(No, Ni), names=("pod", "data")):
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("fp8", [False, True])
def test_moe_block_hier_matches_jax(fp8):
    """The hierarchical MoE layer (capacity 1.25, 2 chunks): JAX on the
    2 x 4 mesh against LocalComm(8) on the same axes, within 1e-5 in f32;
    with fp8 dispatch the expert GEMMs round to bf16 (as in
    tests/test_torch_ht.py: within 2e-2)."""
    jcfg, tc = _smoke(fp8, capacity_factor=1.25, expert_capacity_factor=1.25)
    tol = dict(rtol=2e-2, atol=2e-2) if fp8 else F32
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(5), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tc, device="cpu")
    p_np = jax.tree.map(lambda a: a[0], tree["moe_stack"]["moe"])
    p_t = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    x = np.random.default_rng(6).standard_normal((N, 32, 128)).astype(np.float32)
    want, want_aux = jax.jit(lambda p, x: jax_moe_block(p, x, jcfg, _mesh()))(
        p_np, jnp.asarray(x))
    got, aux = moe_block(p_t, torch.from_numpy(x), tc, comm())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(aux.item(), float(want_aux), **F32)


def test_moe_block_hierarchical_matches_dense():
    """tests/test_moe_block.py:48: EP over ("data", "model") of 4 x 2,
    hierarchical, zero drop, against the dense fallback within 5e-3."""
    _, tc = _smoke(nc=1, axes=("data", "model"), capacity_factor=None,
                   expert_capacity_factor=None)
    jcfg, _ = _smoke(nc=1, axes=("data", "model"))
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(0), jax_lm_spec(jcfg)))
    p_t = {k: v[0] for k, v in params_from_jax(tree, tc, device="cpu")["moe_stack"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 8, 128))
                         .astype(np.float32) * 0.1)
    c = comm(4, 2, ("data", "model"))
    y, _ = moe_block(p_t, x, tc, c)
    np.testing.assert_allclose(y.numpy(), _moe_dense_fallback(p_t, x, tc).numpy(),
                               rtol=5e-3, atol=5e-3)


def test_lm_forward_hier_matches_jax():
    """get_model(cfg).forward over the hierarchical group (capacity 1.25,
    2 chunks), 8 x 64 tokens: loss and aux within 1e-5 of JAX's."""
    jcfg, tc = _smoke(capacity_factor=1.25, expert_capacity_factor=1.25)
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(7), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tc, device="cpu")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (N, 64)).astype(np.int32)
    jfwd = jax_get_model(jcfg).forward
    want, waux = jax.jit(lambda p, b: jfwd(p, b, jcfg, _mesh()))(
        tree, {"tokens": jnp.asarray(toks)})
    got, aux = get_model(tc).forward(params, {"tokens": torch.from_numpy(toks)}, tc, comm())
    np.testing.assert_allclose(got.item(), float(want), **F32)
    np.testing.assert_allclose(aux["aux"].item(), float(waux["aux"]), **F32)


def test_refresh_select_keeps_weights_out():
    """A refresh with replayed routing keeps the cached maps and binds the
    new weights: h_w_slot equals a fresh handle's on the new weights."""
    x, topk, w = inputs(9)
    _, _, w2 = inputs(19)
    group = ep_create_group(tcfg(nc=2), comm())
    hs = ep_create_handle(group, [torch.from_numpy(a) for a in topk],
                          [torch.from_numpy(a) for a in w])
    again = [torch.from_numpy(a.copy()) for a in topk]
    hs2 = ep_handle_refresh(group, hs, [torch.from_numpy(a) for a in w2], again)
    fresh = ep_create_handle(group, again, [torch.from_numpy(a) for a in w2])
    for a, b in zip(hs2, fresh):
        for f in dataclasses.fields(PM.EpPlan):
            va, vb = getattr(a.plan, f.name), getattr(b.plan, f.name)
            assert (va is None) == (vb is None), f.name
            if va is not None:
                assert torch.equal(va, vb), f.name
