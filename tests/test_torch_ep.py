"""The port's LL EP path against the JAX package on the same routing.

JAX runs its 8 EP ranks as fake CPU devices under shard_map (the production
jit + shard_map path, as ``repro/analysis/plan_verify.py`` extracts plans);
the port hosts its 8 ranks in one process with ``LocalComm(8)``. Every
EpPlan map of every rank and the dispatch output [L, A, H] must match bit
for bit. The round trip must satisfy the oracle: with each expert e scaling
its rows by (1+e), token t comes back as x[t]·Σ_k w[t,k]·(1+topk[t,k]).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import ll as jll
from repro.core.group import EpGroupConfig as JCfg
from repro.core.group import ep_create_group as j_create_group
from repro_torch.comm import LocalComm
from repro_torch.core import (EpGroupConfig, ep_combine, ep_complete,
                              ep_create_group, ep_create_handle, ep_dispatch)

N = 8
E, K, T, H = 16, 4, 16, 32
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def routing(seed, h=H):
    rng = np.random.default_rng(seed)
    topk = np.stack([np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
                     for _ in range(N)]).astype(np.int32)
    w = rng.random((N, T, K)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    x = rng.standard_normal((N, T, h)).astype(np.float32)
    return topk, w, x


def configs(hidden=H, **kw):
    dt = kw.pop("payload_dtype", torch.float32)
    base = dict(num_experts=E, max_tokens_per_rank=T, hidden=hidden, top_k=K,
                mode="ll")
    return (EpGroupConfig(payload_dtype=dt, **base, **kw),
            JCfg(payload_dtype=JDT[dt], **base, **kw))


def jax_run(jcfg, topk, w, x, num_tokens=None, roundtrip=False,
            dtype=jnp.float32):
    """Per-rank plan maps (and dispatch output, or round-trip output)
    through the JAX production path, stacked [N, ...] as numpy."""
    group = j_create_group(jcfg, ep_size=N)
    mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))

    def step(tk, wt, xs):
        h = jll.ll_create_handle(group, tk[0], wt[0], num_tokens)
        out = {f.name: getattr(h.plan, f.name)[None]
               for f in dataclasses.fields(h.plan) if getattr(h.plan, f.name) is not None}
        out["tokens_per_expert"] = h.tokens_per_expert[None]
        out["routing_hash"] = h.routing_hash[None]
        y3d, _ = jll.ll_dispatch(group, h, xs[0])
        out["y3d"] = y3d[None]
        if roundtrip:
            L = group.local_experts
            e_glob = jax.lax.axis_index("data") * L + jnp.arange(L)
            y3d = y3d * (1.0 + e_glob)[:, None, None].astype(y3d.dtype)
            out["out"] = jll.ll_combine(group, h, y3d)[None]
        return out

    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P("data"),) * 3,
                               out_specs=P("data")))
    res = fn(jnp.asarray(topk), jnp.asarray(w), jnp.asarray(x, dtype))
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
            for k, v in res.items()}


def torch_run(tcfg, topk, w, x, num_tokens=None, dtype=torch.float32):
    group = ep_create_group(tcfg, LocalComm(N))
    handles = ep_create_handle(group, [torch.from_numpy(t) for t in topk],
                               [torch.from_numpy(t) for t in w], num_tokens)
    xs = [torch.from_numpy(r).to(dtype) for r in x]
    pend = ep_dispatch(group, handles, xs, send_only=True)
    recv = ep_complete(group, handles, pend)
    L = group.local_experts
    y3ds = [y * (1.0 + torch.arange(r * L, (r + 1) * L)).to(y.dtype)[:, None, None]
            for r, (y, _) in zip(group.comm.ranks, recv)]
    outs = ep_combine(group, handles, y3ds)
    return group, handles, recv, outs


CASES = {
    "zero_drop": dict(),
    "padding": dict(num_tokens=5),
    "disp_drop": dict(capacity_factor=1.0, slot_align=1),
    "drop_and_padding": dict(capacity_factor=1.0, slot_align=1, num_tokens=11),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_maps_and_dispatch_match_jax(case):
    kw = dict(CASES[case])
    nt = kw.pop("num_tokens", None)
    tcfg, jcfg = configs(**kw)
    topk, w, x = routing(10)
    want = jax_run(jcfg, topk, w, x, num_tokens=nt)
    _, handles, recv, _ = torch_run(tcfg, topk, w, x, num_tokens=nt)
    for name in ("disp_send_gmap", "disp_recv_gmap", "disp_counts",
                 "comb_send_gmap", "comb_recv_rows"):
        got = np.stack([getattr(h.plan, name).numpy() for h in handles])
        assert got.dtype == want[name].dtype == np.int32, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    np.testing.assert_array_equal(np.stack([h.tokens_per_expert.numpy() for h in handles]),
                                  want["tokens_per_expert"])
    np.testing.assert_array_equal(np.stack([h.routing_hash.numpy() for h in handles]),
                                  want["routing_hash"].astype(np.int64))
    np.testing.assert_array_equal(np.stack([y.numpy() for y, _ in recv]), want["y3d"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_output_bitwise(dtype):
    tcfg, jcfg = configs(payload_dtype=dtype)
    topk, w, x = routing(11)
    want = jax_run(jcfg, topk, w, x, dtype=JDT[dtype])
    _, _, recv, _ = torch_run(tcfg, topk, w, x, dtype=dtype)
    assert recv[0][0].dtype == dtype
    np.testing.assert_array_equal(np.stack([y.float().numpy() for y, _ in recv]),
                                  want["y3d"])


def oracle(x, topk, w):
    return x * (w * (1.0 + topk)).sum(-1)[..., None]


def test_roundtrip_bf16_oracle():
    tcfg, _ = configs(payload_dtype=torch.bfloat16)
    topk, w, x = routing(12)
    *_, outs = torch_run(tcfg, topk, w, x, dtype=torch.bfloat16)
    got = np.stack([o.float().numpy() for o in outs])
    assert outs[0].dtype == torch.bfloat16
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, oracle(xb, topk, w), rtol=2e-2, atol=2e-2)


def test_roundtrip_fp8_dispatch():
    """fp8 payload: lossy but close; the dispatch output, dequantized in
    recv_unpack, is bit-equal to JAX's."""
    tcfg, jcfg = configs(quantize_dispatch=True, hidden=256)
    topk, w, x = routing(13, h=256)
    want = jax_run(jcfg, topk, w, x)
    _, _, recv, outs = torch_run(tcfg, topk, w, x)
    np.testing.assert_array_equal(np.stack([y.float().numpy() for y, _ in recv]),
                                  want["y3d"])
    got = np.stack([o.float().numpy() for o in outs])
    ref = oracle(x, topk, w)
    assert np.abs(got - ref).mean() / np.abs(ref).mean() < 0.08


def test_roundtrip_capacity_drop():
    """Capacity factor below zero-drop: dropped entries contribute zero but
    never corrupt other tokens, and the result equals JAX's."""
    tcfg, jcfg = configs(capacity_factor=1.0, slot_align=1)
    topk, w, x = routing(14)
    want = jax_run(jcfg, topk, w, x, roundtrip=True)["out"]
    *_, outs = torch_run(tcfg, topk, w, x)
    got = np.stack([o.numpy() for o in outs])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = oracle(x, topk, w)
    per_err = np.abs(got - ref).max(-1)
    assert 0.2 < (per_err < 1e-4).mean() < 1.0            # some drop, most survive
    assert np.all(np.abs(got).max(-1) <= np.abs(ref).max(-1) * (1.0 + K) + 1e-4)
