"""The port's positional EP layouts against the JAX package: LL ``deepep``
(fp8 dispatch included) and the baseline a2a dispatcher.

JAX runs its 8 EP ranks as fake CPU devices under shard_map (the production
jit + shard_map path); the port hosts its 8 ranks in one process with
``LocalComm(8)``. Every plan map of every rank and the dispatch output
[L, A, H] must match bit for bit. The round trip must satisfy the oracle:
with each expert e scaling its rows by (1+e), token t comes back as
x[t]·Σ_k w[t,k]·(1+topk[t,k]) over its kept entries.

The MoE layers are held in f32 within 1e-5. The reference's ``deepep``
layer does not compute the MoE function (its ``_expert_ffn`` zeroes rows
past each expert's count, but ``deepep`` lands rows by position), so the
port's ``deepep`` layer is held to JAX's dense fallback and to JAX's
``nccl_ep`` layer, and one test pins the reference's fault.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.core import api as japi
from repro.core.group import EpGroupConfig as JCfg
from repro.core.group import ep_create_group as j_create_group
from repro.models.moe import _moe_dense_fallback as jax_dense
from repro.models.moe import moe_block as jax_moe_block
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro.runtime.server import DecodeServer as JaxServer
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.core import (EpGroupConfig, ep_combine, ep_complete,
                              ep_create_group, ep_create_handle, ep_dispatch)
from repro_torch.kernels import ref
from repro_torch.models.moe import moe_block
from repro_torch.runtime.server import DecodeServer
from repro_torch.weights import params_from_jax

N = 8
E, K, T, H = 16, 4, 16, 32
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
MAPS = ("disp_send_gmap", "disp_counts", "comb_recv_rows")
F32 = dict(rtol=1e-5, atol=1e-5)
DEEPEP = dict(mode="ll", ll_layout="deepep")
BASELINE = dict(mode="baseline")


def mesh():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


def routing(seed, h=H, skew=False):
    """Per-rank routing [N, T, K] (distinct experts per token), normalised
    weights and tokens, from a numpy seed. ``skew`` favours experts 0 and 1
    (both on rank 0), so per-expert capacities overflow."""
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


def configs(layout, hidden=H, dtype=torch.float32, **kw):
    base = dict(num_experts=E, max_tokens_per_rank=T, hidden=hidden, top_k=K,
                **layout, **kw)
    return EpGroupConfig(payload_dtype=dtype, **base), JCfg(payload_dtype=JDT[dtype], **base)


def jax_run(jcfg, topk, w, x, num_tokens=None, dtype=jnp.float32):
    """Per-rank plan maps, dispatch output and round trip through the JAX
    production path (its unified API), stacked [N, ...] as numpy."""
    group = j_create_group(jcfg, ep_size=N)

    def step(tk, wt, xs):
        h = japi.ep_create_handle(group, tk[0], wt[0], num_tokens)
        out = {f: getattr(h.plan, f)[None] for f in MAPS}
        out["tokens_per_expert"] = h.tokens_per_expert[None]
        y3d, _ = japi.ep_dispatch(group, h, xs[0])
        out["y3d"] = y3d[None]
        L = group.local_experts
        e_glob = jax.lax.axis_index("data") * L + jnp.arange(L)
        y3d = y3d * (1.0 + e_glob)[:, None, None].astype(y3d.dtype)
        out["out"] = japi.ep_combine(group, h, y3d)[None]
        return out

    fn = jax.jit(jax.shard_map(step, mesh=mesh(), in_specs=(P("data"),) * 3,
                               out_specs=P("data")))
    res = fn(jnp.asarray(topk), jnp.asarray(w), jnp.asarray(x, dtype))
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
            for k, v in res.items()}


def torch_run(tcfg, topk, w, x, num_tokens=None, dtype=torch.float32):
    group = ep_create_group(tcfg, LocalComm(N))
    handles = ep_create_handle(group, [torch.from_numpy(t) for t in topk],
                               [torch.from_numpy(t) for t in w], num_tokens)
    xs = [torch.from_numpy(r).to(dtype) for r in x]
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


def as_np(ts):
    return np.stack([t.float().numpy() for t in ts])


# name -> (layout, group options, num_tokens, skewed routing)
CASES = {
    "deepep_zero_drop": (DEEPEP, {}, None, False),
    "deepep_padding": (DEEPEP, {}, 5, False),
    "baseline_zero_drop": (BASELINE, {}, None, False),
    "baseline_drops": (BASELINE, dict(capacity_factor=1.0), None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_maps_dispatch_and_roundtrip_match_jax(case):
    """Every plan map and the dispatch output bitwise; the round trip equal
    to JAX's and to the oracle over the kept entries (padding rows and
    entries past a per-expert capacity come back as nothing)."""
    layout, kw, nt, skew = CASES[case]
    tcfg, jcfg = configs(layout, **kw)
    topk, w, x = routing(30, skew=skew)
    want = jax_run(jcfg, topk, w, x, num_tokens=nt)
    group, handles, recv, outs = torch_run(tcfg, topk, w, x, num_tokens=nt)
    for name in MAPS:
        got = np.stack([getattr(h.plan, name).numpy() for h in handles])
        assert got.dtype == want[name].dtype == np.int32, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    assert handles[0].plan.disp_recv_gmap is None and handles[0].plan.comb_send_gmap is None
    np.testing.assert_array_equal(np.stack([h.tokens_per_expert.numpy() for h in handles]),
                                  want["tokens_per_expert"])
    np.testing.assert_array_equal(as_np([y for y, _ in recv]), want["y3d"])
    got = as_np(outs)
    np.testing.assert_allclose(got, want["out"], rtol=1e-6, atol=1e-6)
    # recv is [L, N·c, H] with c slots per (expert, source rank); a combine
    # row at or past N·L·c is the sentinel: the entry was dropped or padded
    c = recv[0][0].shape[1] // N
    kept = np.stack([h.plan.comb_recv_rows.numpy() for h in handles]) < N * group.local_experts * c
    valid = np.broadcast_to(np.arange(T)[None, :, None] < (T if nt is None else nt), kept.shape)
    assert not (kept & ~valid).any()
    np.testing.assert_allclose(got, oracle(x, topk, w, kept), **F32)
    dropped = int((~kept & valid).sum())
    assert (dropped > 0) == (case == "baseline_drops"), dropped


@pytest.mark.parametrize("layout", ["deepep", "baseline"])
def test_dispatch_output_bitwise_bf16(layout):
    tcfg, jcfg = configs(DEEPEP if layout == "deepep" else BASELINE,
                         dtype=torch.bfloat16)
    topk, w, x = routing(31)
    want = jax_run(jcfg, topk, w, x, dtype=jnp.bfloat16)
    _, _, recv, outs = torch_run(tcfg, topk, w, x, dtype=torch.bfloat16)
    assert recv[0][0].dtype == outs[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(as_np([y for y, _ in recv]), want["y3d"])
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(as_np(outs), oracle(xb, topk, w), rtol=2e-2, atol=2e-2)


def test_deepep_fp8_dispatch_bitwise_and_roundtrip():
    """fp8 payload at H = 256: the recv transposes the fp8 rows and their
    scales and dequantizes them with the standalone kernel's plain version,
    bit-equal to JAX's; the round trip matches the oracle of the plain
    quantize->dequantize of x within the JAX package's fp8 tolerance
    (2e-2, tests/test_ep_ht.py)."""
    tcfg, jcfg = configs(DEEPEP, hidden=256, quantize_dispatch=True)
    topk, w, x = routing(32, h=256)
    want = jax_run(jcfg, topk, w, x)
    _, _, recv, outs = torch_run(tcfg, topk, w, x)
    assert recv[0][0].dtype == torch.bfloat16 and recv[0][0].shape == (E // N, N * T, 256)
    np.testing.assert_array_equal(as_np([y for y, _ in recv]), want["y3d"])
    q, s = ref.quantize_fp8(torch.from_numpy(x), 128)
    xq = ref.dequantize_fp8(q, s).float().numpy()
    np.testing.assert_allclose(as_np(outs), oracle(xq, topk, w), rtol=2e-2, atol=2e-2)


def test_deepep_refuses_more_tokens_than_its_slots():
    tcfg, _ = configs(DEEPEP)
    topk, w, _ = routing(33)
    small = dataclasses.replace(tcfg, max_tokens_per_rank=T // 2)
    with pytest.raises(ValueError, match="deepep"):
        ep_create_handle(ep_create_group(small, LocalComm(N)),
                         [torch.from_numpy(t) for t in topk],
                         [torch.from_numpy(t) for t in w])


# ---------------------------------------------------------------------------
# the MoE layer and the server, smoke DBRX in f32 on 8 ranks
# ---------------------------------------------------------------------------

def smoke_cfgs(**moe):
    jcfg, tcfg = jax_smoke(), smoke_config()
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               moe=dataclasses.replace(jcfg.moe, **moe))
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32,
                               moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def layer():
    """One f32 JAX parameter tree, MoE layer 0 as numpy and as the port's
    tensors, and an input of 8 tokens per rank."""
    jcfg, tcfg = smoke_cfgs()
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(7), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tcfg, device="cpu")
    p_np = jax.tree.map(lambda a: a[0], tree["moe_stack"]["moe"])
    p_t = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    x = 0.1 * np.random.default_rng(8).standard_normal((2 * N, 4, jcfg.d_model))
    return tree, params, p_np, p_t, x.astype(np.float32)


def jax_layer(p_np, x, **moe):
    jcfg, _ = smoke_cfgs(**moe)
    m = mesh()
    y, _ = jax.jit(lambda p, x: jax_moe_block(p, x, jcfg, m))(p_np, jnp.asarray(x))
    return np.asarray(y)


def port_layer(p_t, x, **moe):
    _, tcfg = smoke_cfgs(**moe)
    y, _ = moe_block(p_t, torch.from_numpy(x), tcfg, LocalComm(N))
    return y.numpy()


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_moe_block_deepep_matches_dense_and_nccl_ep(layer):
    _, _, p_np, p_t, x = layer
    jcfg, _ = smoke_cfgs()
    dense = np.asarray(jax_dense(p_np, jnp.asarray(x), jcfg))
    got = port_layer(p_t, x, ll_layout="deepep")
    np.testing.assert_allclose(got, dense, **F32)
    np.testing.assert_allclose(got, jax_layer(p_np, x), **F32)   # JAX nccl_ep


def test_moe_block_baseline_matches_jax(layer):
    _, _, p_np, p_t, x = layer
    want = jax_layer(p_np, x, ep_mode="baseline")
    np.testing.assert_allclose(port_layer(p_t, x, ep_mode="baseline"), want, **F32)


def test_reference_deepep_layer_fault_is_pinned(layer):
    """The reference's deepep MoE layer passes each expert's count to
    grouped_gemm, which zeroes rows past it, while deepep lands token t of
    source rank n at row n·B + t: most valid rows are zeroed. JAX's layer is
    far from its own dense fallback; the port's, which computes every row,
    is within 1e-5. (ROADMAP Queue C; src/repro is not edited.)"""
    _, _, p_np, p_t, x = layer
    jcfg, _ = smoke_cfgs()
    dense = np.asarray(jax_dense(p_np, jnp.asarray(x), jcfg))
    assert rel(jax_layer(p_np, x, ll_layout="deepep"), dense) > 0.5
    assert rel(port_layer(p_t, x, ll_layout="deepep"), dense) < 1e-5


@pytest.mark.parametrize("layout,jax_moe", [
    ("deepep", {}),                          # the reference's deepep layer is faulty
    ("baseline", dict(ep_mode="baseline")),
])
def test_server_streams_match_jax(layer, layout, jax_moe):
    tree, params, *_ = layer
    port_moe = dict(ll_layout="deepep") if layout == "deepep" else dict(ep_mode="baseline")
    jcfg, _ = smoke_cfgs(**jax_moe)
    _, tcfg = smoke_cfgs(**port_moe)
    prompts = np.random.default_rng(9).integers(0, jcfg.vocab, (16, 4)).astype(np.int32)
    jsrv = JaxServer(jcfg, batch=16, max_len=16, mesh=mesh(), params=tree)
    try:
        first, _ = jsrv.prefill(jnp.asarray(prompts))
        want, _ = jsrv.decode(first, 4)
    finally:
        jsrv.close()
    srv = DecodeServer(tcfg, 16, 16, ep_size=N, params=params, device="cpu")
    got, itls = srv.decode(srv.prefill(prompts)[0], 4)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (16, 5) and len(itls) == 4
