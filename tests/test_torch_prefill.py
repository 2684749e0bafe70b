"""The port's prefill forward against the JAX package, f32 on the CPU.

Plain ``flash_attention`` against JAX's Pallas kernel in interpret mode;
``_sdpa_chunked`` and attention without a cache against JAX's; the
cross-entropy; ``lm_forward`` through ``get_model(cfg).forward`` in HT mode
at S >= 2048 (so attention takes the flash route) on the DBRX smoke config
with the train preset's EP options, JAX on 8 fake devices against
``LocalComm(8)``, parameters shared through ``params_from_jax``; and the
micro-batched ``prefill_moe`` driver and ``sequential_prefill`` against
JAX's on 8 fake devices and against each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.core import plan as JPM
from repro.core.group import EpGroupConfig as JCfg
from repro.core.group import ep_create_group as j_create_group
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as JATT
from repro.models import get_model as jax_get_model
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro.runtime.prefill import prefill_moe as jax_prefill_moe
from repro.runtime.prefill import sequential_prefill as jax_sequential_prefill
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.core import EpGroupConfig, ep_create_group
from repro_torch.core.routing import RouterConfig, route
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as ATT
from repro_torch.models import get_model
from repro_torch.models.layers import cross_entropy
from repro_torch.runtime.prefill import (prefill_moe, rebalancing_prefill,
                                         sequential_prefill)
from repro_torch.weights import params_from_jax

N = 8
F32 = dict(rtol=1e-5, atol=1e-5)


def mesh():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


def qkv(seed, B, Hq, Hkv, Sq, Sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, d)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, d)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, d)).astype(np.float32))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, None),
                                           (False, 100)])
def test_plain_flash_attention_matches_pallas_interpret(G, causal, window):
    """f32 within 1e-5 of the Pallas kernel run in interpret mode."""
    q, k, v = qkv(1, 1, 2 * G, 2, 256, 256, 32)
    scale = 32 ** -0.5
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                     window=window, causal=causal, interpret=True)
    got = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=scale, window=window,
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the [B, S, H, d] route of ops on CPU tensors is the same plain version
    t = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    bshd = ops.flash_attention_bshd(*t, scale=scale, window=window, causal=causal)
    np.testing.assert_array_equal(bshd.transpose(1, 2).numpy(), got.numpy())


def test_hbm_bytes_counts_qkvo_once():
    B, Hq, Hkv, S, d = 8, 48, 8, 4096, 128
    assert ref.hbm_bytes(B, Hq, Hkv, S, S, d) == 2 * (2 * B * Hq * S * d + 2 * B * Hkv * S * d)


@pytest.mark.parametrize("softcap,window", [(30.0, None), (None, 70), (20.0, 90)])
def test_sdpa_chunked_matches_jax(softcap, window):
    """Softcap and a ragged tail (Sk = 300 over chunks of 128), f32 1e-5."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 300, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 300, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 300, 2, 16)).astype(np.float32)
    want = JATT._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              softcap, 0.25, window, chunk=128)
    got = ATT._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), softcap, 0.25, window, chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _cfgs(**moe):
    """The DBRX smoke config in f32, MoE options replaced on both sides."""
    jcfg, tcfg = jax_smoke(), smoke_config()
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               moe=dataclasses.replace(jcfg.moe, **moe))
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32,
                               moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def shared():
    jcfg, tcfg = _cfgs()
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(0), jax_lm_spec(jcfg)))
    return tree, params_from_jax(tree, tcfg, device="cpu")


# (S, window, causal): the flash route, its window, a ragged S (chunked),
# short and non-causal (plain _sdpa)
ATTN_CASES = [(2048, None, True), (2048, 300, True), (2112, None, True),
              (256, None, True), (256, None, False)]


@pytest.mark.parametrize("S,window,causal", ATTN_CASES)
def test_attention_without_cache_matches_jax(shared, S, window, causal):
    """JAX on the CPU takes _sdpa_chunked where the port takes the plain
    flash_attention: the same function. f32 within 1e-5 of the output's
    largest value (about 100 here: the output projection sums 64 products
    of that size, with cancellation, in another order than XLA)."""
    tree, params = shared
    jcfg, tcfg = _cfgs()
    p_np = jax.tree.map(lambda a: a[0], tree["moe_stack"]["attn"])
    p_t = {k: v[0] for k, v in params["moe_stack"]["attn"].items()}
    x = np.random.default_rng(3).standard_normal((1, S, jcfg.d_model)).astype(np.float32)
    want, wc = JATT.attention(p_np, jnp.asarray(x), jcfg, None, window=window,
                              causal=causal)
    got, tc = ATT.attention(p_t, torch.from_numpy(x), tcfg, window=window, causal=causal)
    assert wc is None and tc is None
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_attention_refuses_cross_attention(shared):
    _, params = shared
    _, tcfg = _cfgs()
    p_t = {k: v[0] for k, v in params["moe_stack"]["attn"].items()}
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="A12"):
        ATT.attention(p_t, x, tcfg, kv_override=(x, x))


def test_cross_entropy_matches_jax():
    """1500 rows: two log-sum-exp blocks, the second ragged."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 500, 40)).astype(np.float32) * 4
    tg = rng.integers(0, 40, (3, 500)).astype(np.int32)
    mask = (rng.random((3, 500)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(tg),
                                 None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(tg),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), **F32)


def test_lm_forward_ht_matches_jax():
    """get_model(cfg).forward, HT flat mode with the train preset's
    capacities (1.25, drops possible), S = 2048 so every layer takes the
    flash route: loss and aux within 1e-5 of JAX's."""
    ep = dict(ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25)
    jcfg, tcfg = _cfgs(**ep)
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(7), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (N, 2048)).astype(np.int32)
    m = mesh()
    jfwd = jax_get_model(jcfg).forward
    want, waux = jax.jit(lambda p, b: jfwd(p, b, jcfg, m))(tree, {"tokens": jnp.asarray(toks)})
    got, aux = get_model(tcfg).forward(params, {"tokens": torch.from_numpy(toks)}, tcfg,
                                       LocalComm(N))
    np.testing.assert_allclose(got.item(), float(want), **F32)
    np.testing.assert_allclose(aux["aux"].item(), float(waux["aux"]), **F32)
    assert get_model(tcfg).forward is not None and np.isfinite(got.item())


def test_get_model_refuses_unported_families():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="A12"):
        get_model(dataclasses.replace(tcfg, family="ssm"))
    # MLA and MTP are ported (tests/test_torch_deepseek.py), vlm and gemma3
    # too (tests/test_torch_gemma3_vlm.py); the forward still refuses a
    # family the port lacks before it reads a parameter
    with pytest.raises(NotImplementedError, match="A12"):
        get_model(tcfg).forward({}, {"tokens": torch.zeros((1, 2), dtype=torch.int32)},
                                dataclasses.replace(tcfg, family="encdec"), None)


def test_prefill_moe_bitwise_equal_to_sequential():
    """The skewed micro-batch schedule is a pure reordering: bitwise equal
    to the sequential loop, in f32 and with fp8 dispatch."""
    E, K, T, H, MB = 16, 4, 32, 128, 2
    rng = np.random.default_rng(9)
    xs = [torch.from_numpy(a) for a in rng.standard_normal((N, T, H)).astype(np.float32)]
    router_w = torch.from_numpy(rng.standard_normal((H, E)).astype(np.float32))
    rcfg = RouterConfig(num_experts=E, top_k=K)

    def router_fn(x):
        r = route(x @ router_w, rcfg)
        return r.topk_idx, r.topk_weights

    for fp8 in (False, True):
        group = ep_create_group(EpGroupConfig(
            num_experts=E, max_tokens_per_rank=T // MB, hidden=H, top_k=K, mode="ht",
            payload_dtype=torch.float32, quantize_dispatch=fp8), LocalComm(N))
        L = group.local_experts

        def expert_fn(rank, y3d, counts):
            return y3d * (1.0 + torch.arange(rank * L, (rank + 1) * L)).to(y3d.dtype)[:, None, None]

        pipe = prefill_moe(group, router_fn, expert_fn, xs, MB)
        seq = sequential_prefill(group, router_fn, expert_fn, xs, MB)
        assert len(pipe) == N and pipe[0].shape == (T, H)
        for a, b in zip(pipe, seq):
            assert torch.equal(a, b)
    # the EPLB prefill driver (tests/test_torch_eplb.py) checks its window
    with pytest.raises(ValueError, match="rebalance_every=0"):
        rebalancing_prefill(EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H,
                                          top_k=K), None, [], rebalance_every=0, ep_size=N)


def test_prefill_moe_matches_jax_prefill():
    """Both drivers against JAX's on the same tokens and routing, with fp8
    dispatch and without: the micro-batch split and the order of the
    concatenated output. The router is exact in f32 in both packages
    (integer logits from sign(x) @ W plus distinct offsets e/64, weights
    1/K), so the routing is the same; the outputs agree within 1e-5 (the
    combine sums K terms in f32)."""
    E, K, T, H, MB = 16, 4, 32, 128, 2
    rng = np.random.default_rng(10)
    x = rng.standard_normal((N, T, H)).astype(np.float32)
    W = rng.integers(-3, 4, (H, E)).astype(np.float32)
    offs = np.arange(E, dtype=np.float32) / 64
    w_t, offs_t = torch.from_numpy(W), torch.from_numpy(offs)

    def t_router(xt):
        idx = torch.topk(torch.sign(xt) @ w_t + offs_t, K).indices.to(torch.int32)
        return idx, torch.full(idx.shape, 1.0 / K)

    def j_router(xt):
        _, idx = jax.lax.top_k(jnp.sign(xt) @ jnp.asarray(W) + jnp.asarray(offs), K)
        return idx.astype(jnp.int32), jnp.full(idx.shape, 1.0 / K, jnp.float32)

    for fp8 in (False, True):
        base = dict(num_experts=E, max_tokens_per_rank=T // MB, hidden=H, top_k=K,
                    mode="ht", quantize_dispatch=fp8)
        group = ep_create_group(EpGroupConfig(payload_dtype=torch.float32, **base),
                                LocalComm(N))
        jgroup = j_create_group(JCfg(payload_dtype=jnp.float32, **base), ep_size=N)
        L = group.local_experts

        def t_experts(rank, y3d, counts):
            return y3d * (1.0 + torch.arange(rank * L, (rank + 1) * L)).to(y3d.dtype)[:, None, None]

        def j_experts(y3d, counts):
            e = JPM.my_rank(jgroup) * L + jnp.arange(L)
            return y3d * (1.0 + e)[:, None, None].astype(y3d.dtype)

        def step(xs):
            return tuple(f(jgroup, j_router, j_experts, xs[0], MB)[None]
                         for f in (jax_prefill_moe, jax_sequential_prefill))
        fn = jax.jit(jax.shard_map(step, mesh=mesh(), in_specs=(P("data"),),
                                   out_specs=(P("data"), P("data"))))
        want_pipe, want_seq = map(np.asarray, fn(jnp.asarray(x)))
        np.testing.assert_array_equal(want_pipe, want_seq)
        xs = [torch.from_numpy(a) for a in x]
        for drive in (prefill_moe, sequential_prefill):
            got = np.stack([o.numpy() for o in drive(group, t_router, t_experts, xs, MB)])
            np.testing.assert_allclose(got, want_pipe, **F32, err_msg=f"{drive.__name__} fp8 {fp8}")
