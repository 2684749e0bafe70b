"""The port's training gradients against the JAX package's AD, f32 on the CPU.

Each autograd Function of ``kernels/autograd.py`` (its forward and backward
on the plain versions of ``kernels/ref.py``, the formulas the card runs as
kernels) and the combine's transpose ``combine_gather_reduce_bwd`` against
``jax.vjp`` of the reference's plain function: the grouped GEMM, the
combine's gather-reduce, flash attention against the reference's
CPU path ``_sdpa_chunked``, and ``LocalComm``'s exchange against
``jax.lax.all_to_all``, all within 1e-5. ``moe_block``'s gradients in HT
flat and LL ``nccl_ep`` against ``jax.grad`` of the reference's layer on a
4-device mesh; every floating parameter of ``lm_forward`` getting a
gradient; ``jax.value_and_grad`` of the reference's forward against the
port's at S 32 and at S 2048 (the flash route). The other modes' and
layouts' gradients: ``tests/test_torch_train_layouts.py``; hierarchical HT
with a model axis: ``tests/test_torch_dist_train_hier.py``. The reference's fp8
dispatch gradient is pinned as degenerate (its AD casts the cotangent to
e4m3 without a scale, ROADMAP Queue C) and the port's is straight-through:
bitwise the bf16 dispatch's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.kernels import ref as jref
from repro.models import attention as JATT
from repro.models import get_model as jax_get_model
from repro.models.moe import moe_block as jax_moe_block
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.core import EpGroupConfig, ep_create_group, ep_create_handle
from repro_torch.core import ll as LL
from repro_torch.kernels import autograd as KA
from repro_torch.kernels import ops as KO
from repro_torch.kernels import ref
from repro_torch.models import get_model
from repro_torch.models.moe import moe_block
from repro_torch.weights import _leaves, params_from_jax

N = 4
F32 = dict(rtol=1e-5, atol=1e-5)


def mesh4():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,),
                         devices=jax.devices()[:N])


def _t(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_()


def test_grouped_gemm_vjp_matches_jax():
    """dX and dW of the grouped GEMM with ragged counts (an empty expert, a
    full one), the port's Function against jax.vjp of the reference's."""
    rng = np.random.default_rng(0)
    L, A, H, F = 3, 24, 16, 12
    x = rng.standard_normal((L, A, H)).astype(np.float32)
    w = rng.standard_normal((L, H, F)).astype(np.float32)
    counts = np.array([0, 9, 24], np.int32)
    gy = rng.standard_normal((L, A, F)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jref.grouped_gemm(a, b, jnp.asarray(counts)),
                     jnp.asarray(x), jnp.asarray(w))
    wx, ww = vjp(jnp.asarray(gy))
    xt, wt = _t(x), _t(w)
    y = KA.GroupedGemm.apply(xt, wt, torch.from_numpy(counts))
    y.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wx), **F32)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ww), **F32)
    assert not xt.grad[0].any() and not xt.grad[1, 9:].any()


def test_combine_gather_reduce_vjp_matches_jax():
    """``combine_gather_reduce_bwd``, the transpose the EP combine's backward
    runs: the received rows' and the weights' gradients, rows naming each
    received row at most once (as the combine's maps do) with sentinels
    among them."""
    rng = np.random.default_rng(1)
    T, K, H = 10, 3, 16
    R = T * K + 4
    recv = rng.standard_normal((R, H)).astype(np.float32)
    rows = rng.permutation(R)[:T * K].reshape(T, K).astype(np.int32)
    rows[rng.random((T, K)) < 0.25] = R
    w = rng.random((T, K)).astype(np.float32)
    gy = rng.standard_normal((T, H)).astype(np.float32)
    _, vjp = jax.vjp(lambda r, ww: jref.combine_gather_reduce(r, jnp.asarray(rows), ww),
                     jnp.asarray(recv), jnp.asarray(w))
    wr, wwt = vjp(jnp.asarray(gy))
    d_recv, d_w = KO.combine_gather_reduce_bwd(*(torch.from_numpy(a)
                                                 for a in (recv, rows, w, gy)))
    np.testing.assert_allclose(d_recv.numpy(), np.asarray(wr), **F32)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(wwt), **F32)


@pytest.mark.parametrize("G,window", [(1, None), (2, None), (2, 70)])
def test_flash_attention_vjp_matches_sdpa_chunked(G, window):
    """The flash route's Function (plain forward with the row LSE, plain
    backward) and autograd of the plain ``flash_attention`` itself (it
    updates no tensor in place) against jax.vjp of the reference's
    ``_sdpa_chunked`` on [B, S, H, d], S 300 over chunks and tiles of 128."""
    rng = np.random.default_rng(2)
    B, S, Hkv, d = 2, 300, 2, 16
    q = rng.standard_normal((B, S, Hkv * G, d)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, d)).astype(np.float32)
    go = rng.standard_normal(q.shape).astype(np.float32)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: JATT._sdpa_chunked(a, b, c, None, scale, window,
                                                        chunk=128),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(go))]
    ts = [_t(a) for a in (q, k, v)]
    KA.flash_attention_bshd(*ts, scale=scale, window=window).backward(torch.from_numpy(go))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, **F32)
    ts2 = [_t(a) for a in (q, k, v)]
    out = ref.flash_attention(*(t.transpose(1, 2) for t in ts2), scale=scale, window=window)
    out.transpose(1, 2).backward(torch.from_numpy(go))
    for t, w in zip(ts2, want):
        np.testing.assert_allclose(t.grad.numpy(), w, **F32)


@pytest.mark.parametrize("axis", [None, "data"])
def test_local_comm_all_to_all_vjp_matches_jax(axis):
    """The exchange's backward against jax.vjp of jax.lax.all_to_all under
    shard_map: over the whole group of 4, and over the inner axis of a
    (pod 2, data 2) mesh."""
    rng = np.random.default_rng(3)
    axes = (("data", 4),) if axis is None else (("pod", 2), ("data", 2))
    names = tuple(a for a, _ in axes)
    nb = 4 if axis is None else 2
    x = rng.standard_normal((N, nb, 3, 5)).astype(np.float32)
    gy = rng.standard_normal((N, nb, 3, 5)).astype(np.float32)
    m = jax.make_mesh(tuple(s for _, s in axes), names,
                      axis_types=(jax.sharding.AxisType.Auto,) * len(axes),
                      devices=jax.devices()[:N])
    ax = names if axis is None else axis
    spec = P(names)

    def f(a):
        return jax.shard_map(lambda b: jax.lax.all_to_all(b[0], ax, 0, 0, tiled=False)[None],
                         mesh=m, in_specs=spec, out_specs=spec)(a)

    want_y, vjp = jax.vjp(f, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(gy))
    comm = LocalComm(N, axes=axes)
    xs = [_t(a) for a in x]
    ys = comm.all_to_all(xs, axis)
    np.testing.assert_array_equal(torch.stack(ys).detach().numpy(), np.asarray(want_y))
    torch.autograd.backward(ys, [torch.from_numpy(g) for g in gy])
    np.testing.assert_array_equal(np.stack([t.grad.numpy() for t in xs]), np.asarray(want))


def _cfgs(d_model=64, **moe):
    jcfg, tcfg = jax_smoke(), smoke_config()
    jcfg = dataclasses.replace(jcfg, d_model=d_model, dtype=jnp.float32,
                               moe=dataclasses.replace(jcfg.moe, **moe))
    tcfg = dataclasses.replace(tcfg, d_model=d_model, dtype=torch.float32,
                               moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


MODES = {"ht": dict(ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25),
         "ll": dict(ep_mode="ll", ll_layout="nccl_ep")}


def _rel_close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_moe_block_gradients_match_jax(mode):
    """jax.grad of sum(y · gy) + aux through the reference's MoE layer on 4
    fake devices against the port's over LocalComm(4): the tokens', the
    router's and the three expert weights' gradients within 1e-5 of each
    one's largest value (HT with capacity 1.25, so entries drop)."""
    jcfg, tcfg = _cfgs(**MODES[mode])
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(5), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tcfg, device="cpu")
    p_np = jax.tree.map(lambda a: a[0], tree["moe_stack"]["moe"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((N, 16, jcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    m = mesh4()

    def loss(p, xx):
        y, aux = jax_moe_block(p, xx, jcfg, m)
        return jnp.sum(y * gy) + aux

    wp, wx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p_np, jnp.asarray(x))
    p_t = {k: v[0].clone().requires_grad_() for k, v in params["moe_stack"]["moe"].items()}
    xt = _t(x)
    y, aux = moe_block(p_t, xt, tcfg, LocalComm(N))
    ((y * torch.from_numpy(gy)).sum() + aux).backward()
    _rel_close(xt.grad.numpy(), wx, 1e-5)
    for k in ("router", "w_gate", "w_up", "w_down"):
        _rel_close(p_t[k].grad.numpy(), wp[k], 1e-5)


def _lm_grads(tcfg, params, toks, comm):
    ps = {}
    for path, t in _leaves(params):
        ps[path] = t.requires_grad_()
    loss, _ = get_model(tcfg).forward(params, {"tokens": torch.from_numpy(toks)}, tcfg, comm)
    loss.backward()
    return loss, ps


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_parameter_gets_a_gradient(mode):
    """DBRX's smoke config over LocalComm(4): every floating parameter of
    lm_forward gets a nonzero gradient (the byte view of the local
    exchange used to cut the graph before the expert weights)."""
    _, tcfg = _cfgs(**MODES[mode])
    from repro_torch.weights import init_params
    params = init_params(tcfg, 0, "cpu")
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (N, 32)).astype(np.int32)
    _, ps = _lm_grads(tcfg, params, toks, LocalComm(N))
    for path, t in ps.items():
        assert t.grad is not None and t.grad.abs().sum() > 0, "/".join(path)


@pytest.mark.parametrize("S", [32, 2048])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_lm_value_and_grad_matches_jax(mode, S):
    """jax.value_and_grad of the reference's lm_forward on 4 fake devices
    against the port's over LocalComm(4), one row a rank: the loss within
    1e-5 and every parameter's gradient within 1e-4 of its largest value.
    At S 2048 the port's attention takes the flash route (plain forward and
    backward), JAX's ``_sdpa_chunked``."""
    jcfg, tcfg = _cfgs(**MODES[mode])
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(9), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, (N, S)).astype(np.int32)
    m = mesh4()
    jfwd = jax_get_model(jcfg).forward
    (wl, _), wg = jax.jit(jax.value_and_grad(lambda p: jfwd(p, {"tokens": jnp.asarray(toks)},
                                                             jcfg, m), has_aux=True))(tree)
    loss, ps = _lm_grads(tcfg, params, toks, LocalComm(N))
    np.testing.assert_allclose(loss.item(), float(wl), **F32)
    want = {tuple(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(wg)[0]}
    assert set(want) == set(ps)
    for path, t in ps.items():
        _rel_close(t.grad.numpy(), want[path], 1e-4)


def test_reference_fp8_gradient_is_degenerate():
    """Pins a fault of the reference (ROADMAP Queue C): JAX's AD through
    ``quantize_fp8`` / ``dequantize_fp8`` casts the cotangent to e4m3 with
    no scale, so a small cotangent flushes to zero (1016 of 1024 entries at
    1e-2) and a unit one comes back rounded to e4m3 at the size of the
    block's scale (below e4m3's smallest normal here, so more than 20%
    off), where the true gradient is exactly 1."""
    x = jnp.asarray(np.random.default_rng(11).standard_normal((4, 256)).astype(np.float32))

    def grad_at(c):
        return np.asarray(jax.grad(lambda a: jnp.sum(
            c * jref.dequantize_fp8(*jref.quantize_fp8(a, 128), jnp.float32)))(x))

    g = grad_at(1e-2)
    assert (g == 0).sum() == 1016
    g1 = grad_at(1.0)
    assert np.abs(g1 - 1.0).max() > 0.2


def test_fp8_dispatch_gradient_is_straight_through():
    """The port's gradient of an fp8 HT flat dispatch is the bf16
    dispatch's, bit for bit, on the same cotangent (the combine of the
    cotangent in bf16), while the forwards differ."""
    E, K, T, H = 8, 2, 32, 128
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((N, T, H)).astype(np.float32)).to(torch.bfloat16)
    topk = [torch.from_numpy(np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
                             .astype(np.int32)) for _ in range(N)]
    w = [torch.full((T, K), 0.5) for _ in range(N)]
    grads, outs = [], []
    for fp8 in (False, True):
        group = ep_create_group(EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H,
                                              top_k=K, mode="ht", quantize_dispatch=fp8),
                                LocalComm(N))
        handles = ep_create_handle(group, topk, w)
        xs = [a.clone().requires_grad_() for a in x]
        y = LL.ep_dispatch_autograd(group, handles, xs)
        g = torch.Generator().manual_seed(13)
        cot = [torch.randn(y3d.shape, generator=g).to(torch.bfloat16) for y3d, _ in y]
        torch.autograd.backward([y3d for y3d, _ in y], cot)
        grads.append([a.grad for a in xs])
        outs.append([y3d.detach() for y3d, _ in y])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert any(not torch.equal(a, b) for a, b in zip(*outs))
    assert all(g.dtype == torch.bfloat16 and g.abs().sum() > 0 for g in grads[0])


def test_ht_flat_combine_inverse_is_the_dispatch_recv_map():
    """HT flat's combine mirrors its dispatch slot for slot, so the inverse
    of ``comb_send_gmap`` that the combine's backward gathers through is
    ``disp_recv_gmap`` itself, with entries dropped at the pair capacity
    (1.25, routing skewed to expert 0)."""
    E, K, T, H = 8, 2, 32, 16
    rng = np.random.default_rng(14)
    p = np.ones(E)
    p[0] = 10.0
    p /= p.sum()
    topk = [torch.from_numpy(np.stack([rng.choice(E, K, replace=False, p=p) for _ in range(T)])
                             .astype(np.int32)) for _ in range(N)]
    group = ep_create_group(EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H,
                                          top_k=K, mode="ht", capacity_factor=1.25,
                                          expert_capacity_factor=1.25), LocalComm(N))
    handles = ep_create_handle(group, topk, [torch.full((T, K), 0.5)] * N)
    sentinels = 0
    for h in handles:
        inv = LL.comb_send_inverse(group, h.plan)
        assert torch.equal(inv, h.plan.disp_recv_gmap)
        sentinels += int((inv == h.plan.comb_send_gmap.numel()).sum())
    assert sentinels > 0
    # entries dropped at the pair capacity
    assert sum(int((h.plan.comb_recv_rows == N * group.ht_pair_cap).sum()) for h in handles)
