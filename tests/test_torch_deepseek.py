"""The DeepSeek-V3 family in the port against the JAX package, on the CPU:
the config copy, the sigmoid group-limited router with a selection bias,
the parameter bridge (MLA heads padded 4 -> 16, the selection bias, the
shared expert, the dense prefix, the MTP leaves), the MoE layer with its
shared expert, ``lm_forward`` with MLA and MTP, the dense and paged decode
steps, both servers' token streams (LL ``nccl_ep`` with fp8 dispatch) and
the capture guard on DeepSeek serve steps.

Inputs are numpy arrays from a seed, fed to both packages; one
JAX-initialised parameter tree, its selection biases redrawn nonzero, is
carried over with ``params_from_jax``. Tolerances: f32 within 1e-5,
router weights within 1e-6, indices, parameters and token streams exactly.
The forward is held with the reference's MLA on its chunked branch at every
S (``tests/test_torch_mla.py`` says why).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JATT
from repro.configs.deepseek_v3_671b import full_config as jax_full
from repro.configs.deepseek_v3_671b import smoke_config as jax_smoke
from repro.core.routing import RouterConfig as JRouterConfig
from repro.core.routing import route as jax_route
from repro.models import get_model as jax_get_model
from repro.models.moe import _moe_dense_fallback as jax_dense
from repro.models.moe import moe_block as jax_moe_block
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro.runtime import scheduler as JSCHED
from repro.runtime.server import ContinuousDecodeServer as JaxContinuous
from repro.runtime.server import DecodeServer as JaxServer
from repro.runtime.steps import paged_serve_state_specs, serve_state_specs
from repro_torch.comm import LocalComm
from repro_torch.configs.deepseek_v3_671b import full_config, smoke_config
from repro_torch.core.routing import RouterConfig, route
from repro_torch.models import get_model
from repro_torch.models.mla import MLACache
from repro_torch.models.moe import _moe_dense_fallback, moe_block
from repro_torch.models.transformer import (init_decode_state, init_paged_decode_state,
                                            lm_decode_step, lm_paged_decode_step, lm_spec)
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
from repro_torch.weights import _leaves, params_from_jax
from test_torch_decode import guarded

N = 8
F32 = dict(rtol=1e-5, atol=1e-5)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# the serve variant: LL nccl_ep with fp8 dispatch, as the decode_32k preset,
# at a d_model the fp8 block of 128 divides
SERVE_MOE = dict(ep_mode="ll", ll_layout="nccl_ep", quantize_dispatch=True,
                 expert_capacity_factor=2.0)


def cfgs(dtype=torch.float32, d_model=None, **moe):
    jcfg, tcfg = jax_smoke(), smoke_config()
    kw = dict(d_model=d_model) if d_model else {}
    jcfg = dataclasses.replace(jcfg, dtype=JDT[dtype], moe=dataclasses.replace(jcfg.moe, **moe),
                               **kw)
    tcfg = dataclasses.replace(tcfg, dtype=dtype, moe=dataclasses.replace(tcfg.moe, **moe), **kw)
    return jcfg, tcfg


def mesh(n=N):
    return jax.make_mesh((n,), ("data",), axis_types=(jax.sharding.AxisType.Auto,),
                         devices=jax.devices()[:n])


def jax_tree(jcfg, seed=0):
    """A JAX parameter tree as numpy, every selection bias redrawn nonzero
    (its initializer is zeros)."""
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(seed), jax_lm_spec(jcfg)))
    rng = np.random.default_rng(seed + 100)
    for path, leaf in _leaves(tree):
        if path[-1] == "sel_bias":
            sub = tree
            for k in path[:-1]:
                sub = sub[k]
            sub["sel_bias"] = (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return tree


@pytest.fixture(scope="module")
def shared():
    """The f32 smoke tree (numpy) and the port's copy of it."""
    jcfg, tcfg = cfgs()
    tree = jax_tree(jcfg)
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture
def jax_chunked(monkeypatch):
    monkeypatch.setattr(JATT, "CHUNKED_ATTN_THRESHOLD", 1)


@pytest.mark.parametrize("shape", [None, "train_4k", "decode_32k", "smoke"])
def test_config_is_a_copy_of_jax(shape):
    jcfg = jax_smoke() if shape == "smoke" else jax_full(shape)
    tcfg = smoke_config() if shape == "smoke" else full_config(shape)
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "dtype":
            assert b == torch.bfloat16 and a == jnp.bfloat16
        elif dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert tcfg.padded_heads() == jcfg.padded_heads()


ROUTES = {
    "e256-top8-groups": dict(num_experts=256, top_k=8, gating="sigmoid", n_groups=8,
                             topk_groups=4, use_selection_bias=True,
                             routed_scaling_factor=2.5),
    "e64-top6-sigmoid": dict(num_experts=64, top_k=6, gating="sigmoid", n_groups=4,
                             topk_groups=2, use_selection_bias=True),
    "e64-top6-softmax": dict(num_experts=64, top_k=6),
    "e256-top8-no-bias": dict(num_experts=256, top_k=8, gating="sigmoid", n_groups=8,
                              topk_groups=4, routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_matches_jax(case):
    """route against JAX's on 96 tokens: indices equal, weights within 1e-6,
    the aux and z losses within 1e-6 relative."""
    kw = dict(ROUTES[case], aux_loss_weight=1e-3, z_loss_weight=1e-4)
    E = kw["num_experts"]
    rng = np.random.default_rng(len(case))
    logits = rng.standard_normal((96, E)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(E)).astype(np.float32)

    def jroute(lg, b):
        r = jax_route(lg, JRouterConfig(**kw), b)
        return r.topk_idx, r.topk_weights, r.aux_loss, r.z_loss
    w_idx, w_w, w_aux, w_z = jax.jit(jroute)(jnp.asarray(logits), jnp.asarray(bias))
    got = route(torch.from_numpy(logits), RouterConfig(**kw), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.topk_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(got.topk_weights.numpy(), np.asarray(w_w), rtol=1e-6, atol=1e-6)
    for a, b in ((got.aux_loss, w_aux), (got.z_loss, w_z)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-9)
    if kw.get("n_groups", 1) > 1:                          # every pick in a kept group
        per = E // kw["n_groups"]
        groups = got.topk_idx.numpy() // per
        assert all(len(set(g)) <= kw["topk_groups"] for g in groups)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_params_from_jax_deepseek_tree(dtype):
    """Every leaf of the DeepSeek smoke tree bitwise, the MLA heads padded
    from 4 to 16, and the leaves only DeepSeek has."""
    jcfg, tcfg = cfgs(dtype)
    tree = jax_tree(jcfg, seed=3)
    params = params_from_jax(tree, tcfg, device="cpu")
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == len(list(_leaves(lm_spec(tcfg))))
    paths = set()
    for path, leaf in leaves:
        t = params
        for k in path:
            t = t[k.key]
        paths.add("/".join(k.key for k in path))
        want = np.asarray(leaf)
        assert tuple(t.shape) == want.shape
        bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}[want.itemsize]
        np.testing.assert_array_equal(t.view(bits[0]).numpy(), want.view(bits[1]))
    for p in ("dense_stack/ffn/w_gate", "moe_stack/moe/sel_bias", "moe_stack/moe/shared/w_up",
              "mtp_layer/moe/router", "mtp_layer/attn/wkv_a", "mtp_proj", "mtp_ln",
              "dense_stack/attn/wq_b", "moe_stack/attn/wo"):
        assert p in paths, p
    assert params["dense_stack"]["attn"]["wq_b"].shape == (1, 32, 16, 24)   # 4 -> 16 heads
    assert params["moe_stack"]["attn"]["wo"].shape == (2, 16, 16, jcfg.d_model)
    assert params["moe_stack"]["moe"]["sel_bias"].abs().sum() > 0


def test_moe_block_matches_jax(shared):
    """One DeepSeek MoE layer (sigmoid group-limited routing with a nonzero
    selection bias, 1 shared expert) over LocalComm(8) against JAX on the
    8-device mesh, and against the dense fallback."""
    jcfg, tcfg, tree, params = shared
    p_np = jax.tree.map(lambda a: a[0], tree["moe_stack"]["moe"])
    p_t = {k: (v[0] if not isinstance(v, dict) else {a: b[0] for a, b in v.items()})
           for k, v in params["moe_stack"]["moe"].items()}
    x = np.random.default_rng(0).standard_normal((16, 2, jcfg.d_model)).astype(np.float32)
    m = mesh()
    want, want_aux = jax.jit(lambda p, x: jax_moe_block(p, x, jcfg, m))(p_np, jnp.asarray(x))
    got, aux = moe_block(p_t, torch.from_numpy(x), tcfg, LocalComm(N))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(aux.item(), float(want_aux), **F32)
    dense = _moe_dense_fallback(p_t, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jax_dense(p_np, jnp.asarray(x), jcfg)),
                               **F32)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **F32)


@pytest.mark.parametrize("ep", [0, 4], ids=["no-comm", "localcomm-4"])
def test_lm_forward_matches_jax(shared, jax_chunked, ep):
    """lm_forward on the smoke config (MLA, MTP, first_k_dense 1, a shared
    expert): with no communicator against JAX with no mesh, and over
    LocalComm(4) against a 4-device mesh. Loss and aux within 1e-5."""
    jcfg, tcfg, tree, params = shared
    rng = np.random.default_rng(11)
    batch = dict(tokens=rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32))
    batch["loss_mask"] = (rng.random((4, 16)) > 0.2).astype(np.float32)
    jfwd = jax_get_model(jcfg).forward
    m = mesh(ep) if ep else None
    want, waux = jax.jit(lambda p, b: jfwd(p, b, jcfg, m))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    got, gaux = get_model(tcfg).forward(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                        tcfg, LocalComm(ep) if ep else None)
    np.testing.assert_allclose(float(got), float(want), **F32)
    np.testing.assert_allclose(float(gaux["aux"]), float(waux["aux"]), **F32)
    if ep:
        assert float(gaux["aux"]) > 0             # the MoE and MTP layers' router losses


def test_mtp_term_is_in_the_loss(shared, jax_chunked):
    """With mtp off the loss drops the 0.3-weighted MTP term (and its
    layer's aux): both packages move by the same amount."""
    jcfg, tcfg, tree, params = shared
    toks = np.random.default_rng(12).integers(0, jcfg.vocab, (4, 8)).astype(np.int32)
    losses = []
    for mtp in (True, False):
        j, t = dataclasses.replace(jcfg, mtp=mtp), dataclasses.replace(tcfg, mtp=mtp)
        jt = tree if mtp else {k: v for k, v in tree.items() if not k.startswith("mtp")}
        pt = params if mtp else {k: v for k, v in params.items() if not k.startswith("mtp")}
        want, _ = jax_get_model(j).forward(jt, {"tokens": jnp.asarray(toks)}, j, None)
        got, _ = get_model(t).forward(pt, {"tokens": torch.from_numpy(toks)}, t, None)
        np.testing.assert_allclose(float(got), float(want), **F32)
        losses.append(float(got))
    assert losses[0] > losses[1]


def test_decode_logits_match_jax(shared):
    """Teacher-forced dense decode steps (absorbed MLA over MLACaches) over
    LocalComm(8): logits within 1e-5 of JAX's step on the 8-device mesh."""
    jcfg, tcfg, tree, params = shared
    B, S_max = 16, 8
    m = mesh()
    st_spec, _ = serve_state_specs(jcfg, B, S_max)
    jstate = jax.tree.map(jnp.zeros_like, init_from_specs(jax.random.PRNGKey(1), st_spec, m))
    model = jax_get_model(jcfg)
    jstep = jax.jit(lambda p, s, b: model.decode_step(p, s, b, jcfg, m))
    state = init_decode_state(tcfg, B, S_max, torch.device("cpu"))
    assert all(isinstance(c, MLACache) for c in state.values())
    assert state["dense"].ckv.shape == (1, B, S_max, 16) and state["moe"].krope.shape[0] == 2
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, 5)).astype(np.int32)
    comm = LocalComm(N)
    for i in range(5):
        want, jstate = jstep(tree, jstate, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        got, state = lm_decode_step(params, state, {"tokens": torch.from_numpy(toks[:, i:i + 1])},
                                    tcfg, comm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert int(state["moe"].length) == int(state["dense"].length) == 5


def test_paged_decode_logits_match_jax(shared):
    """Teacher-forced paged steps over the MLA pools, staggered lengths, an
    idle row and a shuffled table: logits within 1e-5 of JAX's, and of the
    port's dense step for the rows that hold the same tokens."""
    jcfg, tcfg, tree, params = shared
    B, T, mp, page = 8, 5, 2, 4
    P = B * mp
    m = mesh()
    model = jax_get_model(jcfg)
    st_spec, _ = paged_serve_state_specs(jcfg, B, P, page, mp)
    jstate = jax.tree.map(jnp.zeros_like, init_from_specs(jax.random.PRNGKey(1), st_spec, m))
    jstep = jax.jit(lambda p, s, b: model.paged_decode_step(p, s, b, jcfg, m))
    state = init_paged_decode_state(tcfg, P, page, torch.device("cpu"))
    assert state["moe"]["kv"].shape == (2, P + 1, page, 1, 16 + 8)
    dense = init_decode_state(tcfg, B, 8, torch.device("cpu"))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    tbl = rng.permutation(P).reshape(B, mp).astype(np.int32)
    tbl[5] = P
    active = np.ones(B, np.int32)
    active[5] = 0
    comm = LocalComm(N)
    for t in range(T):
        lens = np.full(B, t, np.int32)
        lens[5] = 0
        feed = dict(tokens=toks[:, t:t + 1], page_tbl=tbl, kv_lens=lens, active=active)
        want, jstate = jstep(tree, jstate, {k: jnp.asarray(v) for k, v in feed.items()})
        got, state = lm_paged_decode_step(params, state,
                                          {k: torch.from_numpy(v) for k, v in feed.items()},
                                          tcfg, comm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        dl, dense = lm_decode_step(params, dense, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                   tcfg, comm)
        live = active == 1
        np.testing.assert_allclose(got.numpy()[live], dl.numpy()[live], **F32)


def _requests(cls, vocab):
    rng = np.random.default_rng(5)
    return [cls(i, rng.integers(0, vocab, int(rng.integers(2, 6))), int(rng.integers(2, 6)),
                arrival_step=a) for i, a in enumerate([0, 0, 1, 3, 4])]


@pytest.fixture(scope="module")
def serve_tree():
    """The f32 smoke tree at d_model 128 in the serve variant."""
    jcfg, tcfg = cfgs(d_model=128, **SERVE_MOE)
    tree = jax_tree(jcfg, seed=2)
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def test_decode_server_matches_jax_nccl_ep_fp8(serve_tree):
    """DecodeServer on the smoke config at d_model 128 in LL nccl_ep with
    fp8 dispatch, f32, over LocalComm(8) against the JAX server on the
    8-device mesh: token streams equal."""
    jcfg, tcfg, tree, params = serve_tree
    prompts = np.random.default_rng(2).integers(0, jcfg.vocab, (16, 4)).astype(np.int32)
    jsrv = JaxServer(jcfg, batch=16, max_len=16, mesh=mesh(), params=tree)
    try:
        first, _ = jsrv.prefill(jnp.asarray(prompts))
        want, _ = jsrv.decode(first, 6)
    finally:
        jsrv.close()
    srv = DecodeServer(tcfg, 16, 16, ep_size=N, params=params, device="cpu")
    got, itls = srv.decode(srv.prefill(prompts)[0], 6)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (16, 7) and len(itls) == 6


def test_continuous_server_matches_jax_nccl_ep_fp8(serve_tree):
    """ContinuousDecodeServer likewise over the MLA page pools, requests
    joining and leaving: every request's stream and the step count equal
    JAX's."""
    jcfg, tcfg, tree, params = serve_tree
    jc = JaxContinuous(jcfg, batch=8, max_len=16, mesh=mesh(), page_size=4, params=tree)
    try:
        jm = jc.serve_requests(_requests(JSCHED.Request, jcfg.vocab))
        streams = {rid: jc.reqsched.tokens_for(rid) for rid in jc.reqsched.finished}
    finally:
        jc.close()
    csrv = ContinuousDecodeServer(tcfg, 8, 16, ep_size=N, params=params, device="cpu",
                                  page_size=4)
    cm = csrv.serve_requests(_requests(Request, jcfg.vocab))
    assert cm.requests_completed == jm.requests_completed == 5
    assert (cm.serve_steps, cm.pages_peak) == (jm.serve_steps, jm.pages_peak)
    assert streams.keys() == set(range(5))
    for rid, toks in streams.items():
        np.testing.assert_array_equal(csrv.reqsched.tokens_for(rid), toks)


def guard_config():
    return cfgs(torch.bfloat16, d_model=128, **SERVE_MOE)[1]


def test_decode_step_has_no_host_sync():
    """A DeepSeek serve step (MLA's absorbed dense-cache decode, nccl_ep
    with fp8) holds nothing a CUDA graph capture cannot: no host read-back,
    no tensor from host data. The caches are written in place."""
    srv = DecodeServer(guard_config(), batch=8, max_len=8, ep_size=N, device="cpu")
    tok = srv.step(torch.zeros((8, 1), dtype=torch.int32))     # the warm-up step
    state = srv.state
    leaves = [t for c in state.values() for t in (c.ckv, c.krope, c.length)]
    guard = guarded(srv)
    tok = srv.step(tok)
    assert guard.bad == [], f"host syncs inside the DeepSeek step: {guard.bad}"
    assert srv.state is state
    assert all(a is b for a, b in zip(leaves, [t for c in srv.state.values()
                                               for t in (c.ckv, c.krope, c.length)]))
    for c in srv.state.values():
        assert isinstance(c, MLACache) and c.length.dim() == 0 and int(c.length) == 2
    assert tok.shape == (8, 1) and tok.dtype == torch.int32


def test_paged_step_has_no_host_sync():
    """The DeepSeek paged step (the shared MLA pool, B6's shared-pool mode)
    under the same guard."""
    srv = ContinuousDecodeServer(guard_config(), batch=8, max_len=8, ep_size=N,
                                 device="cpu", page_size=4)
    mp = srv.max_pages
    feed = dict(tokens=np.zeros((8, 1), np.int32),
                page_tbl=np.arange(8 * mp, dtype=np.int32).reshape(8, mp),
                kv_lens=np.full(8, 3, np.int32), active=np.ones(8, np.int32))
    pools = [t for v in srv.state.values() for t in v.values()]
    want = srv.step_feed(feed).clone()                          # the warm-up step
    guard = guarded(srv)
    got = srv.step_feed(feed)
    assert guard.bad == [], f"host syncs inside the DeepSeek paged step: {guard.bad}"
    assert [t for v in srv.state.values() for t in v.values()] == pools
    assert set(srv.state["moe"]) == {"kv"} and got.shape == want.shape == (8, 1)
