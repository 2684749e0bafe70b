"""The port's continuous-batching path against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages: the plain paged
decode attention (against JAX's plain version and its Pallas kernel in
interpret mode, GQA and the shared absorbed-MLA pool), the page allocator,
``write_token``, the scheduler's per-step inputs, the paged decode step's
logits on the DBRX smoke config over 8 EP ranks, and the continuous server's
per-request token streams. Attention and logits are held to 1e-5 in f32 (the
sums run in another order); data movement and token streams must be equal.
The kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.kernels import decode_attention as JDA
from repro.kernels import ref as JREF
from repro.models import get_model
from repro.models import kv_pages as JKVP
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro.runtime import scheduler as JSCHED
from repro.runtime.server import ContinuousDecodeServer as JaxContinuous
from repro.runtime.steps import paged_serve_state_specs
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import kv_pages as TKVP
from repro_torch.models.transformer import (init_decode_state,
                                            init_paged_decode_state,
                                            lm_decode_step, lm_paged_decode_step)
from repro_torch.runtime.scheduler import ContinuousScheduler, Request
from repro_torch.runtime.server import ContinuousDecodeServer
from repro_torch.weights import params_from_jax

N, SLOTS, MAX_LEN, PAGE = 8, 8, 32, 4
F32 = dict(rtol=1e-5, atol=1e-5)


def mesh():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


def f32_cfgs():
    return (dataclasses.replace(jax_smoke(), dtype=jnp.float32),
            dataclasses.replace(smoke_config(), dtype=torch.float32))


# --------------------------------------------------------------------------
# paged decode attention: plain version against JAX's plain and Pallas
# --------------------------------------------------------------------------

def paged_case(rng, *, B, Hkv, G, dk, dv, page, max_pages, lens, share_kv=False):
    """Random pools, shuffled page tables, garbage in every unreferenced page
    (the pad page included). Returns the arrays and the set of referenced
    pages."""
    P = B * max_pages
    k_pool = rng.standard_normal((P + 1, page, Hkv, dk)).astype(np.float32)
    v_pool = None if share_kv else rng.standard_normal((P + 1, page, Hkv, dv)).astype(np.float32)
    perm = rng.permutation(P)
    tbl = np.full((B, max_pages), P, np.int32)
    used = set()
    for b in range(B):
        n = TKVP.pages_for_tokens(int(lens[b]), page)
        tbl[b, :n] = perm[b * max_pages:b * max_pages + n]
        used.update(tbl[b, :n].tolist())
    q = rng.standard_normal((B, Hkv * G, dk)).astype(np.float32)
    return q, k_pool, v_pool, tbl, used


def redraw_unreferenced(rng, pool, used):
    """The pool with every page outside ``used`` drawn again."""
    out = pool.copy()
    for i in range(pool.shape[0]):
        if i not in used:
            out[i] = rng.standard_normal(pool.shape[1:]).astype(np.float32)
    return out


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("share_kv", [False, True], ids=["gqa", "share_kv"])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_plain_paged_attention_matches_jax(splits, share_kv):
    """Ragged last page, a full row, an idle row: the plain version within
    1e-5 of JAX's plain version and of its Pallas kernel in interpret mode,
    stage 1 included; idle rows exactly zero; the result bitwise unchanged
    when every unreferenced page is drawn again."""
    rng = np.random.default_rng(11 + splits + 10 * share_kv)
    if share_kv:                       # dk = r_kv 16 + rope 8, values r_kv
        B, Hkv, G, dk, dv, lens = 3, 1, 4, 24, 16, [7, 16, 0]
    else:
        B, Hkv, G, dk, dv, lens = 3, 2, 2, 16, 16, [10, 16, 0]
    page, max_pages = 4, 4
    lens = np.asarray(lens, np.int32)
    q, kp, vp, tbl, used = paged_case(rng, B=B, Hkv=Hkv, G=G, dk=dk, dv=dv,
                                      page=page, max_pages=max_pages, lens=lens,
                                      share_kv=share_kv)
    kw = dict(scale=dk ** -0.5, num_kv_splits=splits, dv=dv if share_kv else None)
    got = tops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, Hkv * G, dv)
    jargs = (_j(q), _j(kp), _j(vp), _j(tbl), _j(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(JREF.paged_decode_attention(*jargs, **kw)), **F32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JDA.paged_decode_attention(*jargs, **kw, interpret=True)), **F32)
    o, lse = tref.paged_decode_stage1(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens), **kw)
    jo, jlse = JREF.paged_decode_stage1(*jargs, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **F32)
    assert torch.all(got[2] == 0) and torch.all(o[2] == 0)
    assert torch.all(lse[2] == tref.NEG_INF)       # empty splits: exact values
    kp2 = redraw_unreferenced(rng, kp, used)
    vp2 = None if share_kv else redraw_unreferenced(rng, vp, used)
    again = tops.paged_decode_attention(_t(q), _t(kp2), _t(vp2), _t(tbl), _t(lens), **kw)
    assert torch.equal(again, got)
    assert tda.launches == 0                       # CPU tensors never reach the kernel


def test_kernel_wrapper_refuses_cpu_and_bad_splits():
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(5, 4, 2, 16)
    tbl = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.paged_decode_attention(q, pool, pool, tbl, lens, scale=1.0)
    with pytest.raises(ValueError, match="divide by the split"):
        tref.paged_decode_attention(q, pool, pool, tbl, lens, scale=1.0,
                                    num_kv_splits=2)


# --------------------------------------------------------------------------
# kv_pages: allocator and write_token
# --------------------------------------------------------------------------

def test_page_allocator_invariants_match_jax():
    """Same LIFO order as JAX's allocator; no live page handed out twice;
    exhaustion names the capacity and takes nothing; double free raises;
    the high-water mark survives frees."""
    a, ja = TKVP.PageAllocator(16, 4), JKVP.PageAllocator(16, 4)
    r1, r2, r3 = a.alloc(5), a.alloc(4), a.alloc(7)
    assert [r1, r2, r3] == [ja.alloc(5), ja.alloc(4), ja.alloc(7)]
    assert sorted(r1 + r2 + r3) == list(range(16)) and a.free_count == 0
    a.free(r2)
    ja.free(r2)
    r4 = a.alloc(4)
    assert r4 == ja.alloc(4) and not set(r4) & (set(r1) | set(r3))
    assert a.peak_live == 16 and a.pad_page == 16
    with pytest.raises(TKVP.PagePoolExhausted,
                       match=r"requested 1 page\(s\) with 0 free of 16 total \(page_size=4\)"):
        a.alloc(1)
    assert a.free_count == 0 and a.live_count == 16
    a.free([r4[0]])
    with pytest.raises(ValueError, match=f"page {r4[0]}"):
        a.free([r4[0]])
    with pytest.raises(ValueError, match="num_pages >= 1"):
        TKVP.PageAllocator(0, 4)
    for tokens, page in [(0, 4), (1, 4), (4, 4), (5, 4), (33, 16)]:
        assert TKVP.pages_for_tokens(tokens, page) == JKVP.pages_for_tokens(tokens, page)
    assert TKVP.dense_equiv_tokens(8, 32) == JKVP.dense_equiv_tokens(8, 32)


def test_write_token_bitwise_matches_jax():
    """Rows land at (tbl[len // page], len % page) in place, idle rows in
    the pad page; lengths past the table clamp to its last entry."""
    rng = np.random.default_rng(5)
    P, page, Hkv, d, B, mp = 15, 4, 2, 8, 5, 3
    pool = rng.standard_normal((P + 1, page, Hkv, d)).astype(np.float32)
    tbl = rng.permutation(P)[:B * mp].reshape(B, mp).astype(np.int32)
    tbl[3] = P                                       # idle: all pad
    lens = np.array([0, 5, 11, 0, 13], np.int32)     # 13 // 4 = 3: clamped
    new = rng.standard_normal((B, Hkv, d)).astype(np.float32)
    want = np.asarray(JKVP.write_token(jnp.asarray(pool), jnp.asarray(new),
                                       jnp.asarray(tbl), jnp.asarray(lens)))
    t_pool = torch.from_numpy(pool.copy())
    got = TKVP.write_token(t_pool, torch.from_numpy(new), torch.from_numpy(tbl),
                           torch.from_numpy(lens))
    assert got is t_pool
    np.testing.assert_array_equal(got.numpy(), want)
    cfg = smoke_config()
    spec = TKVP.paged_kv_pool_spec(cfg, 10, 4)
    jspec = JKVP.paged_kv_pool_spec(jax_smoke(), 10, 4)
    assert spec["k"].shape == jspec["k"].shape == spec["v"].shape


# --------------------------------------------------------------------------
# scheduler: the same per-step inputs as JAX's
# --------------------------------------------------------------------------

def _requests(cls):
    return [cls(0, np.array([3, 5, 7], np.int32), 6, arrival_step=0),
            cls(1, np.array([11, 2], np.int32), 8, arrival_step=0),
            cls(2, np.array([9, 9, 9, 9, 1], np.int32), 5, arrival_step=4),
            cls(3, np.array([4], np.int32), 7, arrival_step=6),
            cls(4, np.array([6, 1, 1, 8, 2, 2], np.int32), 3, arrival_step=6)]


@pytest.mark.parametrize("slots,num_pages", [(3, 32), (2, 6)])
def test_scheduler_inputs_match_jax(slots, num_pages):
    """Fed the same requests and the same fake output tokens, the port's
    scheduler builds the same advance() arrays as JAX's at every step, with
    a roomy pool and with one tight enough to gate admission."""
    rng = np.random.default_rng(slots)
    ts = ContinuousScheduler(_requests(Request), slots, 8, TKVP.PageAllocator(num_pages, PAGE))
    js = JSCHED.ContinuousScheduler(_requests(JSCHED.Request), slots, 8,
                                    JKVP.PageAllocator(num_pages, PAGE))
    step = 0
    while not js.done:
        assert not ts.done
        got, want = ts.advance(step, now=float(step)), js.advance(step, now=float(step))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} at step {step}")
            assert got[k].dtype == np.int32
        out = rng.integers(0, 256, (slots, 1)).astype(np.int32)
        assert ts.observe(out, now=step + 0.5) == js.observe(out, now=step + 0.5)
        step += 1
    assert ts.done and sorted(ts.finished) == sorted(js.finished) == [0, 1, 2, 3, 4]
    for rid in js.finished:
        np.testing.assert_array_equal(ts.tokens_for(rid), js.tokens_for(rid))
        assert ts.request_metrics(rid) == js.request_metrics(rid)
    assert ts.alloc.live_count == 0 and ts._reserved == 0
    assert ts.alloc.peak_live == js.alloc.peak_live <= num_pages
    with pytest.raises(ValueError, match="request 7: needs 3 pages"):
        ContinuousScheduler([Request(7, np.arange(9), 4)], 1, 8, TKVP.PageAllocator(2, 4))


# --------------------------------------------------------------------------
# the paged step and the continuous server over 8 EP ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shared():
    """One f32 JAX parameter tree (numpy), the port's copy, and the JAX
    continuous server's per-request streams on it (JAX compiles once)."""
    jcfg, tcfg = f32_cfgs()
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(0), jax_lm_spec(jcfg)))
    jsrv = JaxContinuous(jcfg, batch=SLOTS, max_len=MAX_LEN, mesh=mesh(),
                         page_size=PAGE, params=tree)
    try:
        jm = jsrv.serve_requests(_requests(JSCHED.Request))
        streams = {rid: jsrv.reqsched.tokens_for(rid) for rid in jsrv.reqsched.finished}
    finally:
        jsrv.close()
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, jax_metrics=jm, jax_streams=streams,
                params=params_from_jax(tree, tcfg, device="cpu"))


def test_paged_step_logits_match_jax(shared):
    """Teacher-forced paged steps with staggered lengths, an idle row and a
    shuffled table: logits within 1e-5 of JAX's paged step on the 8-device
    mesh, and of the port's dense step for the rows that hold the same
    tokens."""
    jcfg, tcfg, tree, params = shared["jcfg"], shared["tcfg"], shared["tree"], shared["params"]
    B, T, mp = SLOTS, 5, 2
    P = B * mp
    m = mesh()
    model = get_model(jcfg)
    st_spec, _ = paged_serve_state_specs(jcfg, B, P, PAGE, mp)
    jstate = jax.tree.map(jnp.zeros_like, init_from_specs(jax.random.PRNGKey(1), st_spec, m))
    jstep = jax.jit(lambda p, s, b: model.paged_decode_step(p, s, b, jcfg, m))
    state = init_paged_decode_state(tcfg, P, PAGE, torch.device("cpu"))
    dense = init_decode_state(tcfg, B, MAX_LEN, torch.device("cpu"))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    tbl = rng.permutation(P).reshape(B, mp).astype(np.int32)
    tbl[5] = P                                        # row 5 idle throughout
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


def test_continuous_server_matches_jax_and_solo(shared):
    """Staggered requests joining and leaving: each per-request stream
    equals JAX's, and is bitwise equal to the request run alone through a
    fresh engine; every page and reservation comes back."""
    tcfg, params = shared["tcfg"], shared["params"]
    srv = ContinuousDecodeServer(tcfg, SLOTS, MAX_LEN, ep_size=N, params=params,
                                 device="cpu", page_size=PAGE)
    m = srv.serve_requests(_requests(Request))
    sched = srv.reqsched
    streams = {rid: sched.tokens_for(rid) for rid in sched.finished}
    assert streams.keys() == shared["jax_streams"].keys()
    for rid, want in shared["jax_streams"].items():
        np.testing.assert_array_equal(streams[rid], want)
    jm = shared["jax_metrics"]
    assert (m.requests_completed, m.serve_steps, m.pages_peak, m.pages_dense_equiv,
            m.total_tokens) == (jm.requests_completed, jm.serve_steps, jm.pages_peak,
                                jm.pages_dense_equiv, jm.total_tokens)
    assert m.pages_peak <= m.pages_dense_equiv and len(m.per_request) == 5
    # recovery_latency_s is None without a fault recovery, as the reference's
    assert all(np.isfinite(v) for k, v in m.as_dict().items()
               if k.endswith("_s") and k != "recovery_latency_s")
    assert m.recovery_latency_s is None and m.recovery_count == 0
    assert sched.done and sched.alloc.live_count == 0 and sched._reserved == 0
    assert np.all(sched._tbl == sched.alloc.pad_page) and not sched._active.any()
    for r in _requests(Request):
        if r.rid not in (2, 3):                      # the two that joined mid-stream
            continue
        solo = ContinuousDecodeServer(tcfg, SLOTS, MAX_LEN, ep_size=N, params=params,
                                      device="cpu", page_size=PAGE)
        solo.serve_requests([Request(r.rid, r.prompt, r.max_new_tokens)])
        np.testing.assert_array_equal(solo.reqsched.tokens_for(r.rid), streams[r.rid])


def test_continuous_server_refusals():
    """The JAX constructor's checks, and the paged layer's."""
    cfg = smoke_config()
    with pytest.raises(ValueError, match="kv_chunk"):
        ContinuousDecodeServer(cfg, 8, 16, device="cpu", page_size=3)
    capped = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.5))
    with pytest.raises(ValueError, match="zero-drop"):
        ContinuousDecodeServer(capped, 8, 16, device="cpu", page_size=4)
    windowed = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, window=8))
    with pytest.raises(NotImplementedError, match="non-windowed"):
        ContinuousDecodeServer(windowed, 8, 16, device="cpu", page_size=4)
    with pytest.raises(ValueError, match="depth-1"):
        ContinuousDecodeServer(cfg, 8, 16, device="cpu", page_size=4, pipeline_depth=2)
    srv = ContinuousDecodeServer(cfg, 8, 20, device="cpu", page_size=4)
    assert srv.max_pages == 8 and srv.num_pages == 64   # 5 pages rounded to 4 splits
    with pytest.raises(NotImplementedError, match="step_feed"):
        srv.serve(np.zeros((8, 2), np.int32), 2)        # the dense-only entry points
    capped_soft = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, logit_softcap=30.0))
    soft = ContinuousDecodeServer(capped_soft, 8, 16, device="cpu", page_size=4)
    with pytest.raises(NotImplementedError, match="softcap"):
        soft.serve_requests([Request(0, np.array([1]), 1)])
