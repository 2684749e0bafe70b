"""The dense ``lm`` configs in the port against the JAX package, on the CPU:
ChatGLM3-6B (partial RoPE, GQA 16:1 at full width), InternLM2-20B (GQA,
rope base 1e6) and MiniCPM3-4B (MLA at 40 heads, tied embeddings).

For each: the config copy at every shape, the parameter bridge, the
training forward's loss, teacher-forced dense and paged decode logits, both
servers' token streams, and the capture guard on both serve steps. Inputs
are numpy arrays from a seed fed to both packages; one JAX-initialised tree
is carried over with ``params_from_jax``. f32 within 1e-5; parameters and
token streams exactly. MiniCPM3's forward is held with the reference's MLA
on its chunked branch (``tests/test_torch_mla.py`` says why).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JATT
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import get_model as jax_get_model
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro.runtime import scheduler as JSCHED
from repro.runtime.server import ContinuousDecodeServer as JaxContinuous
from repro.runtime.server import DecodeServer as JaxServer
from repro.runtime.steps import paged_serve_state_specs, serve_state_specs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models import get_model
from repro_torch.models.transformer import (init_decode_state, init_paged_decode_state,
                                            lm_decode_step, lm_paged_decode_step, lm_spec)
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
from repro_torch.weights import _leaves, init_params, params_from_jax
from test_torch_decode import guarded

ARCHS = ["chatglm3-6b", "internlm2-20b", "minicpm3-4b"]
SHAPES = [None, "train_4k", "prefill_32k", "decode_32k", "smoke"]
F32 = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def cfgs(arch):
    """The f32 smoke configs of both packages."""
    return (dataclasses.replace(jax_get_smoke(arch), dtype=jnp.float32),
            dataclasses.replace(get_smoke(arch), dtype=torch.float32))


@pytest.fixture(scope="module", params=ARCHS)
def shared(request):
    """(arch, JAX config, port config, the JAX tree as numpy, its port copy)."""
    jcfg, tcfg = cfgs(request.param)
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(0), jax_lm_spec(jcfg)))
    return request.param, jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture
def jax_chunked(monkeypatch):
    monkeypatch.setattr(JATT, "CHUNKED_ATTN_THRESHOLD", 1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_copy_of_jax(arch, shape):
    jcfg = jax_get_smoke(arch) if shape == "smoke" else jax_get_config(arch, shape)
    tcfg = get_smoke(arch) if shape == "smoke" else get_config(arch, shape)
    assert arch in ARCH_IDS and tcfg.moe is None
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "dtype":
            assert b == torch.bfloat16 and a == jnp.bfloat16
        elif dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert tcfg.padded_heads() == jcfg.padded_heads()
    assert tcfg.padded_vocab() == jcfg.padded_vocab()


def test_params_from_jax_round_trips(shared):
    """Every leaf bitwise, the same names as the port's spec, and
    ``init_params`` drawing the same tree shape."""
    arch, jcfg, tcfg, tree, params = shared
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == len(list(_leaves(lm_spec(tcfg))))
    for path, leaf in leaves:
        t = params
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    drawn = init_params(tcfg, 0, "cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in _leaves(drawn)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in _leaves(params)]
    assert ("lm_head" in params) == (not tcfg.tie_embeddings)


def test_lm_forward_matches_jax(shared, jax_chunked):
    """The training forward's loss within 1e-5 of JAX's, with a loss mask."""
    arch, jcfg, tcfg, tree, params = shared
    rng = np.random.default_rng(11)
    batch = dict(tokens=rng.integers(0, jcfg.vocab, (4, 24)).astype(np.int32))
    batch["loss_mask"] = (rng.random((4, 24)) > 0.2).astype(np.float32)
    jfwd = jax_get_model(jcfg).forward
    want, waux = jax.jit(lambda p, b: jfwd(p, b, jcfg, None))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    got, gaux = get_model(tcfg).forward(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                        tcfg, None)
    np.testing.assert_allclose(float(got), float(want), **F32)
    assert float(gaux["aux"]) == float(waux["aux"]) == 0.0


def test_decode_logits_match_jax(shared):
    """Teacher-forced dense decode steps: logits within 1e-5 of JAX's."""
    arch, jcfg, tcfg, tree, params = shared
    B, S_max, T = 4, 8, 5
    st_spec, _ = serve_state_specs(jcfg, B, S_max)
    jstate = jax.tree.map(jnp.zeros_like, init_from_specs(jax.random.PRNGKey(1), st_spec, None))
    model = jax_get_model(jcfg)
    jstep = jax.jit(lambda p, s, b: model.decode_step(p, s, b, jcfg, None))
    state = init_decode_state(tcfg, B, S_max, CPU)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    for i in range(T):
        want, jstate = jstep(tree, jstate, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        got, state = lm_decode_step(params, state, {"tokens": torch.from_numpy(toks[:, i:i + 1])},
                                    tcfg, None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert int(state["dense"].length) == T


def test_paged_decode_logits_match_jax(shared):
    """Teacher-forced paged steps, staggered lengths, an idle row and a
    shuffled table: logits within 1e-5 of JAX's, and of the port's dense
    step for the live rows."""
    arch, jcfg, tcfg, tree, params = shared
    B, T, mp, page = 6, 5, 2, 4
    P = B * mp
    model = jax_get_model(jcfg)
    st_spec, _ = paged_serve_state_specs(jcfg, B, P, page, mp)
    jstate = jax.tree.map(jnp.zeros_like, init_from_specs(jax.random.PRNGKey(1), st_spec, None))
    jstep = jax.jit(lambda p, s, b: model.paged_decode_step(p, s, b, jcfg, None))
    state = init_paged_decode_state(tcfg, P, page, CPU)
    dense = init_decode_state(tcfg, B, 8, CPU)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    tbl = rng.permutation(P).reshape(B, mp).astype(np.int32)
    tbl[4] = P
    active = np.ones(B, np.int32)
    active[4] = 0
    for t in range(T):
        lens = np.full(B, t, np.int32)
        lens[4] = 0
        feed = dict(tokens=toks[:, t:t + 1], page_tbl=tbl, kv_lens=lens, active=active)
        want, jstate = jstep(tree, jstate, {k: jnp.asarray(v) for k, v in feed.items()})
        got, state = lm_paged_decode_step(params, state,
                                          {k: torch.from_numpy(v) for k, v in feed.items()},
                                          tcfg, None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        dl, dense = lm_decode_step(params, dense, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                   tcfg, None)
        live = active == 1
        np.testing.assert_allclose(got.numpy()[live], dl.numpy()[live], **F32)


def _requests(cls, vocab):
    rng = np.random.default_rng(5)
    return [cls(i, rng.integers(0, vocab, int(rng.integers(2, 6))), int(rng.integers(2, 6)),
                arrival_step=a) for i, a in enumerate([0, 0, 1, 3, 4, 4])]


def test_decode_server_matches_jax(shared):
    """DecodeServer's token stream equal to the JAX server's."""
    arch, jcfg, tcfg, tree, params = shared
    prompts = np.random.default_rng(2).integers(0, jcfg.vocab, (4, 4)).astype(np.int32)
    jsrv = JaxServer(jcfg, batch=4, max_len=16, params=tree)
    try:
        first, _ = jsrv.prefill(jnp.asarray(prompts))
        want, _ = jsrv.decode(first, 6)
    finally:
        jsrv.close()
    srv = DecodeServer(tcfg, 4, 16, params=params, device="cpu")
    got, itls = srv.decode(srv.prefill(prompts)[0], 6)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 7) and len(itls) == 6


def test_continuous_server_matches_jax(shared):
    """ContinuousDecodeServer: every request's stream, the step count and
    the pages' high-water mark equal JAX's."""
    arch, jcfg, tcfg, tree, params = shared
    jc = JaxContinuous(jcfg, batch=4, max_len=16, page_size=4, params=tree)
    try:
        jm = jc.serve_requests(_requests(JSCHED.Request, jcfg.vocab))
        streams = {rid: jc.reqsched.tokens_for(rid) for rid in jc.reqsched.finished}
    finally:
        jc.close()
    csrv = ContinuousDecodeServer(tcfg, 4, 16, params=params, device="cpu", page_size=4)
    cm = csrv.serve_requests(_requests(Request, jcfg.vocab))
    assert cm.requests_completed == jm.requests_completed == 6
    assert (cm.serve_steps, cm.pages_peak) == (jm.serve_steps, jm.pages_peak)
    assert streams.keys() == set(range(6))
    for rid, toks in streams.items():
        np.testing.assert_array_equal(csrv.reqsched.tokens_for(rid), toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_have_no_host_sync(arch):
    """Both serve steps in bf16 hold nothing a CUDA graph capture cannot:
    no host read-back, no tensor from host data; state written in place."""
    cfg = get_smoke(arch)
    srv = DecodeServer(cfg, batch=4, max_len=8, device="cpu")
    tok = srv.step(torch.zeros((4, 1), dtype=torch.int32))       # the warm-up step
    state = srv.state
    guard = guarded(srv)
    tok = srv.step(tok)
    assert guard.bad == [], f"host syncs inside the {arch} step: {guard.bad}"
    assert srv.state is state and tok.shape == (4, 1) and tok.dtype == torch.int32
    csrv = ContinuousDecodeServer(cfg, batch=4, max_len=8, device="cpu", page_size=4)
    mp = csrv.max_pages
    feed = dict(tokens=np.zeros((4, 1), np.int32),
                page_tbl=np.arange(4 * mp, dtype=np.int32).reshape(4, mp),
                kv_lens=np.full(4, 3, np.int32), active=np.ones(4, np.int32))
    pools = [t for v in csrv.state.values() for t in v.values()]
    csrv.step_feed(feed)                                            # the warm-up step
    guard = guarded(csrv)
    got = csrv.step_feed(feed)
    assert guard.bad == [], f"host syncs inside the {arch} paged step: {guard.bad}"
    assert [t for v in csrv.state.values() for t in v.values()] == pools
    assert got.shape == (4, 1)
