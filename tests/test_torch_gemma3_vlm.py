"""The ``gemma3`` and ``vlm`` families in the port against the JAX package,
on the CPU: Gemma3-27B's and Phi-3-vision-4.2B's smoke configs in f32.

Gemma3: the config copy at every shape, the nested ``super`` / ``tail``
tree through ``params_from_jax``, ``gemma3_forward``'s loss at S 16 (the
windows of 8 cross) and at S 2048 (the flash route's plain version,
windowed and causal) and its gradients against ``jax.value_and_grad``,
teacher-forced ``gemma3_decode_step`` logits over 24 steps (the rings of 8
rows wrap twice), both packages' ``DecodeServer`` streams, the
``ContinuousDecodeServer`` refusal and the capture guard on the serve
step. Phi-3-vision: ``lm_forward`` with and without ``img_embeds`` and its
gradient (``img_embeds`` among the inputs), both servers' streams and the
capture guard on both steps. Inputs are numpy arrays from a seed fed to
both packages; one JAX-initialised tree a config, carried over with
``params_from_jax``. Losses and logits within 1e-5; gradients within 1e-5
of each one's largest value; parameters and token streams exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import get_model as jax_get_model
from repro.parallel.sharding import init_from_specs
from repro.runtime import scheduler as JSCHED
from repro.runtime.server import ContinuousDecodeServer as JaxContinuous
from repro.runtime.server import DecodeServer as JaxServer
from repro.runtime.steps import serve_state_specs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models import get_model
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import _ring_mask, gemma3_decode_step, init_decode_state
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.weights import _leaves, init_params, params_from_jax
from test_torch_decode import guarded

G3, VLM = "gemma3-27b", "phi-3-vision-4.2b"
SHAPES = [None, "train_4k", "prefill_32k", "decode_32k", "smoke"]
F32 = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def cfgs(arch, **kw):
    """The f32 smoke configs of both packages."""
    return (dataclasses.replace(jax_get_smoke(arch), dtype=jnp.float32, **kw),
            dataclasses.replace(get_smoke(arch), dtype=torch.float32, **kw))


def _load(arch):
    """(arch, JAX config, port config, the JAX tree as numpy, its port copy)."""
    jcfg, tcfg = cfgs(arch)
    spec = jax_get_model(jcfg).params_spec(jcfg)
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(0), spec))
    return arch, jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def g3():
    return _load(G3)[1:]


@pytest.fixture(scope="module")
def vlm():
    return _load(VLM)[1:]


@pytest.fixture(params=[G3, VLM])
def shared(request):
    return (request.param,) + request.getfixturevalue("g3" if request.param == G3 else "vlm")


def named(tree) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel_close(got, want, rel, what):
    """The worst entry within ``rel`` of the largest."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", [G3, VLM])
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
    """Every leaf bitwise under the same names (gemma3's nested [n_super,
    per, ...] super-block stack and its tail), the port's spec the same
    leaves, and ``init_params`` drawing the same tree shape."""
    arch, jcfg, tcfg, tree, params = shared
    want = named(tree)
    got = dict(_leaves(params))
    assert set(got) == set(want) == {p for p, _ in _leaves(get_model(tcfg).params_spec(tcfg))}
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path].numpy(), leaf)
    if arch == G3:
        assert params["super"]["ln1"].shape == (2, 3, 64)
        assert params["tail"]["attn"]["wq"].shape == (2, 64, 16, 16)
    drawn = init_params(tcfg, 0, "cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in _leaves(drawn)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in _leaves(params)]


def _tracked(params):
    """({path: leaf}, the tree of those leaves): copies that require grad."""
    ps = {path: t.detach().clone().requires_grad_() for path, t in _leaves(params)}
    tree: dict = {}
    for path, t in ps.items():
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = t
    return ps, tree


def _batch(cfg, rows, seq, seed, img=False):
    rng = np.random.default_rng(seed)
    batch = dict(tokens=rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32))
    batch["loss_mask"] = (rng.random((rows, seq)) > 0.2).astype(np.float32)
    if img:
        batch["img_embeds"] = rng.standard_normal(
            (rows, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("rows,seq", [(4, 16), (1, 2048)], ids=["S16", "S2048"])
def test_gemma3_forward_matches_jax(g3, rows, seq):
    """The loss within 1e-5 of JAX's: at S 16 every local layer's window of
    8 cuts keys; at S 2048 the port's local and global layers take the
    flash route (its plain version on the CPU), JAX's its chunked
    attention."""
    jcfg, tcfg, tree, params = g3
    batch = _batch(jcfg, rows, seq, 11)
    jfwd = jax_get_model(jcfg).forward
    want, _ = jax.jit(lambda p, b: jfwd(p, b, jcfg, None))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = get_model(tcfg).forward(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                       tcfg, None)
    np.testing.assert_allclose(float(got), float(want), **F32)
    assert aux == {}


@pytest.mark.parametrize("remat", [False, True])
def test_gemma3_value_and_grad_matches_jax(g3, remat):
    """jax.value_and_grad of the reference's gemma3_forward against the
    port's at S 16, with and without per-layer remat: the loss within 1e-5,
    every gradient's worst entry within 1e-5 of its largest."""
    jcfg, tcfg, tree, params = g3
    tcfg = dataclasses.replace(tcfg, remat=remat)
    batch = _batch(jcfg, 4, 16, 12)
    jfwd = jax_get_model(jcfg).forward
    (wl, _), wg = jax.jit(jax.value_and_grad(lambda p, b: jfwd(p, b, jcfg, None),
                                             has_aux=True))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    ps, tracked = _tracked(params)
    loss, _ = get_model(tcfg).forward(tracked, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      tcfg, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(wl), **F32)
    want = named(wg)
    assert set(want) == set(ps)
    for path, t in ps.items():
        rel_close(t.grad.numpy(), want[path], 1e-5, "/".join(path))


# f32 noise of the 8-layer smoke model's decode logits after 24 steps,
# measured on the CPU: JAX's jitted step against its own eager step up to
# 1.1e-5 of the largest logit, the port's f32 step against its float64 run
# up to 1.65e-5, the port against JAX's jitted step up to 2.1e-5; it grows
# with the steps (4e-7 at the first)
DECODE_REL = 5e-5


def test_gemma3_decode_logits_match_jax(g3):
    """Teacher-forced decode steps over 24 tokens: the local layers' rings
    of 8 rows wrap twice; at every step the logits within DECODE_REL of the
    largest of JAX's (the first 8 steps, before a ring wraps, within 1e-5),
    every stack's length advanced in place."""
    jcfg, tcfg, tree, params = g3
    B, S_max, T = 2, 32, 24
    st_spec, _ = serve_state_specs(jcfg, B, S_max)
    jstate = jax.tree.map(jnp.zeros_like, init_from_specs(jax.random.PRNGKey(1), st_spec, None))
    model = jax_get_model(jcfg)
    jstep = jax.jit(lambda p, s, b: model.decode_step(p, s, b, jcfg, None))
    state = init_decode_state(tcfg, B, S_max, CPU)
    assert state["local"].k.shape == (2, 2, B, 8, 2, 16)
    assert state["globl"].k.shape == (2, 1, B, S_max, 2, 16)
    assert state["tail"].k.shape == (2, B, 8, 2, 16)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    for i in range(T):
        want, jstate = jstep(tree, jstate, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        got, state = gemma3_decode_step(params, state,
                                        {"tokens": torch.from_numpy(toks[:, i:i + 1])}, tcfg,
                                        None)
        rel_close(got.numpy(), want, 1e-5 if i < 8 else DECODE_REL, f"step {i}")
    assert all(isinstance(c, KVCache) and int(c.length) == T for c in state.values())


def test_gemma3_ring_decode_takes_no_qk_norm(g3):
    """The reference's ring decode (``_ring_local_decode``) applies no
    qk-norm, though its forward does in the same local layers; the port
    keeps that. Doubling the local layers' q_norm and k_norm moves the
    forward's loss in both packages and leaves both decode steps' logits
    bitwise as they were."""
    jcfg, tcfg, tree, params = g3
    loc = jcfg.local_global[0]

    def scaled(tree):
        """A copy with the local layers' q_norm and k_norm doubled."""
        out = {k: dict(v) for k, v in tree.items() if isinstance(v, dict)}
        out.update({k: v for k, v in tree.items() if not isinstance(v, dict)})
        for stack, sl in (("super", (slice(None), slice(0, loc))), ("tail", slice(None))):
            attn = out[stack]["attn"] = dict(out[stack]["attn"])
            for n in ("q_norm", "k_norm"):
                a = attn[n].clone() if isinstance(attn[n], torch.Tensor) else np.array(attn[n])
                a[sl] = 2 * a[sl]
                attn[n] = a
        return out
    jtree2, params2 = scaled(tree), scaled(params)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 10)).astype(np.int32)
    model = jax_get_model(jcfg)
    jfwd = jax.jit(lambda p, b: model.forward(p, b, jcfg, None))
    jstep = jax.jit(lambda p, s, b: model.decode_step(p, s, b, jcfg, None))
    st_spec, _ = serve_state_specs(jcfg, 2, 16)
    outs = []
    for jt, pt in ((tree, params), (jtree2, params2)):
        jl, _ = jfwd(jt, {"tokens": jnp.asarray(toks)})
        tl, _ = get_model(tcfg).forward(pt, {"tokens": torch.from_numpy(toks)}, tcfg, None)
        jstate = jax.tree.map(jnp.zeros_like,
                              init_from_specs(jax.random.PRNGKey(1), st_spec, None))
        state = init_decode_state(tcfg, 2, 16, CPU)
        jlog, tlog = [], []
        for i in range(10):
            w, jstate = jstep(jt, jstate, {"tokens": jnp.asarray(toks[:, i:i + 1])})
            g, state = gemma3_decode_step(pt, state, {"tokens": torch.from_numpy(toks[:, i:i + 1])},
                                          tcfg, None)
            jlog.append(np.asarray(w))
            tlog.append(g.numpy())
        outs.append((float(jl), float(tl), np.stack(jlog), np.stack(tlog)))
    (jl0, tl0, jd0, td0), (jl1, tl1, jd1, td1) = outs
    assert abs(jl1 - jl0) > 1e-3 and abs(tl1 - tl0) > 1e-3
    np.testing.assert_array_equal(jd1, jd0)
    np.testing.assert_array_equal(td1, td0)


@pytest.mark.parametrize("wlen", [1, 8, 1024])
def test_ring_mask_keeps_exactly_the_window(wlen):
    """At every position from 0 to past the third wrap, the ring rows the
    mask keeps hold the positions a linear cache's window keeps, pos -
    wlen + 1 to pos (from 0 before the ring fills), each once, and each
    kept row is its position modulo wlen."""
    for p in range(3 * wlen + 2):
        k_pos, mask = _ring_mask(torch.tensor(p, dtype=torch.int32), wlen)
        live = k_pos[mask]
        assert live.sort().values.tolist() == list(range(max(0, p - wlen + 1), p + 1)), p
        assert (torch.remainder(live, wlen) == torch.arange(wlen)[mask]).all(), p


def _serve_jax(jcfg, tree, prompts, steps):
    jsrv = JaxServer(jcfg, batch=prompts.shape[0], max_len=24, params=tree)
    try:
        first, _ = jsrv.prefill(jnp.asarray(prompts))
        want, _ = jsrv.decode(first, steps)
    finally:
        jsrv.close()
    return want


def test_decode_server_matches_jax(shared):
    """DecodeServer's token stream equal to the JAX server's: for gemma3 4
    prompt tokens and 16 new ones, past the rings' 8 rows."""
    arch, jcfg, tcfg, tree, params = shared
    prompts = np.random.default_rng(2).integers(0, jcfg.vocab, (4, 4)).astype(np.int32)
    want = _serve_jax(jcfg, tree, prompts, 16)
    srv = DecodeServer(tcfg, 4, 24, params=params, device="cpu")
    got, itls = srv.decode(srv.prefill(prompts)[0], 16)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 17) and len(itls) == 16


def test_continuous_server_refuses_gemma3():
    """As the reference does: gemma3 has no paged decode path."""
    for srv in (JaxContinuous, ContinuousDecodeServer):
        cfg = (jax_get_smoke if srv is JaxContinuous else get_smoke)(G3)
        kw = {} if srv is JaxContinuous else dict(device="cpu")
        with pytest.raises(NotImplementedError, match="no paged decode path"):
            srv(cfg, batch=2, max_len=16, page_size=4, **kw)


def _requests(cls, vocab):
    rng = np.random.default_rng(5)
    return [cls(i, rng.integers(0, vocab, int(rng.integers(2, 6))), int(rng.integers(2, 6)),
                arrival_step=a) for i, a in enumerate([0, 0, 1, 3, 4, 4])]


def test_vlm_continuous_server_matches_jax(vlm):
    """Phi-3-vision's ContinuousDecodeServer: every request's stream, the
    step count and the pages' high-water mark equal JAX's."""
    jcfg, tcfg, tree, params = vlm
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


@pytest.mark.parametrize("img", [False, True], ids=["tokens", "img_embeds"])
def test_vlm_forward_matches_jax(vlm, img):
    """lm_forward on a vlm config, with the first 8 positions' embeddings
    replaced by img_embeds and without: the loss within 1e-5 of JAX's, the
    two losses apart."""
    jcfg, tcfg, tree, params = vlm
    batch = _batch(jcfg, 4, 16, 13, img=True)
    if not img:
        del batch["img_embeds"]
    jfwd = jax_get_model(jcfg).forward
    want, _ = jax.jit(lambda p, b: jfwd(p, b, jcfg, None))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    fwd = get_model(tcfg).forward
    got, _ = fwd(params, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg, None)
    np.testing.assert_allclose(float(got), float(want), **F32)
    other = dict(batch, img_embeds=np.zeros((4, 8, 64), np.float32)) if img else \
        _batch(jcfg, 4, 16, 13, img=True)
    moved, _ = fwd(params, {k: torch.from_numpy(v) for k, v in other.items()}, tcfg, None)
    assert abs(float(moved) - float(got)) > 1e-4


def test_vlm_value_and_grad_matches_jax(vlm):
    """jax.value_and_grad of the reference's lm_forward in (params,
    img_embeds) against the port's: the loss within 1e-5, every gradient's
    worst entry within 1e-5 of its largest, img_embeds' included."""
    jcfg, tcfg, tree, params = vlm
    batch = _batch(jcfg, 4, 16, 14, img=True)
    img = batch.pop("img_embeds")
    jfwd = jax_get_model(jcfg).forward

    def jloss(p, e, b):
        return jfwd(p, dict(b, img_embeds=e), jcfg, None)
    (wl, _), (wg, we) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        tree, jnp.asarray(img), {k: jnp.asarray(v) for k, v in batch.items()})
    ps, tracked = _tracked(params)
    e = torch.from_numpy(img).requires_grad_()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = get_model(tcfg).forward(tracked, dict(tb, img_embeds=e), tcfg, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(wl), **F32)
    rel_close(e.grad.numpy(), we, 1e-5, "img_embeds")
    want = named(wg)
    for path, t in ps.items():
        rel_close(t.grad.numpy(), want[path], 1e-5, "/".join(path))


@pytest.mark.parametrize("arch", [G3, VLM])
def test_serve_steps_have_no_host_sync(arch):
    """The serve steps in bf16 (gemma3's ring writes and masks among them;
    Phi-3-vision's dense and paged steps) hold nothing a CUDA graph
    capture cannot: no host read-back, no tensor from host data; the state
    written in place, every length advanced."""
    cfg = get_smoke(arch)
    srv = DecodeServer(cfg, batch=4, max_len=12, device="cpu")
    tok = torch.zeros((4, 1), dtype=torch.int32)
    for _ in range(9):                                  # the warm-up steps, past a ring
        tok = srv.step(tok)
    state = srv.state
    leaves = [t for c in state.values() for t in (c.k, c.v, c.length)]
    guard = guarded(srv)
    tok = srv.step(tok)
    assert guard.bad == [], f"host syncs inside the {arch} step: {guard.bad}"
    assert srv.state is state and tok.shape == (4, 1) and tok.dtype == torch.int32
    assert all(a is b for a, b in zip(leaves, [t for c in srv.state.values()
                                               for t in (c.k, c.v, c.length)]))
    assert all(int(c.length) == 10 for c in srv.state.values())
    if arch == G3:
        return
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


@pytest.mark.parametrize("arch", [G3, VLM])
def test_trainer_takes_the_family(arch):
    """The Trainer on each smoke config in f32, one step of 2 x 16 tokens
    on the CPU: the loss and gradient norm finite, every parameter moved
    from its drawn value."""
    _, tcfg = cfgs(arch, microbatch=2)
    tr = Trainer(tcfg, TrainerConfig(steps=1, global_batch=2, seq_len=16, log_every=1),
                 opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=1), device="cpu")
    drawn = dict(_leaves(tr.init_state()[0]))
    params, _ = tr.run()
    assert len(tr.metrics_log) == 1
    assert np.isfinite([r["loss"] for r in tr.metrics_log]).all()
    assert np.isfinite([r["gnorm"] for r in tr.metrics_log]).all()
    moved = dict(_leaves(params))
    assert moved.keys() == drawn.keys()
    assert [p for p, t in drawn.items() if torch.equal(moved[p], t)] == []
