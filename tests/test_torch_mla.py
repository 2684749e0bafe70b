"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's, f32 on the CPU, on the DeepSeek-V3 smoke config
(4 heads padded to 16, all 16 computed) with one JAX-initialised layer
carried over as numpy. Tolerance 1e-5; the specs' shapes and the page
pool's untouched rows exactly.

The reference's short-sequence branch (S < 2048) masks with the transpose of
the causal mask, so a query attends to the keys at and after its position;
the port's is causal. Its forward is held against the reference's chunked
branch, which is causal, taken at every S by lowering
``repro.models.attention.CHUNKED_ATTN_THRESHOLD`` (``mla_attention`` reads
it at each call); ``test_reference_short_branch_mask_is_pinned`` pins the
reference's mask.
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
from repro.models import kv_pages as JKVP
from repro.models import mla as JMLA
from repro.parallel.sharding import init_from_specs
from repro_torch.configs.deepseek_v3_671b import full_config, smoke_config
from repro_torch.models import kv_pages as TKVP
from repro_torch.models import mla as TMLA

F32 = dict(rtol=1e-5, atol=1e-5)


def cfgs(**attn):
    jcfg = dataclasses.replace(jax_smoke(), dtype=jnp.float32)
    tcfg = dataclasses.replace(smoke_config(), dtype=torch.float32)
    if attn:
        jcfg = dataclasses.replace(jcfg, attn=dataclasses.replace(jcfg.attn, **attn))
        tcfg = dataclasses.replace(tcfg, attn=dataclasses.replace(tcfg.attn, **attn))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def layer():
    """One f32 MLA layer's parameters, as numpy and as the port's tensors."""
    jcfg, _ = cfgs()
    p = jax.device_get(init_from_specs(jax.random.PRNGKey(4), JMLA.mla_spec(jcfg)))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.fixture
def jax_chunked(monkeypatch):
    """The reference's mla_attention takes its chunked branch at every S."""
    monkeypatch.setattr(JATT, "CHUNKED_ATTN_THRESHOLD", 1)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("which", ["smoke", "decode_32k", "train_4k"])
def test_specs_match_jax(which):
    """mla_spec, mla_cache_spec and paged_mla_pool_spec: the same leaves,
    shapes and initializers as the reference's (heads padded to 16)."""
    if which == "smoke":
        jcfg, tcfg = jax_smoke(), smoke_config()
    else:
        jcfg, tcfg = jax_full(which), full_config(which)
    js, ts = JMLA.mla_spec(jcfg), TMLA.mla_spec(tcfg)
    assert js.keys() == ts.keys()
    for k in js:
        assert ts[k].shape == js[k].shape and ts[k].init == js[k].init, k
    assert ts["wq_b"].shape[1] == tcfg.padded_heads() == 16 * -(-tcfg.attn.n_heads // 16)
    jc, tc = JMLA.mla_cache_spec(jcfg, 3, 40), TMLA.mla_cache_spec(tcfg, 3, 40)
    assert tc["ckv"].shape == jc.ckv.shape and tc["krope"].shape == jc.krope.shape
    jp, tp = JKVP.paged_mla_pool_spec(jcfg, 10, 16), TKVP.paged_mla_pool_spec(tcfg, 10, 16)
    assert tp.keys() == jp.keys() == {"kv"} and tp["kv"].shape == jp["kv"].shape
    assert tp["kv"].init == "zeros" and tp["kv"].dtype == tcfg.dtype


@pytest.mark.parametrize("S,chunk", [(12, 1024), (2048 + 52, 512)],
                         ids=["short", "chunked-ragged"])
def test_mla_attention_no_cache_matches_jax(layer, jax_chunked, S, chunk):
    """Without a cache, at S < 2048 (the port's short branch) and at S >=
    2048 with a ragged tail (both chunked, 5 chunks of 512, the last 52
    tokens of 512)."""
    p_np, p_t = layer
    jcfg, tcfg = cfgs(kv_chunk=chunk)
    x = _x((2 if S < 100 else 1, S, jcfg.d_model), 1)
    want, _ = jax.jit(lambda p, x: JMLA.mla_attention(p, x, jcfg, None))(p_np, jnp.asarray(x))
    got, cache = TMLA.mla_attention(p_t, torch.from_numpy(x), tcfg)
    assert cache is None and got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_mla_chunked_branch_equals_short_branch(layer, monkeypatch):
    """The port's two branches compute one function: its chunked branch at
    S = 40 with chunks of 16 (a ragged tail of 8) against its short one."""
    _, p_t = layer
    _, tcfg = cfgs(kv_chunk=16)
    x = torch.from_numpy(_x((2, 40, tcfg.d_model), 2))
    short, _ = TMLA.mla_attention(p_t, x, tcfg)
    monkeypatch.setattr(TMLA, "CHUNKED_ATTN_THRESHOLD", 1)
    chunked, _ = TMLA.mla_attention(p_t, x, tcfg)
    np.testing.assert_allclose(chunked.numpy(), short.numpy(), **F32)


def test_reference_short_branch_mask_is_pinned(layer, monkeypatch):
    """The reference's short branch is anti-causal: its output at position 0
    moves when the last token changes, and it is far from its own chunked
    branch; the port's does neither. (ROADMAP Queue C; src/repro is not
    edited.)"""
    p_np, p_t = layer
    jcfg, tcfg = cfgs()
    x = _x((2, 8, jcfg.d_model), 3)
    x2 = x.copy()
    x2[:, -1] += 1.0
    run = jax.jit(lambda p, x: JMLA.mla_attention(p, x, jcfg, None)[0])
    short, short2 = np.asarray(run(p_np, jnp.asarray(x))), np.asarray(run(p_np, jnp.asarray(x2)))
    assert np.abs(short2[:, 0] - short[:, 0]).max() > 1e-2
    monkeypatch.setattr(JATT, "CHUNKED_ATTN_THRESHOLD", 1)
    chunked = np.asarray(jax.jit(lambda p, x: JMLA.mla_attention(p, x, jcfg, None)[0])(
        p_np, jnp.asarray(x)))
    assert np.linalg.norm(short - chunked) / np.linalg.norm(chunked) > 0.1
    got = TMLA.mla_attention(p_t, torch.from_numpy(x), tcfg)[0].numpy()
    got2 = TMLA.mla_attention(p_t, torch.from_numpy(x2), tcfg)[0].numpy()
    np.testing.assert_array_equal(got2[:, 0], got[:, 0])
    np.testing.assert_allclose(got, chunked, **F32)


@pytest.mark.parametrize("steps", [[1, 1, 1, 1], [3, 1, 1, 1, 1], [2, 1, 1, 1, 1, 1]],
                         ids=["tokens", "prefill-3", "past-s-max"])
def test_absorbed_decode_matches_jax(layer, steps):
    """The absorbed dense-cache decode over several steps: each step's
    output and the caches within 1e-5, the length a 0-dim int32 tensor
    advanced by the step's tokens. S_max 6: the last case writes past it,
    where the start clamps to S_max - S as dynamic_update_slice does."""
    p_np, p_t = layer
    jcfg, tcfg = cfgs()
    B, S_max = 3, 6
    m = jcfg.mla
    jc = JMLA.MLACache(ckv=jnp.zeros((B, S_max, m.kv_lora_rank)),
                       krope=jnp.zeros((B, S_max, m.qk_rope_dim)),
                       length=jnp.int32(0))
    spec = TMLA.mla_cache_spec(tcfg, B, S_max)
    tc = TMLA.MLACache(ckv=torch.zeros(spec["ckv"].shape), krope=torch.zeros(spec["krope"].shape),
                       length=torch.zeros((), dtype=torch.int32))
    ckv, krope = tc.ckv, tc.krope
    jstep = jax.jit(lambda p, x, c: JMLA.mla_attention(p, x, jcfg, None, cache=c))
    for i, s in enumerate(steps):
        x = _x((B, s, jcfg.d_model), 10 + i)
        want, jc = jstep(p_np, jnp.asarray(x), jc)
        got, tc = TMLA.mla_attention(p_t, torch.from_numpy(x), tcfg, cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        np.testing.assert_allclose(tc.ckv.numpy(), np.asarray(jc.ckv), **F32)
        np.testing.assert_allclose(tc.krope.numpy(), np.asarray(jc.krope), **F32)
        assert tc.ckv is ckv and tc.krope is krope                # written in place
        assert tc.length.dtype == torch.int32 and tc.length.dim() == 0
        assert int(tc.length) == int(jc.length) == sum(steps[:i + 1])


@pytest.mark.parametrize("splits", [1, 2])
def test_paged_mla_attention_matches_jax(layer, splits):
    """paged_mla_attention (B6's plain version in the shared-pool mode)
    with staggered lengths, an idle row and a shuffled table over a pool of
    garbage: the output within 1e-5, the written rows within 1e-5 at the
    reference's places, every other pool element bitwise unchanged."""
    p_np, p_t = layer
    jcfg, tcfg = cfgs()
    m = jcfg.mla
    B, page, mp = 5, 4, 4
    P = B * mp
    rng = np.random.default_rng(6)
    pool = rng.standard_normal((P + 1, page, 1, m.kv_lora_rank + m.qk_rope_dim)).astype(np.float32)
    tbl = rng.permutation(P).reshape(B, mp).astype(np.int32)
    lens = np.array([0, 3, 7, 12, 15], np.int32)
    active = np.array([1, 1, 1, 0, 1], np.int32)
    tbl[3] = P                                            # the idle row's table is all pad
    x = _x((B, 1, jcfg.d_model), 7)
    want, jpool = jax.jit(lambda p, x, pool, t, l, a: JMLA.paged_mla_attention(
        p, x, jcfg, None, pool, t, l, a, num_kv_splits=splits))(
        p_np, jnp.asarray(x), {"kv": jnp.asarray(pool)}, jnp.asarray(tbl),
        jnp.asarray(lens), jnp.asarray(active))
    tpool = {"kv": torch.from_numpy(pool.copy())}
    got, out_pool = TMLA.paged_mla_attention(
        p_t, torch.from_numpy(x), tcfg, tpool, torch.from_numpy(tbl), torch.from_numpy(lens),
        torch.from_numpy(active), num_kv_splits=splits)
    assert out_pool is tpool
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    jkv = np.asarray(jpool["kv"])
    written = np.zeros(pool.shape[:2], bool)
    for b in range(B):
        written[tbl[b, min(lens[b] // page, mp - 1)], lens[b] % page] = True
    np.testing.assert_allclose(tpool["kv"].numpy()[written], jkv[written], **F32)
    np.testing.assert_array_equal(tpool["kv"].numpy()[~written], jkv[~written])
    np.testing.assert_array_equal(jkv[~written], pool[~written])
