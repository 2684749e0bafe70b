"""The port's model stack and server against the JAX package, f32, on the
DBRX smoke config with 8 EP ranks (JAX: the ("data",) mesh of 8 fake CPU
devices; port: ``LocalComm(8)``), sharing one JAX-initialised parameter tree
carried over with ``params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.models import get_model
from repro.models.moe import moe_block as jax_moe_block
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro.runtime.server import DecodeServer as JaxServer
from repro.runtime.steps import serve_state_specs
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.models.attention import KVCache
from repro_torch.models.moe import _moe_dense_fallback, moe_block
from repro_torch.models.transformer import init_decode_state, lm_decode_step
from repro_torch.runtime.server import DecodeServer
from repro_torch.weights import params_from_jax

N, B, MAX_LEN = 8, 16, 16
F32 = dict(rtol=1e-5, atol=1e-5)


def cfgs(dtype="f32"):
    jcfg, tcfg = jax_smoke(), smoke_config()
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


def mesh():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


@pytest.fixture(scope="module")
def shared():
    """One f32 JAX parameter tree, as numpy, and the port's copy of it."""
    jcfg, tcfg = cfgs()
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(0), jax_lm_spec(jcfg)))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def test_params_from_jax_roundtrip():
    jcfg, tcfg = cfgs("bf16")
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(3), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tcfg, device="cpu")
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == 13
    for path, leaf in leaves:
        t = params
        for k in path:
            t = t[k.key]
        want = np.asarray(leaf)
        assert t.dtype == (torch.bfloat16 if want.dtype.name == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(t.view(torch.int16 if t.dtype == torch.bfloat16
                                             else torch.int32).numpy(),
                                      want.view(np.int16 if want.itemsize == 2 else np.int32))
    with pytest.raises(ValueError, match="trees differ"):
        params_from_jax({**tree, "extra": tree["ln_f"]}, tcfg, device="cpu")


def test_moe_block_matches_jax(shared):
    jcfg, tcfg, tree, params = shared
    p_np = jax.tree.map(lambda a: a[0], tree["moe_stack"]["moe"])
    p_t = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    x = np.random.default_rng(0).standard_normal((B, 2, jcfg.d_model)).astype(np.float32)
    m = mesh()
    want, want_aux = jax.jit(lambda p, x: jax_moe_block(p, x, jcfg, m))(p_np, jnp.asarray(x))
    got, aux = moe_block(p_t, torch.from_numpy(x), tcfg, LocalComm(N))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(aux.item(), float(want_aux), **F32)
    dense = _moe_dense_fallback(p_t, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **F32)


def test_decode_logits_match_jax(shared):
    jcfg, tcfg, tree, params = shared
    m = mesh()
    st_spec, _ = serve_state_specs(jcfg, B, MAX_LEN)
    jstate = jax.tree.map(jnp.zeros_like,
                          init_from_specs(jax.random.PRNGKey(1), st_spec, m))
    model = get_model(jcfg)
    jstep = jax.jit(lambda p, s, b: model.decode_step(p, s, b, jcfg, m))
    state = init_decode_state(tcfg, B, MAX_LEN, torch.device("cpu"))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, 4)).astype(np.int32)
    comm = LocalComm(N)
    for i in range(4):                            # teacher-forced steps
        want, jstate = jstep(tree, jstate, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        got, state = lm_decode_step(params, state,
                                    {"tokens": torch.from_numpy(toks[:, i:i + 1])},
                                    tcfg, comm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert isinstance(state["moe"], KVCache) and state["moe"].length == 4


def test_server_token_streams_match_jax(shared):
    jcfg, tcfg, tree, params = shared
    prompts = np.random.default_rng(2).integers(0, jcfg.vocab, (B, 4)).astype(np.int32)
    jsrv = JaxServer(jcfg, batch=B, max_len=MAX_LEN, mesh=mesh(), params=tree)
    try:
        first, _ = jsrv.prefill(jnp.asarray(prompts))
        want, _ = jsrv.decode(first, 4)
    finally:
        jsrv.close()
    srv = DecodeServer(tcfg, B, MAX_LEN, ep_size=N, params=params, device="cpu")
    first_t, _ = srv.prefill(prompts)
    got, itls = srv.decode(first_t, 4)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (B, 5) and len(itls) == 4
    metrics = DecodeServer(tcfg, B, MAX_LEN, ep_size=N, params=params,
                           device="cpu").serve(prompts, 4)
    assert metrics.total_tokens == B * 5 and metrics.output_tok_s > 0
