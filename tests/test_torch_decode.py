"""The port's steady-state decode against the JAX package, on the CPU.

* ``runtime/decode.py``: ``decode_loop`` (step 0 creates the handles, later
  steps refresh them, micro-batch pairs on the staged surface) must equal
  ``naive_decode_step`` bit for bit on the CPU, per micro-batch, and JAX's
  ``decode_loop`` within 2e-5 in f32, in every mode. The window includes a
  step that replays the step before it (the refresh's fast branch).
* ``DecodeServer(pipeline_depth=2)``: the same tokens as depth 1 and as
  JAX's pipelined server on the same weights, and ``steps - 1`` ITLs.
* The compiled step's cache: bounded to {current, previous} placements.
* The capture guard: one serve step of each server, in each EP layout, runs
  under a ``TorchDispatchMode`` that fails on any op that reads a device
  value back to the host or makes a tensor from host data (a CUDA graph
  capture cannot hold either): the step the servers capture on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.core.group import EpGroupConfig as JCfg
from repro.core.group import ep_create_group as j_create_group
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.parallel.sharding import init_from_specs
from repro.runtime.decode import decode_loop as j_decode_loop
from repro.runtime.server import DecodeServer as JaxServer
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.core import EpGroupConfig, RouterConfig, ep_create_group, route
from repro_torch.models.attention import KVCache
from repro_torch.runtime.decode import decode_loop, naive_decode_step
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
from repro_torch.runtime.steps import CompiledStep
from repro_torch.weights import params_from_jax

N, E, K, T, H = 8, 16, 4, 16, 32
STEPS = 4                        # decode_loop window; step 2 replays step 1
MODES = [("ll", "nccl_ep"), ("ll", "deepep"), ("ht", "nccl_ep"), ("baseline", "nccl_ep")]


def mesh():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


def window(seed):
    """[STEPS, 2, N, T, H] micro-batch pairs and a router weight [H, E].
    Step 1 changes the routing (the refresh rebuilds), step 2 repeats step
    1's inputs (the refresh keeps the cached maps), step 3 changes it again."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((STEPS, 2, N, T, H)).astype(np.float32)
    xs[2] = xs[1]
    return xs, rng.standard_normal((H, E)).astype(np.float32)


def jax_loop(mode, layout, xs, router_w):
    cfg = JCfg(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K, mode=mode,
               ll_layout=layout, payload_dtype=jnp.float32)
    group = j_create_group(cfg, ep_size=N)
    rw = jnp.asarray(router_w)

    def router_fn(x):
        w, idx = jax.lax.top_k(jax.nn.softmax(x @ rw, -1), K)
        return idx.astype(jnp.int32), w / w.sum(-1, keepdims=True)

    def expert_fn(y3d, counts):
        L = group.local_experts
        e_glob = jax.lax.axis_index("data") * L + jnp.arange(L)
        return y3d * (1.0 + e_glob)[:, None, None]

    def pipe(xs):
        seq = [(xs[s, 0, 0], xs[s, 1, 0]) for s in range(STEPS)]
        outs = j_decode_loop(group, router_fn, expert_fn, seq)
        return jnp.stack([jnp.stack([a, b]) for a, b in outs])[None]

    fn = jax.jit(jax.shard_map(pipe, mesh=mesh(), in_specs=(P(None, None, "data"),),
                               out_specs=P("data")))
    return np.asarray(fn(jnp.asarray(xs)))            # [N, STEPS, 2, T, H]


def torch_group(mode, layout, router_w):
    group = ep_create_group(EpGroupConfig(
        num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K, mode=mode,
        ll_layout=layout, payload_dtype=torch.float32), LocalComm(N))
    rw = torch.from_numpy(router_w)
    rcfg = RouterConfig(num_experts=E, top_k=K)

    def router_fn(x):
        r = route(x @ rw, rcfg)
        return r.topk_idx, r.topk_weights

    def expert_fn(rank, y3d, counts):
        L = group.local_experts
        return y3d * (1.0 + torch.arange(rank * L, (rank + 1) * L))[:, None, None]

    return group, router_fn, expert_fn


@pytest.mark.parametrize("mode,layout", MODES)
def test_decode_loop_matches_naive_and_jax(mode, layout):
    xs, router_w = window(0)
    group, router_fn, expert_fn = torch_group(mode, layout, router_w)
    pairs = [tuple([torch.from_numpy(r) for r in xs[s, m]] for m in range(2))
             for s in range(STEPS)]
    outs = decode_loop(group, router_fn, expert_fn, pairs)
    assert len(outs) == STEPS
    for s, (xa, xb) in enumerate(pairs):
        for got, x in zip(outs[s], (xa, xb)):
            want = naive_decode_step(group, router_fn, expert_fn, x)
            for g, w in zip(got, want):
                assert torch.equal(g, w), f"step {s}"
    got = np.stack([np.stack([np.stack([o.numpy() for o in mb]) for mb in pair])
                    for pair in outs])                 # [STEPS, 2, N, T, H]
    want = jax_loop(mode, layout, xs, router_w).transpose(1, 2, 0, 3, 4)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[2], got[1])      # the replayed step


def test_decode_loop_refreshes_after_step_zero(monkeypatch):
    """Step 0 builds the handles; every later step refreshes them."""
    from repro_torch.runtime import decode as dec
    xs, router_w = window(1)
    group, router_fn, expert_fn = torch_group("ll", "nccl_ep", router_w)
    calls = {"create": 0, "refresh": 0}
    create, refresh = dec._handle, dec.ep_handle_refresh

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(dec, "_handle", counting("create", create))
    monkeypatch.setattr(dec, "ep_handle_refresh", counting("refresh", refresh))
    pairs = [tuple([torch.from_numpy(r) for r in xs[s, m]] for m in range(2))
             for s in range(STEPS)]
    decode_loop(group, router_fn, expert_fn, pairs)
    assert calls == {"create": 2, "refresh": 2 * (STEPS - 1)}


# --------------------------------------------------------------------------
# the servers
# --------------------------------------------------------------------------

B, MAX_LEN = 16, 16


@pytest.fixture(scope="module")
def shared():
    """One f32 JAX parameter tree of the DBRX smoke config and the port's
    copy of it."""
    jcfg = dataclasses.replace(jax_smoke(), dtype=jnp.float32)
    tcfg = dataclasses.replace(smoke_config(), dtype=torch.float32)
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(0), jax_lm_spec(jcfg)))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def test_pipelined_server_matches_depth1_and_jax(shared):
    jcfg, tcfg, tree, params = shared
    steps = 6
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab, (B, 4)).astype(np.int32)
    jsrv = JaxServer(jcfg, batch=B, max_len=MAX_LEN, mesh=mesh(), params=tree,
                     pipeline_depth=2)
    try:
        first, _ = jsrv.prefill(jnp.asarray(prompts))
        want, _ = jsrv.decode(first, steps)
    finally:
        jsrv.close()
    got = {}
    for depth in (1, 2):
        srv = DecodeServer(tcfg, B, MAX_LEN, ep_size=N, params=params, device="cpu",
                           pipeline_depth=depth)
        first_t, _ = srv.prefill(prompts)
        got[depth], itls = srv.decode(first_t, steps)
        assert len(itls) == (steps if depth == 1 else steps - 1) and np.all(itls >= 0)
    np.testing.assert_array_equal(got[2], got[1])
    np.testing.assert_array_equal(got[2], want)
    m = DecodeServer(tcfg, B, MAX_LEN, ep_size=N, params=params, device="cpu",
                     pipeline_depth=2).serve(prompts, steps)
    assert m.total_tokens == B * (steps + 1) and m.output_tok_s > 0


def test_step_cache_bounded_to_two_placements():
    """Compiled steps are cached per placement and bounded to {current,
    previous}; a hit moves its entry to the end."""
    cfg = smoke_config()
    srv = DecodeServer(cfg, batch=8, max_len=8, device="cpu")
    first = srv._serve_step
    assert isinstance(first, CompiledStep) and list(srv._step_cache) == [None]
    for key in ("p1", "p2", "p3"):
        srv.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, placement=key))
        srv._serve_step = srv._compiled_step()
    assert list(srv._step_cache) == ["p2", "p3"]
    srv.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, placement="p2"))
    again = srv._compiled_step()
    assert again is srv._step_cache["p2"] and list(srv._step_cache) == ["p3", "p2"]
    srv.close()
    assert len(srv._step_cache) == 1


# --------------------------------------------------------------------------
# the capture guard
# --------------------------------------------------------------------------

class HostSyncGuard(TorchDispatchMode):
    """Records every op that a CUDA graph capture cannot hold: a read of a
    device value by the host (``.item()``, a mask's count for ``nonzero``,
    ``masked_select``, ``unique``, boolean-mask indexing, a
    ``repeat_interleave`` with tensor repeats) or a tensor made from host
    data (``torch.tensor``)."""

    NAMES = {"_local_scalar_dense", "nonzero", "nonzero_static", "masked_select",
             "lift_fresh", "lift_fresh_copy"}

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if (name in self.NAMES or name.lstrip("_").startswith("unique")
                or (name == "repeat_interleave" and "Tensor" in func._overloadname)
                or (name in ("index", "index_put", "index_put_", "_index_put_impl_")
                    and any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                            for i in (args[1] if len(args) > 1 else [])))):
            self.bad.append(str(func))
        return func(*args, **kwargs)


LAYOUTS = {"nccl_ep": {}, "deepep_fp8": dict(ll_layout="deepep", quantize_dispatch=True),
           "baseline": dict(ep_mode="baseline")}


def guard_config(layout):
    cfg = dataclasses.replace(smoke_config(), d_model=128)   # fp8 blocks of 128
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **LAYOUTS[layout]))


def guarded(srv):
    """Wrap the server's step so its body runs under a HostSyncGuard."""
    guard, inner = HostSyncGuard(), srv._serve_step

    def step(params, state, batch):
        with guard:
            return inner(params, state, batch)
    srv._serve_step = step
    return guard


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_step_has_no_host_sync(layout):
    srv = DecodeServer(guard_config(layout), batch=8, max_len=8, ep_size=N, device="cpu")
    tok = srv.step(torch.zeros((8, 1), dtype=torch.int32))   # the warm-up step
    state = srv.state
    leaves = [t for c in state.values() for t in (c.k, c.v, c.length)]
    guard = guarded(srv)
    tok = srv.step(tok)
    assert guard.bad == [], f"host syncs inside the {layout} step: {guard.bad}"
    # the state is written in place: the same tensors, the length advanced
    assert srv.state is state
    assert all(a is b for a, b in zip(leaves, [t for c in srv.state.values()
                                               for t in (c.k, c.v, c.length)]))
    for c in srv.state.values():
        assert isinstance(c, KVCache) and c.length.dtype == torch.int32
        assert c.length.dim() == 0 and int(c.length) == 2
    assert tok.shape == (8, 1) and tok.dtype == torch.int32


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_paged_step_has_no_host_sync(layout):
    srv = ContinuousDecodeServer(guard_config(layout), batch=8, max_len=8, ep_size=N,
                                 device="cpu", page_size=4)
    mp = srv.max_pages
    feed = dict(tokens=np.zeros((8, 1), np.int32),
                page_tbl=np.arange(8 * mp, dtype=np.int32).reshape(8, mp),
                kv_lens=np.full(8, 3, np.int32), active=np.ones(8, np.int32))
    want = srv.step_feed(feed).clone()                       # the warm-up step
    guard = guarded(srv)
    got = srv.step_feed(feed)
    assert guard.bad == [], f"host syncs inside the paged {layout} step: {guard.bad}"
    # the step's inputs are the server's own buffers, refilled in place
    assert torch.equal(srv._feed["page_tbl"], torch.from_numpy(feed["page_tbl"]))
    assert got.shape == want.shape == (8, 1)


def test_guard_catches_host_syncs():
    """The guard itself: each kind of op it must catch."""
    x = torch.arange(6)
    cases = [lambda: x.sum().item(), lambda: x[x > 2], lambda: torch.nonzero(x),
             lambda: torch.tensor([1.0, 2.0]), lambda: torch.unique(x),
             lambda: x.repeat_interleave(torch.ones(6, dtype=torch.long)),
             lambda: x.masked_select(x > 1)]
    for fn in cases:
        with HostSyncGuard() as g:
            fn()
        assert g.bad, fn
    idx = torch.arange(2)
    with HostSyncGuard() as g:
        x[idx]                                  # indexing by integers is fine
        (x > 2).float().sum()
    assert g.bad == []
