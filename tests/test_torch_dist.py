"""One EP rank per process: ``comm.DistComm`` over gloo on the CPU, against
``LocalComm`` and the JAX package.

Four worker processes are spawned once for the whole file (a ``file://``
rendezvous under ``tmp_path``, one thread each, a timeout on the process
group, its sub-groups and the join). Each worker runs every check as one
rank and returns what it computed as numpy arrays; rank 0 also runs every
check over ``LocalComm(4)``, hosting all four ranks in its process. The
parent holds each result against those, and against the JAX package's
``shard_map`` path on four fake CPU devices, which it runs while the
workers run. The workers import this module by name, so it
imports no JAX at its top: the JAX references are imported inside the
parent-side functions.

* The primitives over the group and each axis of a (pod 2, data 2) mesh:
  all-to-all and all-gather bitwise in bf16, f32, int32 and fp8, all-reduce
  within f32 rounding (int32 exactly).
* The EP API: LL ``nccl_ep`` and ``deepep`` (f32 and fp8), the baseline, HT
  flat (f32 and fp8), hierarchical HT over 2 pods of 2 at 1 and 2 chunks
  (f32, and fp8 at 2): every field, payload bytes included, bitwise against
  ``LocalComm``; in every mode and layout, fp8 in four, plan maps, counts,
  dispatch tensor and fp8 scales bitwise against JAX, the combined tokens
  within 1e-5; the chunks bitwise against each other;
  ``ep_handle_refresh`` bitwise against a fresh handle and ``LocalComm``.
* ``moe_block`` on DBRX's smoke config with expert-TP on (data 2, model 2),
  with EP over (data, model) (S split over model), and DeepSeek-V3's
  smoke config (sigmoid group-limited routing, fp8 ``nccl_ep``) on data 4:
  within 1e-5 (f32) of JAX's ``moe_block`` on the same mesh.
* ``DecodeServer(comm=DistComm)`` at depth 1 and 2: the token stream equal
  to ``LocalComm(4)``'s and to JAX's server on mesh 4; ``decode_loop``
  bitwise against the naive step and against ``LocalComm``'s loop;
  ``prefill_moe`` bitwise against ``sequential_prefill``;
  ``lm_forward`` on the HT flat path with and without a loss mask: loss
  and aux within 1e-5 of JAX's; ``launch/serve.py`` end to end. The
  continuous server and the hierarchical forward over a ``DistComm`` are
  held in ``tests/test_torch_dist_serve.py``.
"""
import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.comm import DistComm, LocalComm
from repro_torch.configs import dbrx_132b, deepseek_v3_671b
from repro_torch.core import (EpGroupConfig, RouterConfig, ep_combine, ep_complete,
                              ep_create_group, ep_create_handle, ep_dispatch,
                              ep_handle_refresh, route)
from repro_torch.device import rank_device
from repro_torch.launch.mesh import (init_process, make_production_axes, make_test_axes,
                                     parse_mesh, spawn)
from repro_torch.models import get_model
from repro_torch.models.moe import moe_block
from repro_torch.models.transformer import _index, lm_spec
from repro_torch.runtime.decode import decode_loop, naive_decode_step
from repro_torch.runtime.prefill import prefill_moe, sequential_prefill
from repro_torch.runtime.server import DecodeServer
from repro_torch.weights import _leaves, _set, init_params, params_from_jax, shard_params

N = 4
WORLD = (("data", N),)
POD_DATA = (("pod", 2), ("data", 2))
DATA_MODEL = (("data", 2), ("model", 2))
E, K, T, H = 16, 4, 16, 32
TIMEOUT = datetime.timedelta(seconds=60)
F32 = dict(rtol=1e-5, atol=1e-5)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# ---------------------------------------------------------------------------
# the cases (shared by the workers and the parent)
# ---------------------------------------------------------------------------

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "i32": torch.int32,
          "fp8": torch.float8_e4m3fn}
AXES = {"group": None, "pod": "pod", "data": "data"}
# name -> (group options, hidden, mesh)
HT_HIER = dict(mode="ht", ep_axis=("pod", "data"), ht_hierarchical=True)
EP_CASES = {
    "nccl_ep": (dict(mode="ll"), H, WORLD),
    "nccl_ep_fp8": (dict(mode="ll", quantize_dispatch=True), 128, WORLD),
    "deepep": (dict(mode="ll", ll_layout="deepep"), H, WORLD),
    "deepep_fp8": (dict(mode="ll", ll_layout="deepep", quantize_dispatch=True), 128, WORLD),
    "baseline": (dict(mode="baseline"), H, WORLD),
    "ht_flat": (dict(mode="ht"), H, WORLD),
    "ht_flat_fp8": (dict(mode="ht", quantize_dispatch=True), 128, WORLD),
    "hier_nc1": (dict(HT_HIER, ht_num_chunks=1), H, POD_DATA),
    "hier_nc2": (dict(HT_HIER, ht_num_chunks=2), H, POD_DATA),
    "hier_nc2_fp8": (dict(HT_HIER, ht_num_chunks=2, quantize_dispatch=True), 128, POD_DATA),
}
# the cases also held against JAX: every mode and layout, fp8 payloads in
# four (each JAX case compiles a shard_map program in the parent)
JAX_CASES = ("nccl_ep_fp8", "deepep_fp8", "baseline", "ht_flat_fp8", "hier_nc1",
             "hier_nc2_fp8")
REFRESH_CASES = ("nccl_ep", "deepep", "ht_flat")
DECODE_MODES = {"ll_nccl_ep": ("ll", "nccl_ep"), "ll_deepep": ("ll", "deepep"),
                "ht": ("ht", "nccl_ep"), "baseline": ("baseline", "nccl_ep")}
STEPS = 3                        # decode_loop window; step 2 replays step 1
# moe_block: name -> (config maker, MoE options, mesh, global batch, seq)
MOE_CASES = {
    "dbrx_expert_tp": ("dbrx", dict(ep_axis=("data",)), DATA_MODEL, 4, 8),
    "dbrx_ep_over_model": ("dbrx", dict(ep_axis=("data", "model")), DATA_MODEL, 4, 8),
    "deepseek_fp8": ("deepseek", dict(quantize_dispatch=True, ll_layout="nccl_ep"),
                     WORLD, 8, 2),
}
SRV_B, SRV_PROMPT, SRV_STEPS, SRV_MAX = 8, 3, 4, 12
FWD_B, FWD_S = N, 32


def config(name: str, **moe):
    """A smoke config in f32 (DeepSeek-V3's at d_model 128: fp8 blocks of
    128), MoE options replaced."""
    if name == "dbrx":
        cfg = dataclasses.replace(dbrx_132b.smoke_config(), dtype=torch.float32)
    else:
        cfg = dataclasses.replace(deepseek_v3_671b.smoke_config(), dtype=torch.float32,
                                  d_model=128)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def np_params(cfg, seed: int) -> dict:
    """A numpy parameter tree for ``cfg`` (the JAX package's names and
    layouts), drawn from a numpy seed, with a random selection bias."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, s in _leaves(lm_spec(cfg)):
        if path[-1] == "sel_bias":
            a = 0.1 * rng.standard_normal(s.shape)
        elif s.init in ("zeros", "ones"):
            a = np.full(s.shape, 0.0 if s.init == "zeros" else 1.0)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            a = rng.standard_normal(s.shape) * s.scale / np.sqrt(max(fan_in, 1))
        _set(tree, path, a.astype(np.float32))
    return tree


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as int16, fp8 as uint8)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype.is_floating_point and t.dtype.itemsize == 1:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def as_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float8_e4m3fn:
        return torch.from_numpy(a.astype(np.uint8)).view(dtype)
    return torch.from_numpy(a).to(dtype)


def inputs() -> dict:
    """Every check's numpy inputs, from seeds."""
    rng = np.random.default_rng(0)

    def routing(h):
        topk = np.stack([np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
                         for _ in range(N)]).astype(np.int32)
        logits = rng.standard_normal((N, T, K)).astype(np.float32)
        w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        return (rng.standard_normal((N, T, h)).astype(np.float32), topk,
                w.astype(np.float32))

    prims = {}
    for dn in DTYPES:
        for an, axis in AXES.items():
            blocks = N if axis is None else 2
            a = rng.standard_normal((N, blocks, 3, 8)).astype(np.float32) * 4
            if dn == "i32":
                a = rng.integers(-2**20, 2**20, a.shape).astype(np.int32)
            elif dn == "fp8":
                a = rng.integers(0, 256, a.shape).astype(np.uint8)
            prims[dn, an] = a
    ep = {name: routing(h) for name, (_, h, _) in EP_CASES.items()}
    ep["hier_nc2"] = ep["hier_nc1"]       # the chunks held against each other
    refresh = {name: (routing(H), routing(H)) for name in REFRESH_CASES}
    xs = rng.standard_normal((STEPS, 2, N, T, H)).astype(np.float32)
    xs[2] = xs[1]
    decode = (xs, rng.standard_normal((H, E)).astype(np.float32))
    moe = {}
    for name, (arch, opts, _, B, S) in MOE_CASES.items():
        cfg = config(arch, **opts)
        moe[name] = (np_params(cfg, 1), rng.standard_normal((B, S, cfg.d_model))
                     .astype(np.float32))
    dbrx = config("dbrx")
    fwd_cfg = config("dbrx", ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25)
    mask = (rng.random((FWD_B, FWD_S)) < 0.7).astype(np.float32)
    mask[1] = 0.0                         # a rank whose rows all drop out
    return dict(
        prims=prims, ep=ep, refresh=refresh, decode=decode, moe=moe,
        srv_params=np_params(dbrx, 2),
        prompts=rng.integers(0, dbrx.vocab, (SRV_B, SRV_PROMPT)).astype(np.int32),
        fwd_params=np_params(fwd_cfg, 3),
        fwd_tokens=rng.integers(0, dbrx.vocab, (FWD_B, FWD_S)).astype(np.int32),
        fwd_mask=mask)


# ---------------------------------------------------------------------------
# the checks, over the ranks a communicator hosts (DistComm: one; LocalComm:
# all), each returning numpy per hosted rank
# ---------------------------------------------------------------------------

def primitives(comm, prims) -> dict:
    out = {}
    for (dn, an), a in prims.items():
        dt = DTYPES[dn]
        xs = [as_torch(a[r], dt) for r in comm.ranks]
        out["a2a", dn, an] = [bits(y) for y in comm.all_to_all(xs, axis=AXES[an])]
        if isinstance(comm, DistComm) or an == "group":
            g = (comm.all_gather(xs) if an == "group"
                 else comm.all_gather(xs, axis=AXES[an]))
            out["gather", dn, an] = [bits(y) for y in g]
        if dn in ("f32", "i32"):
            out["reduce", dn, an] = [y.numpy() for y in comm.all_reduce(xs, axis=AXES[an])]
    return out


def ep_roundtrip(comm, kw, h, x, topk, w) -> dict:
    """Handle, staged dispatch, expert e scaling its rows by 1 + e, staged
    combine; every plan map, the payload and scales received, the dispatch
    tensor, counts and combined tokens, per hosted rank."""
    group = ep_create_group(EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=h,
                                          top_k=K, payload_dtype=torch.float32,
                                          quant_block=128, **kw), comm)
    rs = comm.ranks
    hs = ep_create_handle(group, [torch.from_numpy(topk[r]) for r in rs],
                          [torch.from_numpy(w[r]) for r in rs])
    pend = ep_dispatch(group, hs, [torch.from_numpy(x[r]) for r in rs], send_only=True)
    recv = ep_complete(group, hs, pend)
    L = group.local_experts
    ys = [y * (1.0 + torch.arange(r * L, (r + 1) * L)).to(y.dtype)[:, None, None]
          for r, (y, _) in zip(rs, recv)]
    outs = ep_complete(group, hs, ep_combine(group, hs, ys, send_only=True))
    res = []
    for hd, p, (y, c), o in zip(hs, pend, recv, outs):
        d = {f.name: getattr(hd.plan, f.name).numpy()
             for f in dataclasses.fields(hd.plan) if getattr(hd.plan, f.name) is not None}
        d.update(tokens_per_expert=hd.tokens_per_expert.numpy(),
                 routing_hash=hd.routing_hash.numpy(), recv=bits(p.recv),
                 y3d=y.float().numpy(), counts=c.numpy(), out=o.float().numpy())
        if p.recv_scales is not None:
            d["recv_scales"] = p.recv_scales.numpy()
        res.append(d)
    return res


def refresh_roundtrip(comm, layout, first, second) -> list:
    mode = "ht" if layout == "ht_flat" else "ll"
    ll = "deepep" if layout == "deepep" else "nccl_ep"
    group = ep_create_group(EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H,
                                          top_k=K, payload_dtype=torch.float32, mode=mode,
                                          ll_layout=ll), comm)
    rs = comm.ranks
    (_, tk1, w1), (_, tk2, w2) = first, second
    old = ep_create_handle(group, [torch.from_numpy(tk1[r]) for r in rs],
                           [torch.from_numpy(w1[r]) for r in rs])
    ref = ep_handle_refresh(group, old, [torch.from_numpy(w2[r]) for r in rs],
                            [torch.from_numpy(tk2[r]) for r in rs])
    new = ep_create_handle(group, [torch.from_numpy(tk2[r]) for r in rs],
                           [torch.from_numpy(w2[r]) for r in rs])

    def fields(hd):
        d = {f.name: getattr(hd.plan, f.name).numpy()
             for f in dataclasses.fields(hd.plan) if getattr(hd.plan, f.name) is not None}
        d.update(tokens_per_expert=hd.tokens_per_expert.numpy(),
                 routing_hash=hd.routing_hash.numpy(), topk_weights=hd.topk_weights.numpy())
        return d
    return [(fields(a), fields(b)) for a, b in zip(ref, new)]


def decode_case(comm, mode, layout, xs, router_w) -> list:
    """decode_loop over the window and the naive step on each micro-batch:
    [steps, 2] outputs of each, per hosted rank."""
    group = ep_create_group(EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H,
                                          top_k=K, mode=mode, ll_layout=layout,
                                          payload_dtype=torch.float32), comm)
    rw = torch.from_numpy(router_w)
    rcfg = RouterConfig(num_experts=E, top_k=K)

    def router_fn(x):
        r = route(x @ rw, rcfg)
        return r.topk_idx, r.topk_weights

    def expert_fn(rank, y3d, counts):
        L = group.local_experts
        return y3d * (1.0 + torch.arange(rank * L, (rank + 1) * L))[:, None, None]

    rs = comm.ranks
    pairs = [tuple([torch.from_numpy(xs[s, m, r]) for r in rs] for m in range(2))
             for s in range(STEPS)]
    outs = decode_loop(group, router_fn, expert_fn, pairs)
    naive = [[naive_decode_step(group, router_fn, expert_fn, x) for x in pair]
             for pair in pairs]
    return [dict(loop=np.stack([[mb[i].numpy() for mb in pair] for pair in outs]),
                 naive=np.stack([[mb[i].numpy() for mb in pair] for pair in naive]))
            for i in range(len(rs))]


def prefill_case(comm, xs, router_w) -> list:
    """prefill_moe over two micro-batches of a rank's 2T tokens (HT flat)
    and sequential_prefill, per hosted rank."""
    group = ep_create_group(EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H,
                                          top_k=K, mode="ht", payload_dtype=torch.float32),
                            comm)
    rw = torch.from_numpy(router_w)
    rcfg = RouterConfig(num_experts=E, top_k=K)

    def router_fn(x):
        r = route(x @ rw, rcfg)
        return r.topk_idx, r.topk_weights

    def expert_fn(rank, y3d, counts):
        L = group.local_experts
        return y3d * (1.0 + torch.arange(rank * L, (rank + 1) * L))[:, None, None]

    x = [torch.from_numpy(np.concatenate([xs[0, 0, r], xs[0, 1, r]])) for r in comm.ranks]
    piped = prefill_moe(group, router_fn, expert_fn, x)
    seq = sequential_prefill(group, router_fn, expert_fn, x)
    return [dict(piped=a.numpy(), seq=b.numpy()) for a, b in zip(piped, seq)]


def moe_case(comm, name, tree, x) -> dict:
    """One MoE layer (layer 0 of the stack) on this process's rows."""
    arch, opts, _, _, _ = MOE_CASES[name]
    cfg = config(arch, **opts)
    params = shard_params(params_from_jax(tree, cfg, device="cpu"), cfg, comm)
    p = _index(params["moe_stack"], 0)["moe"]
    y, aux = moe_block(p, torch.from_numpy(x[comm.batch_rows(x.shape[0])]), cfg, comm)
    return dict(y=y.numpy(), aux=aux.numpy())


def server_case(comm, tree, prompts, depth) -> np.ndarray:
    cfg = config("dbrx")
    params = shard_params(params_from_jax(tree, cfg, device="cpu"), cfg, comm)
    srv = DecodeServer(cfg, SRV_B, SRV_MAX, comm=comm, params=params, device="cpu",
                       pipeline_depth=depth)
    m = srv.serve(prompts, SRV_STEPS)
    assert m.total_tokens == SRV_B * (SRV_STEPS + 1)
    return srv.last_tokens


def forward_case(comm, tree, tokens, mask) -> tuple:
    cfg = config("dbrx", ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25)
    params = shard_params(params_from_jax(tree, cfg, device="cpu"), cfg, comm)
    rows = comm.batch_rows(tokens.shape[0])
    batch = {"tokens": torch.from_numpy(tokens[rows])}
    if mask is not None:
        batch["loss_mask"] = torch.from_numpy(mask[rows])
    loss, aux = get_model(cfg).forward(params, batch, cfg, comm)
    return float(loss), float(aux["aux"])


# ---------------------------------------------------------------------------
# the worker: one rank, every check
# ---------------------------------------------------------------------------

def worker(rank: int, world: int, init_method: str, inp: dict) -> dict:
    torch.set_num_threads(1)
    init_process(WORLD, "cpu", init_method, rank=rank, world=world, timeout=TIMEOUT)
    pd = DistComm(POD_DATA, timeout=TIMEOUT)
    flat = DistComm(WORLD, timeout=TIMEOUT)
    comms = {WORLD: flat, POD_DATA: pd}
    out = dict(prims=primitives(pd, inp["prims"]))
    out["ep"] = {name: ep_roundtrip(comms[mesh], kw, h, *inp["ep"][name])[0]
                 for name, (kw, h, mesh) in EP_CASES.items()}
    out["refresh"] = {name: refresh_roundtrip(flat, name, *inp["refresh"][name])[0]
                      for name in REFRESH_CASES}
    out["decode"] = {name: decode_case(flat, mode, layout, *inp["decode"])[0]
                     for name, (mode, layout) in DECODE_MODES.items()}
    out["prefill"] = prefill_case(flat, *inp["decode"])[0]
    out["moe"] = {}
    for name, (arch, opts, mesh, _, _) in MOE_CASES.items():
        c = comms[mesh] if mesh in comms else DistComm(mesh, ep_axes=opts["ep_axis"],
                                                       timeout=TIMEOUT)
        out["moe"][name] = dict(moe_case(c, name, *inp["moe"][name]), coords=dict(c.coords))
    out["server"] = {d: server_case(flat, inp["srv_params"], inp["prompts"], d)
                     for d in (1, 2)}
    out["forward"] = {m: forward_case(flat, inp["fwd_params"], inp["fwd_tokens"],
                                      inp["fwd_mask"] if m == "masked" else None)
                      for m in ("plain", "masked")}
    out["ranks"] = dict(world=flat.ranks, pod_data=pd.ranks, coords=pd.coords,
                        backend=flat.backend, capturable=flat.capturable)
    if rank == 0:               # while the parent runs JAX
        out["local"] = local_refs(inp)
    return out


def local_refs(inp: dict) -> dict:
    """The LocalComm(4) references: every rank hosted in one process."""
    return {
        "prims": primitives(LocalComm(N, axes=POD_DATA), inp["prims"]),
        "ep": {name: ep_roundtrip(LocalComm(N, axes=mesh), kw, h, *inp["ep"][name])
               for name, (kw, h, mesh) in EP_CASES.items()},
        "refresh": {name: refresh_roundtrip(LocalComm(N), name, *inp["refresh"][name])
                    for name in REFRESH_CASES},
        "decode": {name: decode_case(LocalComm(N), mode, layout, *inp["decode"])
                   for name, (mode, layout) in DECODE_MODES.items()},
        "prefill": prefill_case(LocalComm(N), *inp["decode"]),
        "server": server_case(LocalComm(N), inp["srv_params"], inp["prompts"], 1),
    }


# ---------------------------------------------------------------------------
# the parent: spawn, LocalComm, JAX
# ---------------------------------------------------------------------------

def jax_mesh(axes):
    import jax
    names = tuple(a for a, _ in axes)
    shape = tuple(s for _, s in axes)
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(names),
                         devices=jax.devices()[:n])


def jax_ep(kw, h, mesh_axes, x, topk, w) -> dict:
    """The JAX unified API's round trip over the mesh, stacked [N, ...]."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import api as japi
    from repro.core.group import EpGroupConfig as JCfg
    from repro.core.group import ep_create_group as j_create_group
    group = j_create_group(JCfg(num_experts=E, max_tokens_per_rank=T, hidden=h, top_k=K,
                                payload_dtype=jnp.float32, quant_block=128, **kw),
                           ep_size=N, inner_size=mesh_axes[-1][1])
    names = tuple(a for a, _ in mesh_axes)
    spec = P(names)

    def step(tk, wt, xs):
        hd = japi.ep_create_handle(group, tk[0], wt[0])
        out = {f.name: getattr(hd.plan, f.name)[None] for f in dataclasses.fields(hd.plan)
               if getattr(hd.plan, f.name) is not None}
        out["tokens_per_expert"] = hd.tokens_per_expert[None]
        out["routing_hash"] = hd.routing_hash[None]
        pend = japi.ep_dispatch(group, hd, xs[0], send_only=True)
        if pend.recv_scales is not None:
            out["recv_scales"] = pend.recv_scales[None]
        y3d, counts = japi.ep_complete(group, hd, pend)
        out["y3d"], out["counts"] = y3d[None], counts[None]
        me = 0
        for a, s in mesh_axes:
            me = me * s + jax.lax.axis_index(a)
        L = group.local_experts
        e = me * L + jnp.arange(L)
        out["out"] = japi.ep_complete(group, hd, japi.ep_combine(
            group, hd, y3d * (1.0 + e)[:, None, None].astype(y3d.dtype),
            send_only=True))[None]
        return out

    fn = jax.jit(jax.shard_map(step, mesh=jax_mesh(mesh_axes), in_specs=(spec,) * 3,
                               out_specs=spec))
    res = fn(jnp.asarray(topk), jnp.asarray(w), jnp.asarray(x))
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
            for k, v in res.items()}


def jax_moe(name, tree, x) -> tuple:
    import jax
    import jax.numpy as jnp

    from repro.configs.dbrx_132b import smoke_config as j_dbrx
    from repro.configs.deepseek_v3_671b import smoke_config as j_ds
    from repro.models.moe import moe_block as j_moe_block
    arch, opts, mesh_axes, _, _ = MOE_CASES[name]
    jcfg = j_dbrx() if arch == "dbrx" else dataclasses.replace(j_ds(), d_model=128)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               moe=dataclasses.replace(jcfg.moe, **opts))
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["moe_stack"]["moe"])
    y, aux = jax.jit(lambda p, x: j_moe_block(p, x, jcfg, jax_mesh(mesh_axes)))(
        p, jnp.asarray(x))
    return np.asarray(y), float(aux)


def jax_server(tree, prompts) -> np.ndarray:
    import jax.numpy as jnp

    from repro.configs.dbrx_132b import smoke_config as j_dbrx
    from repro.runtime.server import DecodeServer as JaxServer
    jcfg = dataclasses.replace(j_dbrx(), dtype=jnp.float32)
    srv = JaxServer(jcfg, batch=SRV_B, max_len=SRV_MAX, mesh=jax_mesh(WORLD), params=tree)
    try:
        first, _ = srv.prefill(jnp.asarray(prompts))
        toks, _ = srv.decode(first, SRV_STEPS)
    finally:
        srv.close()
    return np.asarray(toks)


def jax_forward(tree, tokens, mask) -> tuple:
    import jax
    import jax.numpy as jnp

    from repro.configs.dbrx_132b import smoke_config as j_dbrx
    from repro.models import get_model as j_get_model
    jcfg = j_dbrx()
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, moe=dataclasses.replace(
        jcfg.moe, ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25))
    fwd, m = j_get_model(jcfg).forward, jax_mesh(WORLD)
    batch = {"tokens": jnp.asarray(tokens)}
    if mask is not None:
        batch["loss_mask"] = jnp.asarray(mask)
    loss, aux = jax.jit(lambda p, b: fwd(p, b, jcfg, m))(tree, batch)
    return float(loss), float(aux["aux"])


def as_division_scales(scales, x, block):
    from test_torch_hier import as_division
    return as_division(scales, x, block)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the workers (rank 0 also computes the LocalComm references)
    and start ``launch/serve.py`` end to end; compute the JAX references
    while they run; join both."""
    inp = inputs()
    work = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    serve = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "dbrx-132b", "--smoke",
         "--device", "cpu", "--mesh", str(N), "--batch", "8", "--prompt-len", "4",
         "--gen", "4"], env=env, cwd=work, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    box = {}

    def go():
        try:
            box["ranks"] = spawn(worker, N, inp, timeout=240, workdir=work)
        except BaseException as e:               # re-raised in the test process
            box["error"] = e
    th = threading.Thread(target=go)
    th.start()
    try:
        jref = {
            "ep": {name: jax_ep(*EP_CASES[name], *inp["ep"][name]) for name in JAX_CASES},
            "moe": {name: jax_moe(name, *inp["moe"][name]) for name in MOE_CASES},
            "server": jax_server(inp["srv_params"], inp["prompts"]),
            "forward": {m: jax_forward(inp["fwd_params"], inp["fwd_tokens"],
                                       inp["fwd_mask"] if m == "masked" else None)
                        for m in ("plain", "masked")},
        }
    finally:
        th.join(300)
        try:
            serve_out, _ = serve.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            serve.kill()
            serve_out, _ = serve.communicate()
    assert not th.is_alive(), "the workers did not end"
    if "error" in box:
        raise box["error"]
    return dict(inp=inp, ranks=box["ranks"], local=box["ranks"][0]["local"], jax=jref,
                serve=(serve.returncode, serve_out))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

PRIM_CASES = [(k, dn, an) for k in ("a2a", "gather") for dn in DTYPES for an in AXES] + \
    [("reduce", dn, an) for dn in ("f32", "i32") for an in AXES]


def _axis_peers(rank: int, an: str) -> list:
    """Ranks that differ from ``rank`` only in mesh axis ``an`` of POD_DATA,
    in coordinate order (the whole group for "group")."""
    pod, data = divmod(rank, 2)
    if an == "group":
        return list(range(N))
    return [p * 2 + data for p in range(2)] if an == "pod" else [pod * 2 + d for d in range(2)]


@pytest.mark.parametrize("kind,dn,an", PRIM_CASES)
def test_primitives_match_local_comm(run, kind, dn, an):
    """DistComm's collectives over gloo, on the group and on each axis of a
    (pod 2, data 2) mesh, against LocalComm's on the same stacked inputs:
    bitwise, sums within f32 rounding. The all-gather over one axis has no
    LocalComm counterpart: it is held against the stack of the peers'
    inputs."""
    got = [r["prims"][kind, dn, an][0] for r in run["ranks"]]
    a = run["inp"]["prims"][dn, an]
    for rank, g in enumerate(got):
        if kind == "gather" and an != "group":
            want = bits(as_torch(a[_axis_peers(rank, an)], DTYPES[dn]))
        else:
            want = run["local"]["prims"][kind, dn, an][rank]
        assert g.dtype == want.dtype and g.shape == want.shape, (g.dtype, g.shape, want.shape)
        if kind == "reduce" and dn == "f32":
            np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, want)


def test_mesh_ranks_are_row_major(run):
    for rank, r in enumerate(run["ranks"]):
        info = r["ranks"]
        assert info["world"] == (rank,) and info["pod_data"] == (rank,)
        assert info["coords"] == {"pod": rank // 2, "data": rank % 2}
        assert info["backend"] == "gloo" and info["capturable"] is False


@pytest.mark.parametrize("case", JAX_CASES)
def test_ep_matches_jax(run, case):
    """Plan maps, counts, routing hash, dispatch tensor and fp8 scales
    bitwise against JAX on the same mesh; combined tokens within 1e-5."""
    kw, h, _ = EP_CASES[case]
    want = run["jax"]["ep"][case]
    got = {k: np.stack([r["ep"][case][k] for r in run["ranks"]])
           for k in run["ranks"][0]["ep"][case]}
    maps = [k for k in want if k in got and k not in ("recv_scales", "out", "y3d")]
    assert {"counts", "tokens_per_expert", "routing_hash", "disp_counts"} <= set(maps), maps
    for k in maps:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype), err_msg=k)
    np.testing.assert_array_equal(got["y3d"], want["y3d"])
    if kw.get("quantize_dispatch"):
        x = run["inp"]["ep"][case][0]
        np.testing.assert_array_equal(got["recv_scales"],
                                      as_division_scales(want["recv_scales"], x, 128))
    np.testing.assert_allclose(got["out"], want["out"], **F32)


@pytest.mark.parametrize("case", list(EP_CASES))
def test_ep_matches_local_comm(run, case):
    """Every field, payload bytes included, bitwise against LocalComm(4)
    hosting the same mesh in one process."""
    local = run["local"]["ep"][case]
    for rank, r in enumerate(run["ranks"]):
        got, want = r["ep"][case], local[rank]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"rank {rank} {k}")


def test_hier_chunks_bitwise(run):
    """Two chunks give the one chunk's dispatch tensor, counts and combined
    tokens bit for bit (zero drop)."""
    for r in run["ranks"]:
        a, b = r["ep"]["hier_nc1"], r["ep"]["hier_nc2"]
        for k in ("y3d", "counts", "out", "tokens_per_expert"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", REFRESH_CASES)
def test_handle_refresh(run, case):
    """A handle refreshed with new routing equals one created on it, and
    the LocalComm refresh, bit for bit."""
    for rank, r in enumerate(run["ranks"]):
        refreshed, fresh = r["refresh"][case]
        l_refreshed, _ = run["local"]["refresh"][case][rank]
        assert refreshed.keys() == fresh.keys() == l_refreshed.keys()
        for k in fresh:
            np.testing.assert_array_equal(refreshed[k], fresh[k], err_msg=k)
            np.testing.assert_array_equal(refreshed[k], l_refreshed[k], err_msg=k)


@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_decode_loop_matches_naive(run, mode):
    """decode_loop (refresh after step 0, staged micro-batch pairs) equals
    the naive step bitwise in each process, and LocalComm's loop."""
    for rank, r in enumerate(run["ranks"]):
        got = r["decode"][mode]
        np.testing.assert_array_equal(got["loop"], got["naive"])
        np.testing.assert_array_equal(got["loop"], run["local"]["decode"][mode][rank]["loop"])
        np.testing.assert_array_equal(got["loop"][2], got["loop"][1])


def test_prefill_moe_matches_sequential(run):
    """prefill_moe (the next micro-batch's dispatch sent before this one
    completes) equals sequential_prefill bitwise in each process, and
    LocalComm's."""
    for rank, r in enumerate(run["ranks"]):
        np.testing.assert_array_equal(r["prefill"]["piped"], r["prefill"]["seq"])
        np.testing.assert_array_equal(r["prefill"]["piped"],
                                      run["local"]["prefill"][rank]["piped"])


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_jax(run, case):
    """The MoE layer over DistComm within 1e-5 (f32) of JAX's moe_block on
    the same mesh: expert-TP over model (each process an F-slice of its
    experts, the FFN summed over model), EP over (data, model) with S split
    over model, and DeepSeek-V3's routing with fp8 dispatch. Processes that
    share rows give the same rows."""
    want_y, want_aux = run["jax"]["moe"][case]
    _, _, mesh, B, _ = MOE_CASES[case]
    batch_axes = [a for a, _ in mesh if a in ("pod", "data")]
    nb = int(np.prod([s for a, s in mesh if a in batch_axes]))
    rows = want_y.shape[0] // nb
    for r in run["ranks"]:
        got = r["moe"][case]
        b = got["coords"]["data"]
        np.testing.assert_allclose(got["y"], want_y[b * rows:(b + 1) * rows], **F32)
        np.testing.assert_allclose(got["aux"], want_aux, **F32)


@pytest.mark.parametrize("depth", [1, 2])
def test_decode_server_matches_local_comm_and_jax(run, depth):
    """DecodeServer(comm=DistComm) on mesh 4: the global token stream in
    every process equals LocalComm(4)'s server and JAX's on mesh 4."""
    want = run["jax"]["server"]
    np.testing.assert_array_equal(run["local"]["server"], want)
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["server"][depth], want)


@pytest.mark.parametrize("mask", ["plain", "masked"])
def test_lm_forward_matches_jax(run, mask):
    """lm_forward on the HT flat path (capacity 1.25), each process its row:
    the global loss (summed (sum, count) over the batch ranks; with a mask
    one rank has no token) and aux within 1e-5 of JAX's, in every process."""
    want_loss, want_aux = run["jax"]["forward"][mask]
    for r in run["ranks"]:
        loss, aux = r["forward"][mask]
        np.testing.assert_allclose(loss, want_loss, **F32)
        np.testing.assert_allclose(aux, want_aux, **F32)


def test_launch_serve_end_to_end(run):
    """python -m repro_torch.launch.serve --device cpu --mesh 4 --smoke: one
    process per rank, rank 0 printing the reference's metric line."""
    rc, out = run["serve"]
    assert rc == 0, out
    lines = [ln for ln in out.splitlines() if ln.startswith("output_tok_s=")]
    assert len(lines) == 1, out
    vals = dict(kv.split("=") for kv in lines[0].split())
    assert set(vals) == {"output_tok_s", "ttft_ms", "itl_mean_ms", "itl_p99_ms"}
    assert all(float(v) > 0 for v in vals.values())


# ---------------------------------------------------------------------------
# single-process pieces
# ---------------------------------------------------------------------------

def test_parse_mesh():
    assert parse_mesh("4") == (("data", 4),)
    assert parse_mesh("2x2") == (("data", 2), ("model", 2))
    assert parse_mesh("2x4x2") == (("pod", 2), ("data", 4), ("model", 2))
    assert parse_mesh(None) is None and parse_mesh("") is None
    assert make_production_axes() == (("data", 16), ("model", 16))
    assert make_production_axes(multi_pod=True) == (("pod", 2), ("data", 16), ("model", 16))
    assert make_test_axes() == DATA_MODEL


def test_rank_device(monkeypatch):
    """cuda:{LOCAL_RANK} by default, else the local rank given; an explicit
    device as given; no CUDA device and no explicit one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert rank_device(None, 2) == torch.device("cuda", 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert rank_device(None, 2) == torch.device("cuda", 3)
    assert rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rank_device()


def test_dist_comm_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        DistComm(WORLD)


class _Rank:
    """The parts of a DistComm that shard_params reads, for one process."""

    def __init__(self, ep_rank, size, tp=None):
        self.ranks, self.size = (ep_rank,), size
        self.tp_axis = "model" if tp else None
        self.mesh = (("data", size),) + ((("model", tp[1]),) if tp else ())
        self.coords = {"data": ep_rank, **({"model": tp[0]} if tp else {})}


@pytest.mark.parametrize("tp", [None, (1, 2)])
def test_shard_params_and_sharded_init(tp):
    """shard_params keeps rank r's experts [r*L, (r+1)*L) and, under
    expert-TP, the F-slice at its model coordinate; init_params(comm=)
    draws the same shard; everything else is the full tree's."""
    cfg = config("dbrx")
    full = init_params(cfg, seed=5, device="cpu")
    comm = _Rank(2, 4, tp)
    part = shard_params(full, cfg, comm)
    drawn = init_params(cfg, seed=5, device="cpu", comm=comm)
    L, F = cfg.moe.num_experts // 4, cfg.moe.d_ff_expert
    f = slice(F // 2, F) if tp else slice(0, F)
    want = {"w_gate": full["moe_stack"]["moe"]["w_gate"][:, 2 * L:3 * L, :, f],
            "w_up": full["moe_stack"]["moe"]["w_up"][:, 2 * L:3 * L, :, f],
            "w_down": full["moe_stack"]["moe"]["w_down"][:, 2 * L:3 * L, f, :]}
    for k, w in want.items():
        assert torch.equal(part["moe_stack"]["moe"][k], w)
        assert torch.equal(drawn["moe_stack"]["moe"][k], w)
        assert part["moe_stack"]["moe"][k].is_contiguous()
    for path, t in _leaves(full):
        if path[-1] not in want:
            got = part
            for p in path:
                got = got[p]
            assert got is t
    assert shard_params(full, cfg, LocalComm(4))["moe_stack"]["moe"]["w_gate"] is \
        full["moe_stack"]["moe"]["w_gate"]
