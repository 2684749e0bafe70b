"""The EP backward of hierarchical HT, the LL ``deepep`` layout and the
baseline against the JAX package's AD, f32 on the CPU.

* The EP round trip (dispatch, each expert e scaling its rows by 1 + e,
  combine) through ``core/ll.py``'s ``EpDispatch`` / ``EpCombine`` over
  ``LocalComm(8)`` against ``jax.vjp`` of the reference's round trip under
  shard_map on 8 fake devices: ``deepep``, the baseline (zero drop and
  capacity factor 1.0 with drops) and hierarchical HT on two pods of four
  (1 and 2 chunks, zero drop and drops); the tokens' and the combine
  weights' gradients within 1e-5.
* The hierarchical gradients bitwise equal at 1 and 2 chunks at zero drop;
  the ``deepep`` and hierarchical fp8 dispatch gradients bitwise equal to
  the bf16 ones (straight-through).
* The maps the stored (not summed) transposes rely on: no valid entry of
  ``comb_recv_rows``, ``h_slot_rows``, ``h_rail_rows`` (per chunk) or
  ``h_src_rows`` names a row twice, in every layout and drop case of
  ``tests/test_torch_layouts.py`` and ``tests/test_torch_hier.py`` and
  under a placement with redundant slots; the rail sum's positions are the
  fan's.
* ``lm_forward``'s loss and gradients against ``jax.value_and_grad`` of the
  reference's: the baseline on 4 fake devices, hierarchical HT on a (pod 2,
  data 2) mesh at S 32 and 2048; ``deepep``'s against the port's own
  ``nccl_ep`` (the reference's ``deepep`` layer is faulty, ROADMAP Queue
  C); two hierarchical ``make_train_step`` steps against JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import api as japi
from repro.core.group import EpGroupConfig as JCfg
from repro.core.group import ep_create_group as j_create_group
from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.models import get_model as jax_get_model
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.parallel.sharding import init_from_specs
from repro.runtime.steps import make_train_step as j_make_train_step
from repro_torch.comm import LocalComm
from repro_torch.core import EpGroupConfig, ep_create_group, ep_create_handle
from repro_torch.core import ll as LL
from repro_torch.core import placement as PL
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.steps import make_train_step
from repro_torch.weights import _leaves, params_from_jax
from test_torch_train import _cfgs, _lm_grads, _rel_close

No, Ni = 2, 4
N = No * Ni
E, K, T, H = 16, 4, 16, 32
F32 = dict(rtol=1e-5, atol=1e-5)
HIER_AXES = (("pod", No), ("data", Ni))
DEEPEP = dict(mode="ll", ll_layout="deepep")
BASELINE = dict(mode="baseline")


def hier(nc=1, **kw):
    return dict(mode="ht", ep_axis=("pod", "data"), ht_hierarchical=True, ht_num_chunks=nc,
                **kw)


# name -> (group options, tokens a rank, skewed routing)
ROUNDTRIPS = {
    "deepep": (DEEPEP, T, False),
    "baseline": (BASELINE, T, False),
    "baseline_drops": (dict(BASELINE, capacity_factor=1.0), T, True),
    "hier_nc1": (hier(1), T, False),
    "hier_nc2": (hier(2), T, False),
    "hier_nc1_drops": (hier(1, capacity_factor=0.5, expert_capacity_factor=0.5), 64, True),
    "hier_nc2_drops": (hier(2, capacity_factor=0.5, expert_capacity_factor=0.5), 64, True),
}


def inputs(seed, t=T, h=H, skew=False):
    """Tokens [N, t, h], distinct top-K experts and softmax weights [N, t,
    K], and a cotangent [N, t, h], from a numpy seed; ``skew`` favours
    experts 0 and 1 so capacities overflow."""
    rng = np.random.default_rng(seed)
    p = np.ones(E)
    if skew:
        p[:2] = 12.0
    p /= p.sum()
    x = rng.standard_normal((N, t, h)).astype(np.float32)
    topk = np.stack([np.stack([rng.choice(E, K, replace=False, p=p) for _ in range(t)])
                     for _ in range(N)]).astype(np.int32)
    logits = rng.standard_normal((N, t, K)).astype(np.float32)
    w = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    cot = rng.standard_normal((N, t, h)).astype(np.float32)
    return x, topk, w, cot


def is_hier(opts) -> bool:
    return opts.get("ht_hierarchical", False)


def port_comm(opts):
    return LocalComm(N, axes=HIER_AXES if is_hier(opts) else None)


def jax_vjp(opts, t, x, topk, w, cot):
    """jax.vjp of the reference's round trip on 8 fake devices (two pods of
    four for the hierarchical path): (d_x, d_w) stacked [N, ...]."""
    jcfg = JCfg(num_experts=E, max_tokens_per_rank=t, hidden=x.shape[-1], top_k=K,
                payload_dtype=jnp.float32, **opts)
    hierarchical = is_hier(opts)
    group = j_create_group(jcfg, ep_size=N, inner_size=Ni if hierarchical else N)
    if hierarchical:
        mesh = jax.make_mesh((No, Ni), ("pod", "data"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        spec = P(("pod", "data"))
    else:
        mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
        spec = P("data")
    L = group.local_experts

    def step(tk, wt, xs):
        h = japi.ep_create_handle(group, tk[0], wt[0])
        y3d, _ = japi.ep_dispatch(group, h, xs[0])
        me = (jax.lax.axis_index("pod") * Ni + jax.lax.axis_index("data") if hierarchical
              else jax.lax.axis_index("data"))
        y3d = y3d * (1.0 + me * L + jnp.arange(L))[:, None, None].astype(y3d.dtype)
        return japi.ep_combine(group, h, y3d)[None]

    fn = jax.shard_map(step, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)

    @jax.jit
    def grads(tk, xs, wt, c):
        return jax.vjp(lambda a, b: fn(tk, b, a), xs, wt)[1](c)
    dx, dw = grads(*(jnp.asarray(a) for a in (topk, x, w, cot)))
    return np.asarray(dx), np.asarray(dw)


def port_grads(opts, t, x, topk, w, cot, dtype=torch.float32):
    """The port's round trip under autograd over LocalComm(8): (d_x, d_w,
    group, handles) with d_x and d_w stacked [N, ...] as torch tensors."""
    hidden = x.shape[-1]
    cfg = EpGroupConfig(num_experts=E, max_tokens_per_rank=t, hidden=hidden, top_k=K,
                        payload_dtype=dtype, quant_block=hidden, **opts)
    group = ep_create_group(cfg, port_comm(opts))
    xs = [torch.from_numpy(a).to(dtype).requires_grad_() for a in x]
    ws = [torch.from_numpy(a).requires_grad_() for a in w]
    hs = ep_create_handle(group, [torch.from_numpy(a) for a in topk], ws)
    recv = LL.ep_dispatch_autograd(group, hs, xs)
    L = group.local_experts
    ys = [y * (1.0 + torch.arange(r * L, (r + 1) * L)).to(y.dtype)[:, None, None]
          for r, (y, _) in zip(group.comm.ranks, recv)]
    outs = LL.ep_combine_autograd(group, hs, ys)
    torch.autograd.backward(outs, [torch.from_numpy(c).to(dtype) for c in cot])
    return (torch.stack([a.grad for a in xs]), torch.stack([a.grad for a in ws]), group, hs)


@pytest.mark.parametrize("case", list(ROUNDTRIPS))
def test_roundtrip_gradients_match_jax(case):
    """The tokens' and the combine weights' gradients of the round trip
    within 1e-5 of jax.vjp's largest value (f32 sums in another order);
    under drops some entries' weight gradients
    are exactly 0 in both."""
    opts, t, skew = ROUNDTRIPS[case]
    x, topk, w, cot = inputs(50, t=t, skew=skew)
    want_x, want_w = jax_vjp(opts, t, x, topk, w, cot)
    dx, dw, group, hs = port_grads(opts, t, x, topk, w, cot)
    assert group.hierarchical == is_hier(opts)
    _rel_close(dx.numpy(), want_x, 1e-5)
    _rel_close(dw.numpy(), want_w, 1e-5)
    assert np.abs(want_w).max() > 1.0
    if skew:
        assert (dw == 0).any() and (want_w == 0).any()


def test_hier_gradients_bitwise_across_chunks():
    """At zero drop the hierarchical gradients at 2 chunks equal 1 chunk's
    bit for bit, as the forward does."""
    x, topk, w, cot = inputs(51)
    one = port_grads(hier(1), T, x, topk, w, cot)
    two = port_grads(hier(2), T, x, topk, w, cot)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.parametrize("opts", [DEEPEP, hier(2)], ids=["deepep", "hier"])
def test_fp8_dispatch_gradient_is_straight_through(opts):
    """The gradient of an fp8 dispatch is the bf16 dispatch's, bit for bit,
    on the same cotangent, while the forwards differ."""
    h = 128
    x, topk, w, _ = inputs(52, h=h)
    grads, outs = [], []
    for fp8 in (False, True):
        cfg = EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=h, top_k=K,
                            quantize_dispatch=fp8, quant_block=h, **opts)
        group = ep_create_group(cfg, port_comm(opts))
        hs = ep_create_handle(group, [torch.from_numpy(a) for a in topk],
                              [torch.from_numpy(a) for a in w])
        xs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in x]
        y = LL.ep_dispatch_autograd(group, hs, xs)
        g = torch.Generator().manual_seed(53)
        cot = [torch.randn(y3d.shape, generator=g).to(torch.bfloat16) for y3d, _ in y]
        torch.autograd.backward([y3d for y3d, _ in y], cot)
        grads.append([a.grad for a in xs])
        outs.append([y3d.detach() for y3d, _ in y])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert any(not torch.equal(a, b) for a, b in zip(*outs))
    assert all(g.dtype == torch.bfloat16 and g.abs().sum() > 0 for g in grads[0])


# ---- the maps the stored transposes rely on -------------------------------

def _names_once(rows: torch.Tensor, sentinel: int) -> bool:
    """No valid entry of ``rows`` (< sentinel) repeats."""
    v = rows.reshape(-1)
    v = v[v < sentinel]
    return v.unique().numel() == v.numel()


# name -> (group options, tokens a rank, num_tokens, skew, placement): the
# cases of tests/test_torch_layouts.py and tests/test_torch_hier.py, and a
# placement with 8 redundant slots
MAP_CASES = {
    "deepep_zero_drop": (DEEPEP, T, None, False),
    "deepep_padding": (DEEPEP, T, 5, False),
    "baseline_zero_drop": (BASELINE, T, None, False),
    "baseline_drops": (dict(BASELINE, capacity_factor=1.0), T, None, True),
    "hier_nc1": (hier(1), T, None, False),
    "hier_nc2": (hier(2), T, None, False),
    "hier_nc4": (hier(4), T, None, False),
    "hier_nc2_drops": (hier(2, capacity_factor=0.5, expert_capacity_factor=0.5), 64, None,
                       True),
}
PLACED = ("deepep", "baseline", "hier_nc2")


def _map_handles(opts, t, num_tokens, skew, placement=None, seed=54):
    _, topk, w, _ = inputs(seed, t=t, skew=skew)
    cfg = EpGroupConfig(num_experts=E, max_tokens_per_rank=t, hidden=H, top_k=K,
                        payload_dtype=torch.float32, placement=placement, **opts)
    group = ep_create_group(cfg, port_comm(opts))
    hs = ep_create_handle(group, [torch.from_numpy(a) for a in topk],
                          [torch.from_numpy(a) for a in w], num_tokens)
    return group, hs


def _check_maps(group, hs) -> int:
    """Assert the maps name each row once; returns the valid entries seen."""
    seen = 0
    for h in hs:
        pl = h.plan
        if not group.hierarchical:
            R = int(pl.disp_send_gmap.numel())      # N * L * c rows received
            assert _names_once(pl.comb_recv_rows, R)
            seen += int((pl.comb_recv_rows < R).sum())
            continue
        LA = pl.h_slot_tgt.shape[0]
        assert _names_once(pl.h_slot_rows, LA)
        nc, _, no = pl.h_rail_rows.shape
        s2 = no * group.ht_stage2_cap
        for c in range(nc):
            assert _names_once(pl.h_rail_rows[c], s2)
        assert _names_once(pl.h_src_rows, nc * group.inner_size * group.ht_stage1_cap)
        seen += int((pl.h_slot_rows < LA).sum())
    return seen


@pytest.mark.parametrize("case", list(MAP_CASES) + [f"{c}_redundant" for c in PLACED])
def test_no_map_names_a_row_twice(case):
    """``combine_gather_reduce_bwd`` stores d_recv once per (t, k) rather
    than summing: the transpose only where no valid entry of its map names
    a received row twice. So for ``comb_recv_rows`` (``deepep``, the
    baseline) and the hierarchical ``h_slot_rows``, ``h_rail_rows`` (each
    chunk) and ``h_src_rows``, in every case, with a redundant placement
    too."""
    if case.endswith("_redundant"):
        base = {"deepep": "deepep_zero_drop", "baseline": "baseline_drops",
                "hier_nc2": "hier_nc2"}[case[:-len("_redundant")]]
        opts, t, nt, skew = MAP_CASES[base]
        group, hs = _map_handles(opts, t, nt, skew, PL.redundant_placement(E, N, 8))
        assert group.local_experts == 3
    else:
        group, hs = _map_handles(*MAP_CASES[case])
    assert _check_maps(group, hs) > 0


@pytest.mark.parametrize("nc", [1, 2, 4])
def test_rail_positions_are_the_fan_positions(nc):
    """The combine's rail positions (``c2p``) are the dispatch fan's
    (``pos2``): for every chunk, ``h_rail_rows`` is the inverse of
    ``h_gmap2``, so the rail sum serves as the fan's transpose (and the B2
    fan through ``h_gmap2`` as the rail sum's), drops included."""
    for opts, t, skew in ((hier(nc), T, False),
                          (hier(nc, capacity_factor=0.5, expert_capacity_factor=0.5), 64,
                           True)):
        group, hs = _map_handles(opts, t, None, skew)
        for h in hs:
            pl = h.plan
            R1, C2 = pl.h_rail_rows.shape[1], group.ht_stage2_cap
            for c in range(nc):
                inv = torch.full((R1 + 1, No), No * C2, dtype=torch.int32)
                g = pl.h_gmap2[c]                                  # [No, C2] -> rail row
                o = torch.arange(No)[:, None].expand(No, C2)
                slot = o * C2 + torch.arange(C2)[None, :]
                inv[g.reshape(-1).long(), o.reshape(-1)] = slot.reshape(-1).to(torch.int32)
                assert torch.equal(inv[:R1], pl.h_rail_rows[c])


# ---- lm_forward's gradients ---------------------------------------------

# name -> (mesh axes, MoE options)
LM = {
    "baseline": ((("data", 4),), dict(ep_mode="baseline")),
    "hier": ((("pod", 2), ("data", 2)),
             dict(ep_mode="ht", ht_hierarchical=True, ht_num_chunks=2, capacity_factor=1.25,
                  expert_capacity_factor=1.25)),
}


def _mesh(axes):
    return jax.make_mesh(tuple(s for _, s in axes), tuple(a for a, _ in axes),
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:4])


@pytest.mark.parametrize("case,S", [("baseline", 32), ("hier", 32), ("hier", 2048)])
def test_lm_value_and_grad_matches_jax(case, S):
    """jax.value_and_grad of the reference's lm_forward on 4 fake devices
    against the port's over LocalComm(4) on the same axes, one row a rank:
    the loss within 1e-5 and every parameter's gradient within 1e-4 of its
    largest value (at S 2048 the flash route)."""
    axes, moe = LM[case]
    jcfg, tcfg = _cfgs(ep_axis=tuple(a for a, _ in axes), **moe)
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(9), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, (4, S)).astype(np.int32)
    jfwd = jax_get_model(jcfg).forward
    (wl, _), wg = jax.jit(jax.value_and_grad(lambda p: jfwd(p, {"tokens": jnp.asarray(toks)},
                                                             jcfg, _mesh(axes)),
                                             has_aux=True))(tree)
    loss, ps = _lm_grads(tcfg, params, toks, LocalComm(4, axes=axes))
    np.testing.assert_allclose(loss.item(), float(wl), **F32)
    want = {tuple(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(wg)[0]}
    assert set(want) == set(ps)
    for path, t in ps.items():
        _rel_close(t.grad.numpy(), want[path], 1e-4)


def test_deepep_lm_gradients_match_nccl_ep():
    """The reference's deepep layer is faulty (ROADMAP Queue C), so the
    port's deepep gradients of lm_forward are held against its own
    nccl_ep gradients on the same parameters at zero drop, within 1e-5 of
    each leaf's largest value."""
    _, tcfg = _cfgs()
    out = {}
    for layout in ("deepep", "nccl_ep"):
        cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, ep_mode="ll", ll_layout=layout, capacity_factor=None))
        from repro_torch.weights import init_params
        params = init_params(cfg, 11, "cpu")
        toks = np.random.default_rng(12).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
        out[layout] = _lm_grads(cfg, params, toks, LocalComm(4))
    (l_d, p_d), (l_n, p_n) = out["deepep"], out["nccl_ep"]
    np.testing.assert_allclose(l_d.item(), l_n.item(), rtol=1e-5)
    for path, t in p_d.items():
        assert t.grad.abs().sum() > 0, "/".join(path)
        _rel_close(t.grad.numpy(), p_n[path].grad.numpy(), 1e-5)


def test_hier_train_steps_match_jax():
    """Two make_train_step steps (2 micro-batches of 4 x 32) in hierarchical
    HT over (pod 2, data 2), capacity 1.25, 2 chunks, f32, against JAX's
    jitted make_train_step on the same mesh, fed the reference pipeline's
    batches: the loss within 1e-5, the gradient norm within 1e-4, the
    learning rate exactly and every parameter within
    tests/test_torch_train_step.py's tolerance."""
    axes, moe = LM["hier"]
    jcfg, tcfg = _cfgs(ep_axis=tuple(a for a, _ in axes), **moe)
    jcfg = dataclasses.replace(jcfg, microbatch=2)
    tcfg = dataclasses.replace(tcfg, microbatch=2)
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(13), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tcfg, device="cpu")
    pipe = JDataPipeline(JDataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=8,
                                     microbatch=2, seed=14))
    batches = [jax.device_get(pipe.batch_at(i)) for i in range(2)]
    # eps 1e-4: see tests/test_torch_dist_train.py OPT
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
    jstep = jax.jit(j_make_train_step(jcfg, _mesh(axes), JAdamW(**opt)))
    step = make_train_step(tcfg, LocalComm(4, axes=axes), AdamWConfig(**opt))
    jp, jst = tree, j_adamw_init(tree, JAdamW(**opt))
    tp, tst = params, adamw_init(params, AdamWConfig(**opt))
    lr = opt["lr"]
    for b in batches:
        jp, jst, jm = jstep(jp, jst, jax.tree.map(jnp.asarray, b))
        tp, tst, tm = step(tp, tst, {k: torch.from_numpy(np.array(v)) for k, v in b.items()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        assert tm["lr"].item() == float(jm["lr"])
        want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]}
        for path, t in _leaves(tp):
            got, w = t.detach().numpy(), want[path]
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=0.1 * lr, err_msg="/".join(path))
            assert (np.abs(got - w) > 1e-5 + 1e-5 * np.abs(w)).mean() <= 1e-3, "/".join(path)
