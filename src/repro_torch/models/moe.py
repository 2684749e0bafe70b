"""MoE block on the EP core (port of ``src/repro/models/moe.py``).

``moe_block(p, x, cfg, comm)`` splits the tokens across the ranks the
communicator hosts by contiguous batch rows, as the JAX block's shard_map
lays them out over the EP axis (``_token_specs``). Per rank: router, handle,
staged dispatch, the SwiGLU expert FFN as three grouped GEMMs over the
rank's experts [r*L, (r+1)*L), staged combine. With no communicator, or an
EP extent of 1, it takes the dense reference path exactly as JAX does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import (EpGroupConfig, ep_combine, ep_complete,
                              ep_create_group, ep_create_handle, ep_dispatch)
from repro_torch.core.routing import RouterConfig, route
from repro_torch.kernels import ops as K
from repro_torch.models.config import ArchConfig, ParamSpec
from repro_torch.models.layers import ffn_apply, ffn_spec


def moe_spec(cfg: ArchConfig, dtype=None):
    m, d = cfg.moe, cfg.d_model
    dtype = dtype or cfg.dtype
    f = m.d_ff_expert
    sp = dict(
        router=ParamSpec((d, m.num_experts), torch.float32),
        w_gate=ParamSpec((m.num_experts, d, f), dtype),
        w_up=ParamSpec((m.num_experts, d, f), dtype),
        w_down=ParamSpec((m.num_experts, f, d), dtype),
    )
    if m.use_selection_bias:
        sp["sel_bias"] = ParamSpec((m.num_experts,), torch.float32, init="zeros")
    if m.shared_experts:
        sp["shared"] = ffn_spec(d, m.shared_experts * f, dtype, cfg.act)
    return sp


def check_supported(m) -> None:
    """Refuse MoE options that later slices port."""
    if m.placement is not None or m.params_physical or m.track_expert_heat:
        raise NotImplementedError("EPLB placement and expert heat are not "
                                  "ported yet (ROADMAP A10)")


def router_config(m) -> RouterConfig:
    return RouterConfig(
        num_experts=m.num_experts, top_k=m.top_k, gating=m.gating,
        n_groups=m.n_groups, topk_groups=m.topk_groups,
        use_selection_bias=m.use_selection_bias,
        routed_scaling_factor=m.routed_scaling, norm_topk_prob=m.norm_topk,
        aux_loss_weight=m.aux_loss_weight, z_loss_weight=1e-4,
    )


def _expert_ffn(y3d, counts, w1, w3, w2):
    """Grouped SwiGLU over [L, A, D], rows past each count left zero."""
    g = K.grouped_gemm(y3d, w1, counts)
    u = K.grouped_gemm(y3d, w3, counts)
    h = (F.silu(g.float()) * u.float()).to(y3d.dtype)
    return K.grouped_gemm(h, w2, counts)


def ep_group(cfg: ArchConfig, comm, tokens_per_rank: int):
    """The EP group of ``cfg``'s MoE layers over ``comm``."""
    m = cfg.moe
    return ep_create_group(EpGroupConfig(
        num_experts=m.num_experts, max_tokens_per_rank=tokens_per_rank,
        hidden=cfg.d_model, top_k=m.top_k, mode=m.ep_mode, ll_layout=m.ll_layout,
        capacity_factor=m.capacity_factor,
        expert_capacity_factor=m.expert_capacity_factor,
        payload_dtype=cfg.dtype, quantize_dispatch=m.quantize_dispatch), comm)


def moe_block(p, x: torch.Tensor, cfg: ArchConfig, comm):
    """x: [B, S, D] -> (y [B, S, D], aux_loss scalar)."""
    m = cfg.moe
    check_supported(m)
    if comm is None or comm.size <= 1 or m.num_experts % comm.size:
        return _moe_dense_fallback(p, x, cfg), torch.zeros((), device=x.device)
    B, S, D = x.shape
    n = len(comm.ranks)
    if B % n:
        raise ValueError(f"batch {B} must split evenly over the {n} hosted ranks")
    Bl = B // n
    T = Bl * S
    group = ep_group(cfg, comm, T)
    L = group.local_experts
    xs = [x[i * Bl:(i + 1) * Bl].reshape(T, D) for i in range(n)]
    rcfg = router_config(m)
    rs = [route(xt.float() @ p["router"], rcfg, p.get("sel_bias")) for xt in xs]
    handles = ep_create_handle(group, [r.topk_idx for r in rs],
                               [r.topk_weights for r in rs])
    # staged send/complete is every backend's primitive (as in JAX); the
    # seam is where a micro-batching scheduler would overlap expert compute
    recv = ep_complete(group, handles, ep_dispatch(group, handles, xs, send_only=True))
    y3ds = [_expert_ffn(y3d, counts,
                        p["w_gate"][r * L:(r + 1) * L], p["w_up"][r * L:(r + 1) * L],
                        p["w_down"][r * L:(r + 1) * L])
            for r, (y3d, counts) in zip(comm.ranks, recv)]
    outs = ep_complete(group, handles, ep_combine(group, handles, y3ds, send_only=True))
    y = torch.cat([o.to(x.dtype).reshape(Bl, S, D) for o in outs])
    aux = torch.stack([r.aux_loss + r.z_loss for r in rs]).mean()
    if m.shared_experts:
        y = y + ffn_apply(p["shared"], x, cfg.act)
    return y, aux


def _moe_dense_fallback(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Reference MoE with no EP communication: every expert on every token,
    gated by the same router. Same function as the EP path."""
    m = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    r = route(xt.float() @ p["router"], router_config(m), p.get("sel_bias"))
    h_g = torch.einsum("td,edf->tef", xt, p["w_gate"])
    h_u = torch.einsum("td,edf->tef", xt, p["w_up"])
    h = (F.silu(h_g.float()) * h_u.float()).to(x.dtype)
    y_all = torch.einsum("tef,efd->ted", h, p["w_down"])            # [T, E, D]
    oh = F.one_hot(r.topk_idx.long(), m.num_experts).float()
    gate = torch.einsum("tk,tke->te", r.topk_weights, oh)           # [T, E]
    y = torch.einsum("ted,te->td", y_all.float(), gate).to(x.dtype)
    y = y.reshape(B, S, D)
    if m.shared_experts:
        y = y + ffn_apply(p["shared"], x, cfg.act)
    return y
