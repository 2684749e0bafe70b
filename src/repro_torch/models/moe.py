"""MoE block on the EP core (port of ``src/repro/models/moe.py``).

``moe_block(p, x, cfg, comm)`` lays the tokens over the ranks the
communicator hosts as the JAX block's shard_map lays them over the mesh
(``_token_specs``, ``comm.shard_tokens``): ``LocalComm`` cuts the global
batch into contiguous row blocks, one per hosted rank; a ``DistComm``
process takes its own rows, and their S-slice when ``model`` is an EP axis.
Per rank: router, handle, staged dispatch, the SwiGLU expert FFN as three
grouped GEMMs over the rank's experts, staged combine. The expert weights
hold the experts of the hosted ranks in rank order, L each (all E for
``LocalComm``, a ``DistComm`` process's shard from ``weights.shard_params``);
with expert tensor parallelism (a ``model`` axis that is not an EP axis)
they hold an F-slice and the FFN's output is summed over ``model``. The aux
loss is the mean over the ranks that carry tokens. With no communicator, or
an EP extent of 1, it takes the dense reference path exactly as JAX does.
"""
from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F

from repro_torch.core import (EpGroupConfig, ep_combine, ep_complete,
                              ep_create_group, ep_create_handle, ep_dispatch)
from repro_torch.core import plan as P
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


def _expert_ffn(group, y3d, counts, w1, w3, w2):
    """Grouped SwiGLU over [L, A, D], rows past each count left zero; under
    expert-TP the partial sum of this process's F-slice."""
    if P.positional_layout(group):
        # rows land by position (baseline, LL deepep), not packed from row 0,
        # so every row is computed: unfilled rows are zero rows and combine
        # never reads them. The reference passes the counts for deepep and
        # zeroes valid rows (ROADMAP Queue C, tests/test_torch_layouts.py)
        counts = torch.full_like(counts, y3d.shape[1])
    g = K.grouped_gemm(y3d, w1, counts)
    u = K.grouped_gemm(y3d, w3, counts)
    h = (F.silu(g.float()) * u.float()).to(y3d.dtype)
    return K.grouped_gemm(h, w2, counts)


def _resolve_chunks(nc: int, tokens_per_rank: int) -> int:
    """Chunk count for this layer's per-rank token count. A configured count
    that does not tile the tokens cannot run (group creation would raise):
    fall back to the monolithic path, with a warning, so a preset that asks
    for the chunked pipeline never loses it without a trace."""
    if tokens_per_rank % nc == 0:
        return nc
    warnings.warn(
        f"ht_num_chunks={nc} does not divide tokens_per_rank="
        f"{tokens_per_rank} for this cell; running the monolithic (nc=1) "
        "hierarchical path instead", stacklevel=2)
    return 1


def ep_group(cfg: ArchConfig, comm, tokens_per_rank: int):
    """The EP group of ``cfg``'s MoE layers over ``comm``. The
    communicator's mesh axes are the EP axes and its innermost axis the pod
    (JAX reads both from the mesh, ``inner_size=ep_sizes[-1]``): over more
    than one axis an HT layer with ``ht_hierarchical`` takes the two-stage
    path, chunked ``ht_num_chunks`` ways, and any other the flat one."""
    m = cfg.moe
    gcfg = EpGroupConfig(
        num_experts=m.num_experts, max_tokens_per_rank=tokens_per_rank,
        hidden=cfg.d_model, top_k=m.top_k, mode=m.ep_mode, ll_layout=m.ll_layout,
        capacity_factor=m.capacity_factor,
        expert_capacity_factor=m.expert_capacity_factor,
        payload_dtype=cfg.dtype, quantize_dispatch=m.quantize_dispatch,
        ep_axis=comm.axis_names, ht_hierarchical=m.ht_hierarchical,
        ht_num_chunks=_resolve_chunks(m.ht_num_chunks, tokens_per_rank))
    return ep_create_group(gcfg, comm)


def ep_active(cfg: ArchConfig, comm) -> bool:
    """Whether ``cfg``'s MoE layers take the EP path over ``comm`` (else the
    dense fallback, on every expert's full weights)."""
    return comm is not None and comm.size > 1 and cfg.moe.num_experts % comm.size == 0


def moe_block(p, x: torch.Tensor, cfg: ArchConfig, comm):
    """x: [B, S, D] -> (y [B, S, D], aux_loss scalar)."""
    m = cfg.moe
    check_supported(m)
    if not ep_active(cfg, comm):
        return _moe_dense_fallback(p, x, cfg), torch.zeros((), device=x.device)
    parts = comm.shard_tokens(x)
    Bl, Sl, D = parts[0].shape
    T = Bl * Sl
    group = ep_group(cfg, comm, T)
    L = group.local_experts
    xs = [xp.reshape(T, D) for xp in parts]
    rcfg = router_config(m)
    rs = [route(xt.float() @ p["router"], rcfg, p.get("sel_bias")) for xt in xs]
    handles = ep_create_handle(group, [r.topk_idx for r in rs],
                               [r.topk_weights for r in rs])
    # staged send/complete is every backend's primitive (as in JAX); the
    # seam is where a micro-batching scheduler would overlap expert compute
    recv = ep_complete(group, handles, ep_dispatch(group, handles, xs, send_only=True))
    # hosted rank i's experts are rows [i*L, (i+1)*L) of the weights held here
    y3ds = [_expert_ffn(group, y3d, counts,
                        p["w_gate"][i * L:(i + 1) * L], p["w_up"][i * L:(i + 1) * L],
                        p["w_down"][i * L:(i + 1) * L])
            for i, (y3d, counts) in enumerate(recv)]
    if comm.tp_axis is not None:
        y3ds = comm.all_reduce(y3ds, axis=comm.tp_axis)     # expert-TP partials
    outs = ep_complete(group, handles, ep_combine(group, handles, y3ds, send_only=True))
    y = comm.unshard_tokens([o.to(x.dtype).reshape(Bl, Sl, D) for o in outs])
    # the mean over the ranks that carry tokens (JAX: pmean over the batch
    # and sequence axes; the value is the same along an expert-TP axis)
    sizes = dict(comm.mesh)
    aux = (comm.all_reduce([r.aux_loss + r.z_loss for r in rs], axis=comm.token_axes)[0]
           / math.prod(sizes[a] for a in comm.token_axes))
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
    experts = torch.arange(m.num_experts, device=x.device)
    oh = (r.topk_idx.long()[..., None] == experts).float()         # [T, K, E]
    gate = torch.einsum("tk,tke->te", r.topk_weights, oh)           # [T, E]
    y = torch.einsum("ted,te->td", y_all.float(), gate).to(x.dtype)
    y = y.reshape(B, S, D)
    if m.shared_experts:
        y = y + ffn_apply(p["shared"], x, cfg.act)
    return y
