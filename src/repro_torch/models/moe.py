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

EPLB (``MoESpec.placement``): L is the placement's slots per rank. In
physical mode (``params_physical``) the weights are already in slot order
(``checkpoint.adopt_expert_params`` at each adoption) and are sliced as
they are; in logical mode each hosted rank gathers its slots' experts from
the logical weights every step (``LocalComm`` only: over a ``DistComm`` it
would fetch remote experts every step, and is refused). ``with_heat=True``
also returns the routed-token histogram [E] f32 of the tokens routed here
(``placement.heat_from_topk``): over a ``LocalComm`` the global one; over a
``DistComm`` this process's rows, which the server sums over the token
axes at a window boundary (the reference ``psum``s it every step; the
counts are integers in f32, exact below 2**24, so the sums agree).
"""
from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F

from repro_torch.core import (EpGroupConfig, ep_combine, ep_complete,
                              ep_create_group, ep_create_handle, ep_dispatch)
from repro_torch.core import placement as PL
from repro_torch.core import plan as P
from repro_torch.core.routing import RouterConfig, route
from repro_torch.kernels import ops as K
from repro_torch.models.config import ArchConfig, ParamSpec
from repro_torch.models.layers import ffn_apply, ffn_spec


def _num_weight_rows(m) -> int:
    """Leading dim of the expert-stacked weights: the placement's slot
    count in physical mode (E when the placement is None or the identity),
    the logical E otherwise."""
    if m.params_physical and m.placement is not None:
        return m.placement.num_slots
    return m.num_experts


def moe_spec(cfg: ArchConfig, dtype=None):
    """Param specs. The expert-stacked weights (``EXPERT_PARAM_KEYS``,
    logical axis ``"expert"``) follow the layout mode: logical [E, ...], or
    physical [N*S, ...] under ``params_physical``; router and selection bias
    stay logical. A physical spec gives shapes only: random init draws the
    logical spec and adopts the placement once (``weights.init_params``),
    so replicas of one expert hold the same bits."""
    m, d = cfg.moe, cfg.d_model
    dtype = dtype or cfg.dtype
    f = m.d_ff_expert
    rows = _num_weight_rows(m)
    ex = ("expert", None, None)
    sp = dict(
        router=ParamSpec((d, m.num_experts), torch.float32),
        w_gate=ParamSpec((rows, d, f), dtype, axes=ex),
        w_up=ParamSpec((rows, d, f), dtype, axes=ex),
        w_down=ParamSpec((rows, f, d), dtype, axes=ex),
    )
    if m.use_selection_bias:
        sp["sel_bias"] = ParamSpec((m.num_experts,), torch.float32, init="zeros")
    if m.shared_experts:
        sp["shared"] = ffn_spec(d, m.shared_experts * f, dtype, cfg.act)
    return sp


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
        ht_num_chunks=_resolve_chunks(m.ht_num_chunks, tokens_per_rank),
        placement=m.placement)
    return ep_create_group(gcfg, comm)


def ep_active(cfg: ArchConfig, comm) -> bool:
    """Whether ``cfg``'s MoE layers take the EP path over ``comm`` (else the
    dense fallback, on every expert's full weights): more than one EP rank,
    over which the physical slots split evenly."""
    m = cfg.moe
    if comm is None or comm.size <= 1:
        return False
    if m.placement is not None and m.placement.num_ranks != comm.size:
        raise ValueError(f"MoESpec.placement spans {m.placement.num_ranks} ranks "
                         f"but the communicator's EP extent is {comm.size}")
    phys = m.placement.num_slots if m.placement is not None else m.num_experts
    return phys % comm.size == 0


def _expert_weights(p, m, comm, L: int) -> list:
    """(w_gate, w_up, w_down) of each hosted rank's L slots: rows of the
    physical weights held here, or (logical mode) the slots' experts
    gathered from the logical weights."""
    w1, w3, w2 = p["w_gate"], p["w_up"], p["w_down"]
    pl = m.placement
    if pl is None or m.params_physical:
        held = len(comm.ranks) * L
        if pl is not None and w1.shape[0] != held:
            raise ValueError(
                f"params_physical=True: the expert weights have {w1.shape[0]} rows "
                f"but the placement gives the {len(comm.ranks)} ranks held here "
                f"{held} slots: rebind at adoption (checkpoint.adopt_expert_params)")
        return [tuple(w[i * L:(i + 1) * L] for w in (w1, w3, w2))
                for i in range(len(comm.ranks))]
    if len(comm.ranks) != comm.size:
        raise NotImplementedError(
            "logical-mode expert weights under a placement over a DistComm would "
            "fetch every remote expert each step: serve with params_physical=True "
            "(ROADMAP A10b lists the logical mode over DistComm)")
    perm = PL.device_tables(pl, w1.device).slot_perm
    return [tuple(w.index_select(0, perm[r * L:(r + 1) * L]) for w in (w1, w3, w2))
            for r in comm.ranks]


def moe_block(p, x: torch.Tensor, cfg: ArchConfig, comm, *, with_heat: bool = False):
    """x: [B, S, D] -> (y [B, S, D], aux_loss scalar), and with
    ``with_heat`` the routed-token histogram [E] f32 as a third value."""
    m = cfg.moe
    if not ep_active(cfg, comm):
        aux = torch.zeros((), device=x.device)
        if with_heat:
            y, heat = _moe_dense_fallback(p, x, cfg, with_heat=True)
            return y, aux, heat
        return _moe_dense_fallback(p, x, cfg), aux
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
    ws = _expert_weights(p, m, comm, L)
    y3ds = [_expert_ffn(group, y3d, counts, *w) for (y3d, counts), w in zip(recv, ws)]
    del ws
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
    if not with_heat:
        return y, aux
    return y, aux, PL.heat_from_topk(torch.cat([r.topk_idx for r in rs]), m.num_experts)


def _moe_dense_fallback(p, x: torch.Tensor, cfg: ArchConfig, *, with_heat: bool = False):
    """Reference MoE with no EP communication: every expert on every token,
    gated by the same router. Same function as the EP path. Physical
    weights collapse to logical order through each expert's primary
    replica. With ``with_heat`` returns (y, heat [E])."""
    m = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    r = route(xt.float() @ p["router"], router_config(m), p.get("sel_bias"))
    w1, w3, w2 = p["w_gate"], p["w_up"], p["w_down"]
    if m.params_physical and m.placement is not None:
        w1, w3, w2 = (PL.collapse_expert_params(w, m.placement) for w in (w1, w3, w2))
    h_g = torch.einsum("td,edf->tef", xt, w1)
    h_u = torch.einsum("td,edf->tef", xt, w3)
    h = (F.silu(h_g.float()) * h_u.float()).to(x.dtype)
    y_all = torch.einsum("tef,efd->ted", h, w2)                     # [T, E, D]
    experts = torch.arange(m.num_experts, device=x.device)
    oh = (r.topk_idx.long()[..., None] == experts).float()         # [T, K, E]
    gate = torch.einsum("tk,tke->te", r.topk_weights, oh)           # [T, E]
    y = torch.einsum("ted,te->td", y_all.float(), gate).to(x.dtype)
    y = y.reshape(B, S, D)
    if m.shared_experts:
        y = y + ffn_apply(p["shared"], x, cfg.act)
    if with_heat:
        return y, PL.heat_from_topk(r.topk_idx, m.num_experts)
    return y
