"""EpPlan: the precomputed slot-map engine for LL (``nccl_ep`` and
``deepep`` layouts), the flat HT path and the baseline a2a dispatcher (port
of those pieces of ``src/repro/core/plan.py``).

Every gather map and count of every phase is derived once, at handle
creation, so dispatch and combine are single gather passes over int32 maps
(the one-pass-per-phase invariant). A map value equal to the source row
count is the empty sentinel. The JAX functions read their rank from
``axis_index``; here it comes in as an argument.

Port notes: JAX's ``.at[...].set(..., mode="drop")`` becomes a masked
scatter (torch indexing raises out of range, and the padding expert E maps
to rank N); int32 cumsums are cast back from int64.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import slots as S
from repro_torch.core.group import EpGroup, EpHandle

_MASK32 = 0xFFFFFFFF


def dest_of(group: EpGroup, experts: torch.Tensor):
    """(dest_rank, dest_slot) of global expert ids under the contiguous
    layout: expert e lives at rank e // L, slot e % L. The padding expert E
    maps to rank N, out of range everywhere."""
    L = group.local_experts
    r = torch.div(experts, L, rounding_mode="floor")
    return r, experts - r * L


@dataclasses.dataclass
class EpPlan:
    """One rank's precomputed maps (all int32). The positional layouts (LL
    ``deepep``, baseline) land rows by position, so their recv and combine
    send read no map and leave those two fields None."""

    disp_send_gmap: torch.Tensor    # [N, C_d] slot -> local token row (sentinel T)
    disp_counts: torch.Tensor       # [L] recv counts (capacity-aware in nccl_ep, HT)
    comb_recv_rows: torch.Tensor    # [T, K] entry -> recv flat row (sentinel N*C_c)
    disp_recv_gmap: torch.Tensor | None = None  # [L, A] expert slot -> recv row
    comb_send_gmap: torch.Tensor | None = None  # [N, C_c] slot -> y3d flat row


def build_plan(group: EpGroup, rank: int, topk_idx: torch.Tensor,
               topk_global: torch.Tensor, num_tokens: int) -> EpPlan:
    """Derive rank ``rank``'s slot maps for the group's mode and layout.
    HT is the flat path: ``ep_create_group`` refuses a hierarchical group."""
    mode = group.mode
    if mode == "ll":
        if group.cfg.ll_layout == "deepep":
            return _ll_deepep_plan(group, rank, topk_idx, topk_global, num_tokens)
        return _ll_ncclep_plan(group, rank, topk_idx, topk_global, num_tokens)
    if mode == "ht":
        return _ht_flat_plan(group, rank, topk_idx, topk_global, num_tokens)
    return _baseline_plan(group, rank, topk_idx, topk_global, num_tokens)


def positional_layout(group: EpGroup) -> bool:
    """Whether the group's rows land by position (LL ``deepep``, baseline):
    slot (expert, source rank, token) is fixed, so the recv and the combine
    send are transposes, and an expert's rows are not packed from row 0."""
    return group.mode == "baseline" or (group.mode == "ll"
                                        and group.cfg.ll_layout == "deepep")


def per_rank(value, n: int) -> list:
    """One value per hosted rank: a list or tuple as given, else ``value``
    repeated ``n`` times."""
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def ensure_plan(group: EpGroup, handle) -> EpPlan:
    """The handle's plan, derived on the spot for a hand-built handle."""
    if handle.plan is not None:
        return handle.plan
    return build_plan(group, handle.rank, handle.topk_idx, handle.topk_global,
                      handle.num_tokens)


# --------------------------------------------------------------------------
# routing hash (uint32 lanes, computed in int64 since torch uint32 lacks >>)
# --------------------------------------------------------------------------

def _mulu32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanche over uint32 lanes."""
    x = _mulu32(x ^ (x >> 16), 0x7FEB352D)
    x = _mulu32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def routing_hash(topk_idx: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Order-sensitive [2]-lane checksum of a routing tensor, equal to the
    JAX package's uint32 ``routing_hash`` (returned as int64 values)."""
    flat = topk_idx.reshape(-1).to(torch.int64) & _MASK32
    i = torch.arange(flat.shape[0], dtype=torch.int64, device=flat.device)
    h1 = _mix((flat + _mulu32(i, 0x9E3779B9)) & _MASK32).sum() & _MASK32
    h2 = _mix(flat ^ _mulu32(i + 1, 0x85EBCA6B)).sum() & _MASK32
    h = torch.stack([h1, h2])
    if salt:
        s = torch.tensor(salt & _MASK32, dtype=torch.int64, device=h.device)
        h = h ^ torch.stack([_mix(s), _mix(s ^ 0x9E3779B9)])
    return h


# --------------------------------------------------------------------------
# shared create prologue
# --------------------------------------------------------------------------

def mask_padding(group: EpGroup, topk_idx: torch.Tensor, num_tokens):
    """Route padded rows (t >= num_tokens) to the sentinel expert E, which
    lands out of every rank's range. Returns (topk_idx, num_tokens)."""
    T = topk_idx.shape[0]
    if num_tokens is None:
        return topk_idx, T
    pad = torch.arange(T, device=topk_idx.device)[:, None] >= num_tokens
    return torch.where(pad, group.cfg.num_experts, topk_idx), int(num_tokens)


def make_handle(group: EpGroup, rank: int, topk_idx: torch.Tensor,
                topk_global: torch.Tensor, topk_weights: torch.Tensor,
                num_tokens: int) -> EpHandle:
    """Rank ``rank``'s handle on the gathered routing: its receive counts,
    routing hash and a freshly built plan."""
    counts = recv_counts(group, rank, topk_global)
    return EpHandle(
        rank=rank, topk_idx=topk_idx, topk_weights=topk_weights,
        topk_global=topk_global, tokens_per_expert=counts,
        num_recv_tokens=counts.sum(), num_tokens=num_tokens,
        plan=build_plan(group, rank, topk_idx, topk_global, num_tokens),
        routing_hash=routing_hash(topk_global, group.placement_salt))


def gather_routing(group: EpGroup, topk_idx: list) -> list:
    """All-gather every hosted rank's [T, K] routing into [N, T, K], rank
    order row-major (the one metadata exchange of handle creation)."""
    return group.comm.all_gather(list(topk_idx))


def recv_counts(group: EpGroup, rank: int, topk_g: torch.Tensor) -> torch.Tensor:
    """[L] entries routed to each of ``rank``'s experts (capacity-blind)."""
    L = group.local_experts
    r_dst, s_dst = dest_of(group, topk_g)
    mine = (r_dst == rank).reshape(-1).to(torch.int32)
    e_l = s_dst.clamp(0, L - 1).reshape(-1).to(torch.int64)
    counts = torch.zeros((L,), dtype=torch.int32, device=topk_g.device)
    return counts.scatter_add_(0, e_l, mine)


# --------------------------------------------------------------------------
# LL nccl_ep layout (paper §IV-D)
# --------------------------------------------------------------------------

def _ll_ncclep_plan(group: EpGroup, me: int, topk_idx: torch.Tensor,
                    topk_g: torch.Tensor, num_tokens: int) -> EpPlan:
    """Dispatch dedups per destination rank; combine packs responses per
    (t, k). Four maps, one per phase."""
    N, L = group.ep_size, group.local_experts
    Cd, Cc, A = group.ll_disp_cap, group.ll_comb_cap, group.ll_expert_cap
    T, Kk = topk_idx.shape
    dev = topk_idx.device
    i32 = torch.int32

    # ---- sender side: slot of token t in the me->d block is the running
    # count of senders to d up to t (the "atomic counter")
    dst, _ = dest_of(group, topk_idx)                        # [T, K]
    token_valid = torch.arange(T, device=dev) < num_tokens
    sends = torch.zeros((T, N + 1), dtype=torch.bool, device=dev)
    col = torch.where((dst >= 0) & (dst < N), dst, N).to(torch.int64)
    sends.scatter_(1, col, True)                             # column N is trash
    sends = sends[:, :N] & token_valid[:, None]              # [T, N] rank dedup
    pos = (torch.cumsum(sends.to(i32), 0) - 1).to(i32)       # [T, N]
    t_idx = torch.arange(T, device=dev)[:, None].expand(T, N).reshape(-1)
    d_idx = torch.arange(N, device=dev)[None, :].expand(T, N).reshape(-1)
    disp_send_gmap = S.build_gather_map(d_idx, pos.reshape(-1), t_idx,
                                        sends.reshape(-1), N, Cd, sentinel=T)

    # ---- receiver side: mirror the senders' counters
    dst_g, slot_g = dest_of(group, topk_g)                   # [N, T, K]
    mine = dst_g == me
    e_l = slot_g.clamp(0, L - 1).reshape(-1)
    sends_to_me = mine.any(-1)                               # [N, T]
    pos_to_me = (torch.cumsum(sends_to_me.to(i32), 1) - 1).to(i32)
    slot_valid = sends_to_me & (pos_to_me < Cd)
    recv_row = torch.arange(N, device=dev, dtype=i32)[:, None] * Cd + pos_to_me
    ent_valid = (mine & slot_valid[:, :, None]).reshape(-1)
    a_pos, counts = S.positions_by_dest(e_l, L, ent_valid)
    rows_src = recv_row[:, :, None].expand(N, T, Kk).reshape(-1)
    disp_recv_gmap = S.build_gather_map(e_l, a_pos, rows_src, ent_valid, L, A,
                                        sentinel=N * Cd)

    # ---- combine send (expert side): the same a_pos chain, packed per src
    y_row = e_l * A + a_pos                                  # flat row into y3d
    r_of = torch.arange(N, device=dev, dtype=i32)[:, None, None].expand(N, T, Kk).reshape(-1)
    c_pos, _ = S.positions_by_dest(r_of, N, ent_valid)
    comb_send_gmap = S.build_gather_map(r_of, c_pos, y_row,
                                        ent_valid & (a_pos < A), N, Cc,
                                        sentinel=L * A)

    # ---- combine recv (source side): entry (t, k) sits at the running count
    # its owner used; dispatch drops propagate
    dst_c = dst.clamp(0, N - 1).to(torch.int64)
    tok_slot_ok = torch.take_along_dim(pos, dst_c, dim=1) < Cd
    ent_valid2 = (tok_slot_ok & token_valid[:, None]).reshape(-1)
    c_pos2, _ = S.positions_by_dest(dst.reshape(-1), N, ent_valid2)
    row = torch.where(ent_valid2 & (c_pos2 < Cc),
                      dst_c.reshape(-1) * Cc + c_pos2, N * Cc)
    return EpPlan(
        disp_send_gmap=disp_send_gmap, disp_recv_gmap=disp_recv_gmap,
        disp_counts=counts, comb_send_gmap=comb_send_gmap,
        comb_recv_rows=row.reshape(T, Kk).to(i32),
    )


def _ll_deepep_plan(group: EpGroup, me: int, topk_idx: torch.Tensor,
                    topk_g: torch.Tensor, num_tokens: int) -> EpPlan:
    """Per-(expert, src-rank)-slot layout: slot ids are positional
    (e_l·B + t), so recv and combine send are pure transposes; only the
    send map and the combine rows are precomputed."""
    N, L = group.ep_size, group.local_experts
    B = group.cfg.max_tokens_per_rank
    T, Kk = topk_idx.shape
    if T > B:
        raise ValueError(f"the deepep layout holds B={B} tokens per rank, got {T}")
    dev = topk_idx.device
    dst, e_l = dest_of(group, topk_idx)                      # [T, K]
    token_valid = torch.arange(T, device=dev) < num_tokens
    t_idx = torch.arange(T, device=dev)[:, None].expand(T, Kk)
    disp_send_gmap = S.build_gather_map(
        dst.reshape(-1), (e_l * B + t_idx).reshape(-1), t_idx.reshape(-1),
        token_valid[:, None].expand(T, Kk).reshape(-1), N, L * B, sentinel=T)
    row = torch.where(token_valid[:, None], dst * (L * B) + e_l * B + t_idx,
                      N * L * B)
    return EpPlan(disp_send_gmap=disp_send_gmap,
                  disp_counts=recv_counts(group, me, topk_g),
                  comb_recv_rows=row.to(torch.int32))


# --------------------------------------------------------------------------
# HT flat path (paper §V, single EP axis)
# --------------------------------------------------------------------------

def _ht_flat_plan(group: EpGroup, me: int, topk_idx: torch.Tensor,
                  topk_g: torch.Tensor, num_tokens: int) -> EpPlan:
    """Entry-level all-to-all: every (t, k) is its own slot in the me->d
    block; combine mirrors the dispatch slots exactly (the deterministic
    Fig. 4 layout). Entries past the pair capacity C or the expert region A
    are dropped."""
    N, L = group.ep_size, group.local_experts
    C, A = group.ht_pair_cap, group.ht_expert_cap
    T, Kk = topk_idx.shape
    dev = topk_idx.device
    i32 = torch.int32

    # ---- sender side
    dst = dest_of(group, topk_idx)[0].reshape(-1)           # [T*K]
    valid = (torch.arange(T, device=dev) < num_tokens)[:, None].expand(T, Kk).reshape(-1)
    c_pos, _ = S.positions_by_dest(dst, N, valid)
    t_of = torch.arange(T, device=dev)[:, None].expand(T, Kk).reshape(-1)
    disp_send_gmap = S.build_gather_map(dst, c_pos, t_of, valid, N, C, sentinel=T)

    # ---- receiver side: every sender's counter restricted to me
    dst_g, slot_g = dest_of(group, topk_g)                  # [N, T, K]
    e_l = slot_g.clamp(0, L - 1).reshape(-1)
    flat_mine = (dst_g == me).reshape(N, T * Kk)
    pos_r = (torch.cumsum(flat_mine.to(i32), 1) - 1).to(i32)
    ent_valid = (flat_mine & (pos_r < C)).reshape(-1)
    rows = torch.arange(N, device=dev, dtype=i32)[:, None] * C + pos_r
    a_pos, counts = S.positions_by_dest(e_l, L, ent_valid)
    disp_recv_gmap = S.build_gather_map(e_l, a_pos, rows.reshape(-1), ent_valid,
                                        L, A, sentinel=N * C)

    # ---- combine send: y3d rows back into the mirrored [N, C] blocks
    y_row = e_l * A + a_pos
    r_of = torch.arange(N, device=dev, dtype=i32)[:, None].expand(N, T * Kk).reshape(-1)
    comb_send_gmap = S.build_gather_map(r_of, pos_r.reshape(-1), y_row,
                                        ent_valid & (a_pos < A), N, C,
                                        sentinel=L * A)

    # ---- combine recv: my own dispatch slots
    row = torch.where(valid & (c_pos < C), dst.clamp(0, N - 1) * C + c_pos, N * C)
    return EpPlan(
        disp_send_gmap=disp_send_gmap, disp_recv_gmap=disp_recv_gmap,
        disp_counts=counts, comb_send_gmap=comb_send_gmap,
        comb_recv_rows=row.reshape(T, Kk).to(i32),
    )


# --------------------------------------------------------------------------
# baseline (Megatron AllToAll dispatcher, paper §I)
# --------------------------------------------------------------------------

def _baseline_plan(group: EpGroup, me: int, topk_idx: torch.Tensor,
                   topk_g: torch.Tensor, num_tokens: int) -> EpPlan:
    """Per-(expert, src) capacity blocks of Ce slots: dispatch permute and
    combine unpermute share the same position chain. Padded rows already
    route to the sentinel expert E (``mask_padding``)."""
    from repro_torch.core.baseline import _per_expert_cap  # baseline imports plan
    N, L = group.ep_size, group.local_experts
    T, Kk = topk_idx.shape
    Ce = _per_expert_cap(group)
    dev = topk_idx.device
    dst, e_l = dest_of(group, topk_idx)                      # [T, K]
    valid = (topk_idx < group.cfg.num_experts).reshape(-1)
    block = torch.where(valid, (dst * L + e_l).reshape(-1), N * L)
    pos, _ = S.positions_by_dest(block, N * L, valid)
    t_of = torch.arange(T, device=dev)[:, None].expand(T, Kk).reshape(-1)
    gmap = S.build_gather_map(block, pos, t_of, valid, N * L, Ce, sentinel=T)
    row = torch.where(valid & (pos < Ce), block.clamp(0, N * L - 1) * Ce + pos,
                      N * L * Ce)
    return EpPlan(disp_send_gmap=gmap.reshape(N, L * Ce),
                  disp_counts=recv_counts(group, me, topk_g),
                  comb_recv_rows=row.reshape(T, Kk).to(torch.int32))


# --------------------------------------------------------------------------
# handle refresh (the steady-state decode path)
# --------------------------------------------------------------------------

def _plan_shape_compatible(group: EpGroup, plan: EpPlan) -> bool:
    """True when the cached plan's maps have the shapes this group would
    rebuild, which the select of ``refresh_handle`` needs. A placement swap
    that changes the per-rank slot count changes every expert-region map."""
    c = plan.disp_counts
    return c is None or c.shape[0] == group.local_experts


def rebind_weights(group: EpGroup, plan: EpPlan | None,
                   topk_weights: torch.Tensor) -> EpPlan | None:
    """Rebind combine weights into a plan without touching a slot map. Only
    the hierarchical HT plan embeds weights (ROADMAP A5); every plan the
    port builds is weight-free and comes back unchanged (the same object, so
    callers can assert map reuse by identity)."""
    return plan


def refresh_handle(group: EpGroup, handles: list, topk_weights: list,
                   topk_idx: list | None = None, num_tokens=None) -> list[EpHandle]:
    """Rebind per-step routing into existing handles, one per hosted rank
    (public name ``ep_handle_refresh``).

    With ``topk_idx`` None (or each rank's very own tensor) the routing is
    unchanged by construction: every slot map is reused and only the combine
    weights are rebound. With a new ``topk_idx`` the routing is gathered
    and hashed; a handle whose maps have the rebuild's shapes gets each map
    as ``torch.where(same, cached, rebuilt)``, with ``same`` the comparison
    of the hashes on the device: no value is read back to the host, so the
    refresh can be captured in a CUDA graph, and the maps are the cached
    ones on a replayed routing and a fresh build's on a changed one (JAX
    takes the same decision with ``lax.cond``; the select computes the
    rebuild either way). A hand-built handle, a new token count or a
    changed slot layout rebuilds unconditionally, like handle creation."""
    n = len(handles)
    if topk_idx is None or all(t is h.topk_idx for t, h in zip(topk_idx, handles)):
        if num_tokens is not None:
            # the padding sentinel is baked into topk_idx: a new valid-token
            # count without new routing is ill-defined
            raise ValueError("num_tokens requires topk_idx on refresh")
        out = []
        for h, w in zip(handles, topk_weights):
            if h.plan is not None and not _plan_shape_compatible(group, h.plan):
                raise ValueError(
                    "weights-only refresh got a handle built under a different "
                    "physical slot layout; refresh with topk_idx so the "
                    "routing hash can force the rebuild")
            out.append(dataclasses.replace(h, topk_weights=w,
                                           plan=rebind_weights(group, h.plan, w)))
        return out

    masked = [mask_padding(group, t, nt)
              for t, nt in zip(topk_idx, per_rank(num_tokens, n))]
    topk_gs = gather_routing(group, [m[0] for m in masked])
    out = []
    for h, (tk, nt), tg, w in zip(handles, masked, topk_gs, topk_weights):
        new = make_handle(group, h.rank, tk, tg, w, nt)
        if (h.plan is not None and h.routing_hash is not None
                and tk.shape == h.topk_idx.shape
                and _plan_shape_compatible(group, h.plan)):
            same = (new.routing_hash == h.routing_hash).all()
            new.plan = EpPlan(**{
                f.name: (None if getattr(new.plan, f.name) is None else
                         torch.where(same, getattr(h.plan, f.name), getattr(new.plan, f.name)))
                for f in dataclasses.fields(EpPlan)})
        new.plan = rebind_weights(group, new.plan, w)
        out.append(new)
    return out
