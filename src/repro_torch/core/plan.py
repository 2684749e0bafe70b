"""EpPlan: the precomputed slot-map engine, LL ``nccl_ep`` layout (port of
the LL pieces of ``src/repro/core/plan.py``).

Every gather map and count of every LL phase is derived once, at handle
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
from repro_torch.core.group import EpGroup

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
    """One rank's precomputed LL maps (all int32)."""

    disp_send_gmap: torch.Tensor    # [N, C_d] slot -> local token row (sentinel T)
    disp_recv_gmap: torch.Tensor    # [L, A] expert slot -> recv row (sentinel N*C_d)
    disp_counts: torch.Tensor       # [L] capacity-aware recv counts
    comb_send_gmap: torch.Tensor    # [N, C_c] slot -> y3d flat row (sentinel L*A)
    comb_recv_rows: torch.Tensor    # [T, K] entry -> recv flat row (sentinel N*C_c)


def build_plan(group: EpGroup, rank: int, topk_idx: torch.Tensor,
               topk_global: torch.Tensor, num_tokens: int) -> EpPlan:
    """Derive rank ``rank``'s slot maps for the group's mode and layout."""
    if group.mode != "ll":
        raise NotImplementedError(
            f"EP mode {group.mode!r} is not ported yet (ROADMAP A5)")
    if group.cfg.ll_layout != "nccl_ep":
        raise NotImplementedError(
            "the deepep LL layout needs the standalone fp8 kernel (ROADMAP B5)")
    return _ll_ncclep_plan(group, rank, topk_idx, topk_global, num_tokens)


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
