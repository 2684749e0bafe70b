"""EpPlan: the precomputed slot-map engine for LL (``nccl_ep`` and
``deepep`` layouts), HT (flat and hierarchical, chunked) and the baseline
a2a dispatcher (port of ``src/repro/core/plan.py``), placement-aware.

Every gather map and count of every phase is derived once, at handle
creation, so dispatch and combine are single gather passes over int32 maps
(the one-pass-per-phase invariant). A map value equal to the source row
count is the empty sentinel. The JAX functions read their rank from
``axis_index``; here it comes in as an argument.

Placement (``core/placement.py``) is resolved here and nowhere else:
``dest_of`` maps a logical expert to its physical (rank, slot), under an
``EpPlacement`` by a lookup in device tables made once per placement, with
replica ``src_rank % replica_count``; the phases only gather through the
maps this module builds.

Port notes: JAX's ``.at[...].set(..., mode="drop")`` becomes a scatter
into a trash column or slot past the end that is sliced off (torch
indexing raises out of range, and the padding expert E maps to rank N);
int32 cumsums are cast back from int64.

The hierarchical combine sums in three places, where JAX scatter-adds. A
CUDA scatter-add accumulates with atomics in a run-dependent order, so the
plan also inverts each of those scatters into a fixed-order gather map
(``h_slot_rows``, ``h_rail_rows``; ``h_src_rows`` is one already), and
``core/ht.py`` runs each sum as one ``combine_gather_reduce``: f32, in the
map's k order, the same contributors in the same order for any chunk count.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import placement as PL
from repro_torch.core import slots as S
from repro_torch.core.group import EpGroup, EpHandle

_MASK32 = 0xFFFFFFFF


def dest_of(group: EpGroup, experts: torch.Tensor, src_rank=0):
    """(dest_rank, dest_slot) of global expert ids. Contiguous layout:
    expert e lives at rank e // L, slot e % L. Under an ``EpPlacement``:
    the table lookup, replica ``src_rank % replica_count`` (an int, or a
    tensor broadcastable to ``experts``: a pure function of the gathered
    routing, so both ends of every transfer agree). The padding expert E
    maps to rank N, out of range everywhere. Entries not owned by the
    caller return their slot at *their* rank: mask by ``dest_rank == me``
    before using slots locally."""
    if group.placement is None:
        L = group.local_experts
        r = torch.div(experts, L, rounding_mode="floor")
        return r, experts - r * L
    r, sl = PL.assign(group.placement, experts, src_rank)
    return r.to(experts.dtype), sl.to(experts.dtype)


def _src_rank_grid(group: EpGroup, device) -> torch.Tensor | int:
    """Source-rank coordinates [N, 1, 1] of a gathered routing tensor [N,
    T, K]: the replica key of receiver-side ``dest_of``. The contiguous
    layout reads none, so it gets 0 and the plan launches nothing for it."""
    if group.placement is None:
        return 0
    return torch.arange(group.ep_size, device=device)[:, None, None]


@dataclasses.dataclass
class EpPlan:
    """One rank's precomputed maps (all int32 but ``h_w_slot``). Fields the
    group's mode does not use are None: the positional layouts (LL
    ``deepep``, baseline) land rows by position, so their recv and combine
    send read no map; the hierarchical path has its own stage maps."""

    disp_send_gmap: torch.Tensor | None = None  # [N, C_d] slot -> token row (sentinel T)
    disp_counts: torch.Tensor | None = None     # [L] recv counts (capacity-aware)
    comb_recv_rows: torch.Tensor | None = None  # [T, K] entry -> recv row (sentinel N*C_c)
    disp_recv_gmap: torch.Tensor | None = None  # [L, A] expert slot -> recv row
    #   (hierarchical: rows of the nc-chunk concatenation of the stage-2
    #   receives, sentinel nc*No*C2)
    comb_send_gmap: torch.Tensor | None = None  # [N, C_c] slot -> y3d flat row
    # -- HT hierarchical (leading nc axis: the chunks of the token dim) --
    h_gmap1: torch.Tensor | None = None          # [nc, Ni, C1] stage-1 slot -> token
    h_gmap2: torch.Tensor | None = None          # [nc, No, C2] stage-2 slot -> recv1 row
    h_slot_tgt: torch.Tensor | None = None       # [L*A] y3d slot -> stage-2 row
    h_w_slot: torch.Tensor | None = None         # [L*A] f32 combine weight per slot
    h_rail_dst_rows: torch.Tensor | None = None  # [nc, No, Ni*Tc] rail sum dst
    h_rail_src_rows: torch.Tensor | None = None  # [nc, No, Ni*Tc] rail sum src
    h_src_rows: torch.Tensor | None = None       # [T, Ni] source gather (sentinel nc*Ni*C1)
    h_entry_slot: torch.Tensor | None = None     # [N*T*K] entry -> y3d slot (sentinel L*A)
    # the port's fixed-order inverses of the two scatter-adds above
    h_slot_rows: torch.Tensor | None = None      # [nc*No*C2, min(K, L)] stage-2 row
    #   -> its y3d slots in ascending order (sentinel L*A)
    h_rail_rows: torch.Tensor | None = None      # [nc, Ni*C1, No] rail row -> the
    #   stage-2 combine row of each pod in pod order (sentinel No*C2)


def build_plan(group: EpGroup, rank: int, topk_idx: torch.Tensor,
               topk_global: torch.Tensor, num_tokens: int,
               weights_global: torch.Tensor | None = None) -> EpPlan:
    """Derive rank ``rank``'s slot maps for the group's mode and layout.
    The hierarchical plan binds the gathered combine weights
    ``weights_global`` [N, T, K] through ``rebind_weights``; every other
    plan is weight-free."""
    mode = group.mode
    if mode == "ll":
        if group.cfg.ll_layout == "deepep":
            return _ll_deepep_plan(group, rank, topk_idx, topk_global, num_tokens)
        return _ll_ncclep_plan(group, rank, topk_idx, topk_global, num_tokens)
    if mode == "ht":
        if group.hierarchical:
            plan = _ht_hier_plan(group, rank, topk_idx, topk_global, num_tokens)
            if weights_global is not None:
                plan = rebind_weights(group, plan, weights_global)
            return plan
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
    """The handle's plan, derived on the spot for a hand-built handle (the
    hierarchical plan's weights come from ``ensure_plans``)."""
    if handle.plan is not None:
        return handle.plan
    return build_plan(group, handle.rank, handle.topk_idx, handle.topk_global,
                      handle.num_tokens)


def ensure_plans(group: EpGroup, handles: list) -> list[EpPlan]:
    """Every hosted rank's plan; hand-built handles get theirs derived, the
    hierarchical ones with the group's gathered combine weights."""
    if all(h.plan is not None for h in handles):
        return [h.plan for h in handles]
    w_gs = gather_weights(group, [h.topk_weights for h in handles])
    return [h.plan if h.plan is not None else
            build_plan(group, h.rank, h.topk_idx, h.topk_global, h.num_tokens, wg)
            for h, wg in zip(handles, w_gs)]


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
    if salt:
        # mixed on the host: a captured step makes no tensor from host data
        s = salt & _MASK32
        h1, h2 = h1 ^ _mix_int(s), h2 ^ _mix_int(s ^ 0x9E3779B9)
    return torch.stack([h1, h2])


def _mix_int(x: int) -> int:
    """``_mix`` of one uint32 on the host."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _MASK32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


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
                num_tokens: int, weights_global: torch.Tensor | None = None) -> EpHandle:
    """Rank ``rank``'s handle on the gathered routing: its receive counts,
    routing hash and a freshly built plan (``weights_global`` from
    ``gather_weights``)."""
    counts = recv_counts(group, rank, topk_global)
    return EpHandle(
        rank=rank, topk_idx=topk_idx, topk_weights=topk_weights,
        topk_global=topk_global, tokens_per_expert=counts,
        num_recv_tokens=counts.sum(), num_tokens=num_tokens,
        plan=build_plan(group, rank, topk_idx, topk_global, num_tokens,
                        weights_global),
        routing_hash=routing_hash(topk_global, group.placement_salt))


def gather_routing(group: EpGroup, topk_idx: list) -> list:
    """All-gather every hosted rank's [T, K] routing into [N, T, K], rank
    order row-major (the one metadata exchange of handle creation)."""
    return group.comm.all_gather(list(topk_idx))


def gather_weights(group: EpGroup, topk_weights: list) -> list:
    """Every hosted rank's [N, T, K] gathered combine weights where the
    group's plan embeds them (the hierarchical ``h_w_slot``), else None per
    rank: no other plan reads weights, so nothing is exchanged. Gathered
    detached: under autograd the weights' gradient has one route, the EP
    combine's explicit inputs (``core/ll.py EpCombine``), whose backward
    returns it to each source rank."""
    if not group.hierarchical:
        return [None] * len(topk_weights)
    return group.comm.all_gather([w.detach() for w in topk_weights])


def recv_counts(group: EpGroup, rank: int, topk_g: torch.Tensor) -> torch.Tensor:
    """[L] entries routed to each of ``rank``'s expert slots
    (capacity-blind); under a redundant placement each entry counts at the
    replica its source rank selects."""
    L = group.local_experts
    r_dst, s_dst = dest_of(group, topk_g, _src_rank_grid(group, topk_g.device))
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
    dst, _ = dest_of(group, topk_idx, me)                    # [T, K]
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
    dst_g, slot_g = dest_of(group, topk_g, _src_rank_grid(group, dev))  # [N, T, K]
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
    dst, e_l = dest_of(group, topk_idx, me)                  # [T, K]
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
    dst = dest_of(group, topk_idx, me)[0].reshape(-1)       # [T*K]
    valid = (torch.arange(T, device=dev) < num_tokens)[:, None].expand(T, Kk).reshape(-1)
    c_pos, _ = S.positions_by_dest(dst, N, valid)
    t_of = torch.arange(T, device=dev)[:, None].expand(T, Kk).reshape(-1)
    disp_send_gmap = S.build_gather_map(dst, c_pos, t_of, valid, N, C, sentinel=T)

    # ---- receiver side: every sender's counter restricted to me
    dst_g, slot_g = dest_of(group, topk_g, _src_rank_grid(group, dev))  # [N, T, K]
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
# HT hierarchical path (paper §V, Hybrid-EP's two-tier scheme)
# --------------------------------------------------------------------------

def rank_pod(rank, inner_size: int):
    """Pod (outer) coordinate of an EP rank: ranks are row-major over
    (pod, inner), so the pod is ``rank // inner_size``. Works on ints and
    on integer tensors elementwise."""
    return rank // inner_size


def _set_true(shape: tuple, dim_size: int, idx: torch.Tensor) -> torch.Tensor:
    """Boolean [*shape, dim_size]: entry idx[..., k] of each row set, for
    every k; an index equal to ``dim_size`` lands in a trash column that is
    cut off (JAX's ``.at[..., idx].set(True, mode="drop")``)."""
    out = torch.zeros(tuple(shape) + (dim_size + 1,), dtype=torch.bool, device=idx.device)
    out.scatter_(-1, idx.to(torch.int64), True)
    return out[..., :dim_size]


def _cumsum_pos(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive running count minus one, in int32."""
    return (torch.cumsum(x.to(torch.int32), dim) - 1).to(torch.int32)


def _hier_geometry(group: EpGroup, topk_g: torch.Tensor) -> dict:
    """Global stage-1 maps of one chunk [N, Tc, K], computed identically for
    every rank."""
    Ni, No = group.inner_size, group.outer_size
    C1 = group.ht_stage1_cap
    N, T, Kk = topk_g.shape
    g = topk_g.reshape(No, Ni, T, Kk)
    src = torch.arange(No * Ni, device=g.device).reshape(No, Ni, 1, 1)
    r_dst, s_dst = dest_of(group, g, src)                   # placement-aware
    o_dst, i_dst = rank_pod(r_dst, Ni), r_dst % Ni          # [No, Ni, T, K]
    # stage 1 (per source rank): dedup over the destination's inner
    # coordinate. The padding expert has r_dst == N, whose i_dst could alias
    # a real coordinate: mask by validity first
    ent_ok = r_dst < No * Ni
    sends1 = _set_true((No, Ni, T), Ni, torch.where(ent_ok, i_dst, Ni))
    pos1 = _cumsum_pos(sends1, 2)                           # over tokens
    ok1 = sends1 & (pos1 < C1)
    return dict(r_dst=r_dst, s_dst=s_dst, o_dst=torch.where(ent_ok, o_dst, No),
                i_dst=torch.where(ent_ok, i_dst, Ni), sends1=sends1, pos1=pos1,
                ok1=ok1)


def _hier_recv_chain(group: EpGroup, geo: dict, me_o: int, me_i: int):
    """For every (o_s, r_i, t): the stage-2 slot c2 at source pod o_s's rail
    of inner coordinate me_i, sending to pod me_o, and its validity."""
    No = group.outer_size
    C2 = group.ht_stage2_cap
    _, Ni, T = geo["sends1"].shape[:3]
    held = geo["ok1"][:, :, :, me_i]                        # [No, Ni, T]
    needs_me = ((geo["i_dst"] == me_i) & (geo["o_dst"] == me_o)).any(-1)
    fanned = held & needs_me
    # c2: the running count in (r_i, t) order per source pod, the rail's
    # flat (r_i*C1 + pos1) order since pos1 grows with t
    c2 = _cumsum_pos(fanned.reshape(No, Ni * T), 1).reshape(No, Ni, T)
    return c2, fanned & (c2 < C2)


def _ht_hier_plan(group: EpGroup, me: int, topk_idx: torch.Tensor,
                  topk_g: torch.Tensor, num_tokens: int) -> EpPlan:
    """Two stages, chunked: the token dim splits into ``ht_num_chunks``
    static slices and every map of the dispatch chain (stage-1 dedup,
    stage-2 fan-out) and of the mirror combine chain (rail partial sums) is
    derived per chunk, so ``core/ht.py`` can stream the slices. The
    destination-side maps (``disp_recv_gmap``, ``h_entry_slot``,
    ``h_src_rows``) stay global: expert-region positions are counted over
    the monolithic entry order, with rows offset into the chunk
    concatenation of the stage buffers, which makes the chunked path
    bitwise equal to nc = 1 at zero-drop capacities. Weight-free: weights
    are bound afterwards by ``rebind_weights``."""
    L, Ni, No = group.local_experts, group.inner_size, group.outer_size
    C1, C2, A = group.ht_stage1_cap, group.ht_stage2_cap, group.ht_expert_cap
    me_o, me_i = me // Ni, me % Ni
    T, Kk = topk_idx.shape
    nc = group.ht_chunks(T)
    Tc = T // nc
    dev = topk_idx.device
    i32 = torch.int32
    ar_i = torch.arange(Ni, device=dev, dtype=i32)
    ar_o = torch.arange(No, device=dev, dtype=i32)

    g1_c, g2_c = [], []
    el_c, entv_c, rows_c = [], [], []
    rail_dst_c, rail_src_c, src_rows_c = [], [], []
    for c in range(nc):
        geo = _hier_geometry(group, topk_g[:, c * Tc:(c + 1) * Tc])

        # ---- stage-1 send map: rows are token indices over the whole [T, H]
        s1 = geo["sends1"][me_o, me_i]                      # [Tc, Ni]
        p1 = geo["pos1"][me_o, me_i]
        t_of = (c * Tc + torch.arange(Tc, device=dev, dtype=i32))[:, None].expand(Tc, Ni)
        i_of = ar_i[None, :].expand(Tc, Ni)
        g1_c.append(S.build_gather_map(i_of.reshape(-1), p1.reshape(-1),
                                       t_of.reshape(-1), s1.reshape(-1), Ni, C1,
                                       sentinel=T))

        # ---- stage-2 fan map: rail (me_o, me_i) fans the chunk's held
        # tokens over destination pods (rows of this chunk's recv1 buffer)
        need = geo["i_dst"][me_o] == me_i                   # [Ni, Tc, K]
        fan = _set_true((Ni, Tc), No, torch.where(need, geo["o_dst"][me_o], No))
        ok1_me = geo["ok1"][me_o, :, :, me_i]               # [Ni, Tc] held?
        fan = (fan & ok1_me[..., None]).reshape(-1)
        o_b = ar_o[None, None, :].expand(Ni, Tc, No).reshape(-1)
        pos2, _ = S.positions_by_dest(o_b, No, fan)
        p1i = geo["pos1"][me_o, :, :, me_i]                 # [Ni, Tc]
        row1 = ar_i[:, None] * C1 + p1i
        g2_c.append(S.build_gather_map(o_b, pos2, row1[..., None].expand(Ni, Tc, No).reshape(-1),
                                       fan, No, C2, sentinel=Ni * C1))

        # ---- destination chain (chunk-local stage-2 rows + concat offset)
        c2, ok2 = _hier_recv_chain(group, geo, me_o, me_i)
        el_c.append(geo["s_dst"].clamp(0, L - 1))
        entv_c.append((geo["r_dst"] == me) & ok2[..., None])
        r2 = (ar_o[:, None, None] * C2 + c2)[..., None].expand(No, Ni, Tc, Kk)
        rows_c.append(c * (No * C2) + r2)

        # ---- combine, rail side: partials from every pod into the chunk's
        # held-slot buffer (the same c2 chain per destination pod o_p)
        held = ok1_me
        needs = ((geo["i_dst"][me_o] == me_i)[None]
                 & (geo["o_dst"][me_o][None] == ar_o[:, None, None, None])).any(-1)
        fanned = (held[None] & needs).reshape(No, Ni * Tc)  # [No, Ni*Tc]
        c2p = _cumsum_pos(fanned, 1)
        okp = fanned & (c2p < C2)
        rail_dst_c.append(torch.where(okp & (p1i.reshape(-1)[None] < C1),
                                      row1.reshape(-1)[None].expand(No, Ni * Tc),
                                      Ni * C1))
        rail_src_c.append(torch.where(okp, ar_o[:, None] * C2 + c2p, No * C2))

        # ---- combine, source side: rows of the chunk concatenation of the
        # stage-1 combine buffers, in token order
        src_rows_c.append(torch.where(s1 & (p1 < C1),
                                      c * (Ni * C1) + ar_i[None, :] * C1 + p1,
                                      nc * Ni * C1))

    def glob(parts):
        """nc x [No, Ni, Tc, K] -> flat [No*Ni*T*K] in the monolithic entry
        order (o, i, t, k): the chunks interleave back into the token dim."""
        return torch.stack(parts).permute(1, 2, 0, 3, 4).reshape(-1)

    ent_valid, e_l, rows = glob(entv_c), glob(el_c), glob(rows_c)
    a_pos, counts = S.positions_by_dest(e_l, L, ent_valid)
    M2 = nc * No * C2
    disp_recv_gmap = S.build_gather_map(e_l, a_pos, rows, ent_valid, L, A, sentinel=M2)

    # ---- combine, expert side: each y3d slot's stage-2 row, over the chunk
    # concatenation (a slot belongs to one chunk, its source token's)
    slot = torch.where(ent_valid & (a_pos < A), e_l * A + a_pos, L * A).to(i32)
    tgt = torch.full((L * A + 1,), M2, dtype=i32, device=dev)
    tgt.scatter_(0, slot.to(torch.int64), torch.where(ent_valid, rows, M2).to(i32))
    h_slot_tgt = tgt[:L * A]
    rail_dst = torch.stack(rail_dst_c).to(i32)
    rail_src = torch.stack(rail_src_c).to(i32)
    return EpPlan(
        disp_recv_gmap=disp_recv_gmap, disp_counts=counts,
        h_gmap1=torch.stack(g1_c), h_gmap2=torch.stack(g2_c),
        h_slot_tgt=h_slot_tgt, h_rail_dst_rows=rail_dst, h_rail_src_rows=rail_src,
        h_src_rows=torch.cat(src_rows_c).to(i32), h_entry_slot=slot,
        h_slot_rows=_slot_rows(h_slot_tgt, M2, min(Kk, L)),
        h_rail_rows=_rail_rows(rail_dst, rail_src, Ni * C1, No * C2),
    )


def _slot_rows(slot_tgt: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """Invert the slot -> stage-2 row scatter: [rows, width] with each row's
    y3d slots in ascending order (a stable running count per row), sentinel
    the slot count. A row gathers one token's entries at this rank, at most
    min(K, L) of them."""
    M = slot_tgt.shape[0]
    valid = slot_tgt < rows
    pos, _ = S.positions_by_dest(slot_tgt, rows, valid)
    src = torch.arange(M, device=slot_tgt.device, dtype=torch.int32)
    return S.build_gather_map(slot_tgt, pos, src, valid, rows, width, sentinel=M)


def _rail_rows(rail_dst: torch.Tensor, rail_src: torch.Tensor, rows: int,
               sentinel: int) -> torch.Tensor:
    """Invert the rail scatter: [nc, rows, No], for each held rail row the
    stage-2 combine row of every destination pod in pod order. Per (chunk,
    pod) a rail row has one source at most, so the scatter writes each
    kept cell once; dropped entries go to a trash column."""
    nc, No, _ = rail_dst.shape
    inv = torch.full((nc, No, rows + 1), sentinel, dtype=torch.int32,
                     device=rail_dst.device)
    inv.scatter_(2, rail_dst.to(torch.int64), rail_src)
    return inv[..., :rows].transpose(1, 2).contiguous()


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
    dst, e_l = dest_of(group, topk_idx, me)                  # [T, K]
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
                   weights_global: torch.Tensor | None) -> EpPlan | None:
    """Rebind combine weights into a plan without touching a slot map. Only
    the hierarchical ``h_w_slot`` embeds them: one scatter of the gathered
    weights ``weights_global`` [N, T, K] (``gather_weights``) through the
    stored ``h_entry_slot`` chain, into a new plan whose maps are the same
    objects. Every other plan comes back unchanged (the same object, so
    callers can assert map reuse by identity)."""
    if plan is None or plan.h_entry_slot is None:
        return plan
    L, A = group.local_experts, group.ht_expert_cap
    w = torch.zeros((L * A + 1,), dtype=torch.float32, device=weights_global.device)
    w.scatter_(0, plan.h_entry_slot.to(torch.int64), weights_global.reshape(-1).float())
    return dataclasses.replace(plan, h_w_slot=w[:L * A])


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
    w_gs = gather_weights(group, topk_weights)
    if topk_idx is None or all(t is h.topk_idx for t, h in zip(topk_idx, handles)):
        if num_tokens is not None:
            # the padding sentinel is baked into topk_idx: a new valid-token
            # count without new routing is ill-defined
            raise ValueError("num_tokens requires topk_idx on refresh")
        out = []
        for h, w, wg in zip(handles, topk_weights, w_gs):
            if h.plan is not None and not _plan_shape_compatible(group, h.plan):
                raise ValueError(
                    "weights-only refresh got a handle built under a different "
                    "physical slot layout; refresh with topk_idx so the "
                    "routing hash can force the rebuild")
            out.append(dataclasses.replace(h, topk_weights=w,
                                           plan=rebind_weights(group, h.plan, wg)))
        return out

    masked = [mask_padding(group, t, nt)
              for t, nt in zip(topk_idx, per_rank(num_tokens, n))]
    topk_gs = gather_routing(group, [m[0] for m in masked])
    out = []
    for h, (tk, nt), tg, w, wg in zip(handles, masked, topk_gs, topk_weights, w_gs):
        new = make_handle(group, h.rank, tk, tg, w, nt)
        if (h.plan is not None and h.routing_hash is not None
                and tk.shape == h.topk_idx.shape
                and _plan_shape_compatible(group, h.plan)):
            same = (new.routing_hash == h.routing_hash).all()
            # the maps only: h_w_slot is rebound below, from this step's
            # weights whichever maps are kept (JAX rebinds outside its cond)
            new.plan = EpPlan(**{
                f.name: (None if f.name == "h_w_slot" or getattr(new.plan, f.name) is None
                         else torch.where(same, getattr(h.plan, f.name),
                                          getattr(new.plan, f.name)))
                for f in dataclasses.fields(EpPlan)})
        new.plan = rebind_weights(group, new.plan, wg)
        out.append(new)
    return out
