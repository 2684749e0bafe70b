"""High-Throughput (HT) mode (port of ``src/repro/core/ht.py``).

HT targets prefill and training (4096+ tokens per rank). Two paths:

* **flat** (one EP axis, or ``ht_hierarchical=False``): one entry-level
  all-to-all each way over all N ranks, every (t, k) entry its own slot in
  the [N, C] send blocks, output grouped by local expert into [L, A, H]
  with per-expert counts (Fig. 4's deterministic 2D layout with static
  capacities). It moves data exactly as the LL ``nccl_ep`` layout does, so
  its handle and four phases are LL's over the flat plan's maps.

* **hierarchical** (EP over (pod, inner) with ``ht_hierarchical``):
  Hybrid-EP's two tiers. Stage 1 is an all-to-all over the inner axis (the
  ranks of one pod) keyed by the destination's inner coordinate, the
  "rail", one send per (token, rail); stage 2 is the rail-aligned
  all-to-all over the outer axis, between the ranks of equal inner
  coordinate. Combine runs the mirror path with hierarchical reduction:
  each expert response is weighted at the expert rank and summed per
  source token, the rail sums over pods, the source over rails. With
  ``ht_num_chunks > 1`` the token dim splits into static chunks that
  stream: chunk i's stage-1 exchange is issued before chunk i-1's stage-2
  one (combine runs the mirror skew), the reference's overlap of the fast
  and slow fabrics. At zero drop every chunk count gives the bitwise same
  result.

Every phase is one pass per chunk over maps the plan derived at handle
creation. Dispatch: ``dispatch_pack`` (with fp8 quantization when the group
asks) per chunk, the stage-2 fan a copy-mode ``recv_unpack`` of the
payload (fp8 stays fp8 across both hops) and of its scales, and one
``recv_unpack`` with the fused dequant into [L, A, H]. Combine: the three
sums are ``combine_gather_reduce`` over the plan's fixed-order gather maps,
in f32 in the map's order, never a scatter-add, whose atomics on CUDA
would reorder them. Every function takes one value per hosted rank.

Training runs the mirror paths (``hier_dispatch_transpose``,
``hier_combine_transpose``, called from ``core/ll.py``'s Functions): the
dispatch's backward is the combine path with unit weights, the combine's
the dispatch path in copy mode on the cotangent, then
``combine_gather_reduce_bwd`` at the expert rank; the weights' gradient,
found there per slot, goes back to the source ranks by one all-to-all.
Both run in the forward's chunk skew, so at zero drop the gradients are
bitwise the same for any chunk count.
"""
from __future__ import annotations

import torch

from repro_torch.core import ll as _ll
from repro_torch.core import plan as P
from repro_torch.core import slots as S
from repro_torch.core.backend import BaseBackend, EpPending, register_backend
from repro_torch.core.group import EpGroup
from repro_torch.core.recv import unpack_recv
from repro_torch.kernels import ops as K

# the handle and the dispatch finish are shared by both paths: handle
# creation builds whichever plan the group resolves (``plan.build_plan``),
# and the finish is one fused pass through the plan's expert-region map
# over the received rows (for the chunked pipeline, their concatenation)
ht_create_handle = _ll.ll_create_handle
ht_dispatch_complete = _ll.ll_complete_dispatch


def _cat_rows(parts: list) -> torch.Tensor:
    """Concatenate chunk buffers as [rows, ...] (one chunk: no copy)."""
    rows = [S.flat_rows(p) for p in parts]
    return rows[0] if len(rows) == 1 else torch.cat(rows)


def _hier_dispatch_send(group: EpGroup, handles: list, xs: list,
                        quant: bool | None = None) -> list[EpPending]:
    """Chunk-skewed two-stage stream. Iteration i packs chunk i and
    exchanges it over the inner axis, then fans chunk i-1 over the pods
    (a copy-mode unpack of the held rows and of their scales) and exchanges
    that over the outer axis; neither waits for the other. ``quant``
    overrides the group's fp8 dispatch (the combine's transpose packs its
    cotangent in copy mode)."""
    comm = group.comm
    ax_o, ax_i = group.cfg.ep_axis[0], group.cfg.ep_axis[-1]
    plans = P.ensure_plans(group, handles)
    nc = plans[0].h_gmap1.shape[0]
    quant = group.cfg.quantize_dispatch if quant is None else quant
    recv1, recv1_s = [None] * nc, [None] * nc
    recv2, recv2_s = [None] * nc, [None] * nc
    for i in range(nc + 1):
        if i < nc:
            packed = [_ll._pack_send(group, x, pl.h_gmap1[i], quant) for x, pl in zip(xs, plans)]
            recv1[i] = comm.all_to_all([p[0] for p in packed], axis=ax_i)   # [Ni, C1, H]
            if quant:
                recv1_s[i] = comm.all_to_all([p[1] for p in packed], axis=ax_i)
        if i > 0:
            j = i - 1
            recv2[j] = comm.all_to_all([unpack_recv(r, pl.h_gmap2[j])
                                        for r, pl in zip(recv1[j], plans)], axis=ax_o)
            if quant:
                recv2_s[j] = comm.all_to_all([unpack_recv(r, pl.h_gmap2[j])
                                              for r, pl in zip(recv1_s[j], plans)], axis=ax_o)
            recv1[j] = recv1_s[j] = None
    recvs = [_cat_rows(parts) for parts in zip(*recv2)]
    scales = ([_cat_rows(parts) for parts in zip(*recv2_s)] if quant
              else [None] * len(recvs))
    return [EpPending(mode=group.mode, op="dispatch", recv=r, recv_scales=s)
            for r, s in zip(recvs, scales)]


def combine_rows(group: EpGroup, y3d: torch.Tensor) -> torch.Tensor:
    """The expert rows [L*A, H] the slot-domain sum reads. B4 sums in f32
    and writes its input's type: rows of another type than the payload's
    (a bf16 y3d under an f32 payload) go as f32, so the sum rounds once, to
    the payload's type, as JAX does."""
    rows = S.flat_rows(y3d)
    return rows.float() if rows.dtype != group.cfg.payload_dtype else rows


def slot_weights(plan) -> torch.Tensor:
    """The combine weight of each slot the slot-domain map names, [M2,
    min(K, L)] f32 (0 at the sentinel)."""
    return torch.cat([plan.h_w_slot, plan.h_w_slot.new_zeros(1)])[plan.h_slot_rows.long()]


def _hier_combine_send(group: EpGroup, handles: list, y3ds: list,
                       weights: list | None = None) -> list[EpPending]:
    """The reverse path with hierarchical reduction, mirror-skewed. At the
    expert rank, one gather-reduce sums each source token's weighted
    responses into its stage-2 row, for every chunk at once (the H-wide work
    stays in the slot domain, at most L*A rows read); iteration i exchanges
    chunk i over the pods, then sums chunk i-1's partials of every pod at
    the rail and exchanges them over the inner axis. ``weights``: per rank
    the [M2, min(K, L)] weights of the slot-domain sum, by default the
    plan's combine weights (``slot_weights``); the dispatch's transpose
    passes ones."""
    comm = group.comm
    ax_o, ax_i = group.cfg.ep_axis[0], group.cfg.ep_axis[-1]
    No, C2 = group.outer_size, group.ht_stage2_cap
    dt = group.cfg.payload_dtype
    plans = P.ensure_plans(group, handles)
    nc = plans[0].h_gmap1.shape[0]
    if weights is None:
        weights = [slot_weights(pl) for pl in plans]
    bufs = [K.combine_gather_reduce(combine_rows(group, y), pl.h_slot_rows, w).to(dt)
            for y, pl, w in zip(y3ds, plans, weights)]
    H = bufs[0].shape[-1]
    back2, back1 = [None] * nc, [None] * nc
    for i in range(nc + 1):
        if i < nc:
            back2[i] = comm.all_to_all([b[i * No * C2:(i + 1) * No * C2].view(No, C2, H)
                                        for b in bufs], axis=ax_o)
        if i > 0:
            j = i - 1
            back1[j] = comm.all_to_all([_rail_sum(group, b, pl.h_rail_rows[j])
                                        for b, pl in zip(back2[j], plans)], axis=ax_i)
            back2[j] = None
    return [EpPending(mode=group.mode, op="combine", recv=_cat_rows(parts))
            for parts in zip(*back1)]


def _rail_sum(group: EpGroup, back2: torch.Tensor, rail_rows: torch.Tensor) -> torch.Tensor:
    """A rail's held rows [Ni*C1] each summed over the pods' partials
    [No, C2, H] in pod order, as [Ni, C1, H] for the inner exchange."""
    ones = torch.ones(rail_rows.shape, dtype=torch.float32, device=back2.device)
    out = K.combine_gather_reduce(S.flat_rows(back2), rail_rows, ones)
    return out.view(group.inner_size, group.ht_stage1_cap, out.shape[-1])


def _hier_combine_complete(group: EpGroup, handles: list, pendings: list):
    """The source's sum over rails: one gather-reduce over the chunk
    concatenation of the stage-1 combine buffers, in token order."""
    outs = []
    for pl, p in zip(P.ensure_plans(group, handles), pendings):
        ones = torch.ones(pl.h_src_rows.shape, dtype=torch.float32, device=p.recv.device)
        outs.append(K.combine_gather_reduce(p.recv, pl.h_src_rows, ones))
    return outs


# --------------------------------------------------------------------------
# training: the transposes of the hierarchical dispatch and combine
# --------------------------------------------------------------------------

def hier_dispatch_transpose(group: EpGroup, handles: list, d_y3ds: list) -> list:
    """The backward of the hierarchical dispatch for cotangents [L, A, H]:
    each rank's d_x [T, H] in the payload dtype. The combine path with unit
    weights in its mirror skew: a stage-2 row gets the sum of the slots
    that read it (``h_slot_rows``), the outer exchange, the rail's sum over
    pods (``h_rail_rows``, whose positions are the fan's ``h_gmap2``), the
    inner exchange and the source's sum over rails (``h_src_rows``), every
    sum in f32 in its map's order, so d_x is bitwise the same for any chunk
    count at zero drop. An fp8 dispatch takes the same backward
    (straight-through)."""
    dt = group.cfg.payload_dtype
    ones = [torch.ones(pl.h_slot_rows.shape, dtype=torch.float32, device=pl.h_slot_rows.device)
            for pl in P.ensure_plans(group, handles)]
    pend = _hier_combine_send(group, handles, [d.to(dt) for d in d_y3ds], ones)
    return _hier_combine_complete(group, handles, pend)


def hier_combine_transpose(group: EpGroup, handles: list, rows: list, d_outs: list):
    """The backward of the hierarchical combine for cotangents [T, H], from
    the expert rows its slot-domain sum read (``combine_rows``): (d_y3d
    [L*A, H] per rank in the rows' dtype, slots the combine never read
    zero; d_w [T, K] f32 per rank).

    The dispatch path on the cotangent in copy mode, in the forward's
    chunk skew: B1 through ``h_gmap1``, the inner exchange, the B2 fan
    through ``h_gmap2``, the outer exchange, which gives the cotangent of
    the stage-2 combine rows; at the expert rank ``combine_gather_reduce_bwd``
    over ``h_slot_rows`` gives d_y3d (w · the row's cotangent, each slot
    once) and the gradient of each slot's weight. The plan weighs the
    responses at the expert rank (``h_w_slot``, scattered from the
    all-gathered weights), so the weights' gradient goes back to the source
    ranks: each slot's value to its global entry through ``h_entry_slot``
    (0 at drops and at the sentinel), the [T, K] blocks returned to their
    sources by one all-to-all (the all-gather's transpose), and the N blocks
    summed in rank order in f32, one contributor an entry, so exact."""
    dt = group.cfg.payload_dtype
    N = group.ep_size
    plans = P.ensure_plans(group, handles)
    pend = _hier_dispatch_send(group, handles, [d.to(dt).contiguous() for d in d_outs],
                               quant=False)
    d_y3ds, d_ws = [], []
    for r, pl, p, h in zip(rows, plans, pend, handles):
        d_rows, d_w = K.combine_gather_reduce_bwd(r, pl.h_slot_rows, slot_weights(pl),
                                                  p.recv.to(r.dtype))
        d_y3ds.append(d_rows)
        # each slot is named once in h_slot_rows; the sentinels land in the
        # trash slot L*A, which is zeroed before the entries read it
        LA = pl.h_w_slot.shape[0]
        per_slot = torch.zeros((LA + 1,), dtype=torch.float32, device=d_w.device)
        per_slot.scatter_(0, pl.h_slot_rows.reshape(-1).long(), d_w.reshape(-1))
        per_slot[LA] = 0.0
        d_ws.append(per_slot[pl.h_entry_slot.long()].view((N,) + tuple(h.topk_idx.shape)))
    back = group.comm.all_to_all(d_ws)
    out = []
    for b in back:
        acc = b[0].clone()
        for n in range(1, N):
            acc += b[n]
        out.append(acc)
    return d_y3ds, out


def ht_dispatch_send(group: EpGroup, handles: list, xs: list) -> list[EpPending]:
    if group.hierarchical:
        return _hier_dispatch_send(group, handles, xs)
    return _ll.ll_dispatch_send(group, handles, xs)


def ht_combine_send(group: EpGroup, handles: list, y3ds: list) -> list[EpPending]:
    if group.hierarchical:
        return _hier_combine_send(group, handles, y3ds)
    return _ll.ll_combine_send(group, handles, y3ds)


def ht_combine_complete(group: EpGroup, handles: list, pendings: list):
    if group.hierarchical:
        return _hier_combine_complete(group, handles, pendings)
    return _ll.ll_complete_combine(group, handles, pendings)


class HtBackend(BaseBackend):
    """HT mode behind the EpBackend protocol, flat and hierarchical."""

    mode = "ht"

    def create_handle(self, group, topk_idx, topk_weights, num_tokens=None):
        return ht_create_handle(group, topk_idx, topk_weights, num_tokens)

    def dispatch_send(self, group, handles, tokens):
        return ht_dispatch_send(group, handles, tokens)

    def dispatch_complete(self, group, handles, pendings):
        return ht_dispatch_complete(group, handles, pendings)

    def combine_send(self, group, handles, expert_out):
        return ht_combine_send(group, handles, expert_out)

    def combine_complete(self, group, handles, pendings):
        return ht_combine_complete(group, handles, pendings)


register_backend(HtBackend())
