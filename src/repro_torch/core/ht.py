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


def _hier_dispatch_send(group: EpGroup, handles: list, xs: list) -> list[EpPending]:
    """Chunk-skewed two-stage stream. Iteration i packs chunk i and
    exchanges it over the inner axis, then fans chunk i-1 over the pods
    (a copy-mode unpack of the held rows and of their scales) and exchanges
    that over the outer axis; neither waits for the other."""
    comm = group.comm
    ax_o, ax_i = group.cfg.ep_axis[0], group.cfg.ep_axis[-1]
    plans = P.ensure_plans(group, handles)
    nc = plans[0].h_gmap1.shape[0]
    quant = group.cfg.quantize_dispatch
    recv1, recv1_s = [None] * nc, [None] * nc
    recv2, recv2_s = [None] * nc, [None] * nc
    for i in range(nc + 1):
        if i < nc:
            packed = [_ll._pack_send(group, x, pl.h_gmap1[i]) for x, pl in zip(xs, plans)]
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


def _hier_combine_send(group: EpGroup, handles: list, y3ds: list) -> list[EpPending]:
    """The reverse path with hierarchical reduction, mirror-skewed. At the
    expert rank, one gather-reduce sums each source token's weighted
    responses into its stage-2 row, for every chunk at once (the H-wide work
    stays in the slot domain, at most L*A rows read); iteration i exchanges
    chunk i over the pods, then sums chunk i-1's partials of every pod at
    the rail and exchanges them over the inner axis."""
    comm = group.comm
    ax_o, ax_i = group.cfg.ep_axis[0], group.cfg.ep_axis[-1]
    No, C2 = group.outer_size, group.ht_stage2_cap
    dt = group.cfg.payload_dtype
    plans = P.ensure_plans(group, handles)
    nc = plans[0].h_gmap1.shape[0]
    bufs = []
    for y, pl in zip(y3ds, plans):
        rows = S.flat_rows(y)
        if rows.dtype != dt:
            # B4 sums in f32 and writes its input's type: round once, to the
            # payload's, as JAX does (a bf16 y3d under an f32 payload)
            rows = rows.float()
        w = torch.cat([pl.h_w_slot, pl.h_w_slot.new_zeros(1)])[pl.h_slot_rows.long()]
        bufs.append(K.combine_gather_reduce(rows, pl.h_slot_rows, w).to(dt))
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
