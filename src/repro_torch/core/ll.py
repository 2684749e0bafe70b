"""Low-Latency (LL) mode, ``nccl_ep`` and ``deepep`` layouts (port of
``src/repro/core/ll.py``).

``nccl_ep``: a token is sent once per destination rank into a per-rank
block of C_d slots; combine responses are packed per (t, k). Both sides read
the slot maps precomputed in the handle's plan, so each phase body is one
pass of data movement: dispatch send is ``dispatch_pack`` (gather plus
optional fp8) then the all-to-all, dispatch recv is ``recv_unpack`` into the
expert-major [L, A, H] tensor, combine send is ``dispatch_pack`` over the
expert output, and combine recv is ``combine_gather_reduce``.

``deepep``: one slot per (local expert, source token), O(E·B·P) buffers; a
token routed to k experts is sent k times. The dispatch send and the
combine recv are the ``nccl_ep`` phases over the ``deepep`` maps; the
dispatch recv is a transpose ([N, L·B] -> [L, N·B]) plus the standalone
``dequantize_fp8`` for an fp8 payload, and the combine send the transpose
back. Every function takes one value per hosted rank and tags its pendings
with the group's mode: the flat HT path (``core/ht.py``) and the baseline
(``core/baseline.py``) run these functions over their own maps.
"""
from __future__ import annotations

from repro_torch.core import plan as P
from repro_torch.core import slots as S
from repro_torch.core.backend import BaseBackend, EpPending, register_backend
from repro_torch.core.group import EpGroup, EpHandle
from repro_torch.core.recv import dequant_rows, unpack_recv
from repro_torch.kernels import ops as K


def ll_create_handle(group: EpGroup, topk_idx: list, topk_weights: list,
                     num_tokens=None) -> list[EpHandle]:
    """All-gather the routing (and, for the hierarchical HT plan, the
    combine weights) and derive each hosted rank's plan for the group's
    mode. The plan is the only place slot arithmetic happens."""
    ranks = group.comm.ranks
    masked = [P.mask_padding(group, t, n)
              for t, n in zip(topk_idx, P.per_rank(num_tokens, len(ranks)))]
    topk_gs = P.gather_routing(group, [m[0] for m in masked])
    w_gs = P.gather_weights(group, topk_weights)
    return [P.make_handle(group, rank, tk, tg, w, nt, wg)
            for rank, (tk, nt), tg, w, wg in zip(ranks, masked, topk_gs, topk_weights, w_gs)]


def _pack_send(group: EpGroup, x, gmap):
    if group.cfg.quantize_dispatch:
        return K.dispatch_pack(x, gmap, quant_block=group.cfg.quant_block)
    return K.dispatch_pack(x, gmap, out_dtype=group.cfg.payload_dtype)


def ll_dispatch_send(group: EpGroup, handles: list, xs: list) -> list[EpPending]:
    """Pack each rank's [T, H] tokens into [N, C_d, ...] and exchange."""
    packed = [_pack_send(group, x, P.ensure_plan(group, h).disp_send_gmap)
              for h, x in zip(handles, xs)]
    recvs = group.comm.all_to_all([p[0] for p in packed])
    if group.cfg.quantize_dispatch:
        scales = group.comm.all_to_all([p[1] for p in packed])
    else:
        scales = [None] * len(recvs)
    return [EpPending(mode=group.mode, op="dispatch", recv=r, recv_scales=s)
            for r, s in zip(recvs, scales)]


def ll_complete_dispatch(group: EpGroup, handles: list, pendings: list):
    """Unpack [N, C_d, H] into [L, A, H]; returns [(out3d, counts [L])]."""
    if P.positional_layout(group):
        return positional_dispatch_recv(group, handles, pendings)
    outs = []
    for h, p in zip(handles, pendings):
        plan = P.ensure_plan(group, h)
        outs.append((unpack_recv(p.recv, plan.disp_recv_gmap, p.recv_scales),
                     plan.disp_counts))
    return outs


def positional_dispatch_recv(group: EpGroup, handles: list, pendings: list):
    """Rows landed by position: [N, L·c, H] -> [L, N·c, H] is a transpose,
    then the block dequant of an fp8 payload (``deepep``; the baseline with
    c its per-expert capacity and no scales)."""
    N, L = group.ep_size, group.local_experts
    outs = []
    for h, p in zip(handles, pendings):
        sc = None if p.recv_scales is None else S.swap_blocks(p.recv_scales, N, L)
        outs.append((dequant_rows(S.swap_blocks(p.recv, N, L), sc),
                     P.ensure_plan(group, h).disp_counts))
    return outs


def positional_combine_send(group: EpGroup, handles: list, y3ds: list) -> list[EpPending]:
    """The transpose back, [L, N·c, H] -> [N, L·c, H], at the payload
    dtype, and the exchange."""
    N, L = group.ep_size, group.local_experts
    sends = [S.swap_blocks(y, L, N).to(group.cfg.payload_dtype) for y in y3ds]
    return [EpPending(mode=group.mode, op="combine", recv=r)
            for r in group.comm.all_to_all(sends)]


def ll_combine_send(group: EpGroup, handles: list, y3ds: list) -> list[EpPending]:
    """Pack each rank's owned responses per source rank and exchange."""
    if P.positional_layout(group):
        return positional_combine_send(group, handles, y3ds)
    sends = [K.dispatch_pack(S.flat_rows(y), P.ensure_plan(group, h).comb_send_gmap,
                             out_dtype=group.cfg.payload_dtype)[0]
             for h, y in zip(handles, y3ds)]
    return [EpPending(mode=group.mode, op="combine", recv=r)
            for r in group.comm.all_to_all(sends)]


def ll_complete_combine(group: EpGroup, handles: list, pendings: list):
    """Gather each (t, k) response and reduce under the gate weights."""
    return [K.combine_gather_reduce(S.flat_rows(p.recv),
                                    P.ensure_plan(group, h).comb_recv_rows,
                                    h.topk_weights)
            for h, p in zip(handles, pendings)]


class LLBackend(BaseBackend):
    """LL mode behind the EpBackend protocol (both layouts)."""

    mode = "ll"

    def create_handle(self, group, topk_idx, topk_weights, num_tokens=None):
        return ll_create_handle(group, topk_idx, topk_weights, num_tokens)

    def dispatch_send(self, group, handles, tokens):
        return ll_dispatch_send(group, handles, tokens)

    def dispatch_complete(self, group, handles, pendings):
        return ll_complete_dispatch(group, handles, pendings)

    def combine_send(self, group, handles, expert_out):
        return ll_combine_send(group, handles, expert_out)

    def combine_complete(self, group, handles, pendings):
        return ll_complete_combine(group, handles, pendings)


register_backend(LLBackend())
