"""Low-Latency (LL) mode, ``nccl_ep`` layout (port of
``src/repro/core/ll.py``).

A token is sent once per destination rank into a per-rank block of C_d
slots; combine responses are packed per (t, k). Both sides read the slot
maps precomputed in the handle's plan, so each phase body is one pass of
data movement: dispatch send is ``dispatch_pack`` (gather plus optional fp8)
then the all-to-all, dispatch recv is ``recv_unpack`` into the expert-major
[L, A, H] tensor, combine send is ``dispatch_pack`` over the expert output,
and combine recv is ``combine_gather_reduce``. Every function takes one
value per hosted rank. The ``deepep`` layout waits for ROADMAP B5.
"""
from __future__ import annotations

from repro_torch.core import plan as P
from repro_torch.core import slots as S
from repro_torch.core.backend import BaseBackend, EpPending, register_backend
from repro_torch.core.group import EpGroup, EpHandle
from repro_torch.core.recv import unpack_recv
from repro_torch.kernels import ops as K


def _per_rank(value, n: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def ll_create_handle(group: EpGroup, topk_idx: list, topk_weights: list,
                     num_tokens=None) -> list[EpHandle]:
    """All-gather the routing and derive each hosted rank's plan. The
    plan is the only place slot arithmetic happens."""
    ranks = group.comm.ranks
    masked = [P.mask_padding(group, t, n)
              for t, n in zip(topk_idx, _per_rank(num_tokens, len(ranks)))]
    topk_gs = P.gather_routing(group, [m[0] for m in masked])
    handles = []
    for rank, (tk, nt), tg, w in zip(ranks, masked, topk_gs, topk_weights):
        counts = P.recv_counts(group, rank, tg)
        handles.append(EpHandle(
            rank=rank, topk_idx=tk, topk_weights=w, topk_global=tg,
            tokens_per_expert=counts, num_recv_tokens=counts.sum(),
            num_tokens=nt, plan=P.build_plan(group, rank, tk, tg, nt),
            routing_hash=P.routing_hash(tg, group.placement_salt)))
    return handles


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
    return [EpPending(mode="ll", op="dispatch", recv=r, recv_scales=s)
            for r, s in zip(recvs, scales)]


def ll_complete_dispatch(group: EpGroup, handles: list, pendings: list):
    """Unpack [N, C_d, H] into [L, A, H]; returns [(out3d, counts [L])]."""
    outs = []
    for h, p in zip(handles, pendings):
        plan = P.ensure_plan(group, h)
        outs.append((unpack_recv(p.recv, plan.disp_recv_gmap, p.recv_scales),
                     plan.disp_counts))
    return outs


def ll_combine_send(group: EpGroup, handles: list, y3ds: list) -> list[EpPending]:
    """Pack each rank's owned responses per source rank and exchange."""
    sends = [K.dispatch_pack(S.flat_rows(y), P.ensure_plan(group, h).comb_send_gmap,
                             out_dtype=group.cfg.payload_dtype)[0]
             for h, y in zip(handles, y3ds)]
    return [EpPending(mode="ll", op="combine", recv=r)
            for r in group.comm.all_to_all(sends)]


def ll_complete_combine(group: EpGroup, handles: list, pendings: list):
    """Gather each (t, k) response and reduce under the gate weights."""
    return [K.combine_gather_reduce(S.flat_rows(p.recv),
                                    P.ensure_plan(group, h).comb_recv_rows,
                                    h.topk_weights)
            for h, p in zip(handles, pendings)]


class LLBackend(BaseBackend):
    """LL mode behind the EpBackend protocol."""

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
