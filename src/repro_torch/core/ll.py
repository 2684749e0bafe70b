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

The MoE layer runs the EP dispatch and combine as the Functions
``EpDispatch`` and ``EpCombine`` (``ep_dispatch_autograd``,
``ep_combine_autograd``), whose forward runs the backend's staged send and
complete (recording nothing where no input requires grad) and whose
backward runs the transposes through the same handle's maps, in every
mode and layout. The backward of dispatch is the combine path applied to
the cotangent with unit weights (B1 copy pack through ``comb_send_gmap``,
or the positional layouts' swap back, the exchange, B4 over
``comb_recv_rows``), and the backward of combine is
``combine_gather_reduce_bwd`` (the received rows' and the weights'
gradients), the exchange, and a B2 gather through the inverse of
``comb_send_gmap`` into [L, A, H], or the positional layouts' swap. The
hierarchical HT path has its mirror transposes in ``core/ht.py``. An fp8
dispatch takes the same bf16 backward (straight-through): the reference's
AD casts the cotangent to e4m3 without a scale (ROADMAP Queue C).
``combine_gather_reduce_bwd`` stores each received row's gradient rather
than summing: the transpose because no valid entry of ``comb_recv_rows``
(nor of the hierarchical ``h_slot_rows``, ``h_rail_rows``, ``h_src_rows``)
names a row twice, in any layout, drop or placement
(``tests/test_torch_train_layouts.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import plan as P
from repro_torch.core import slots as S
from repro_torch.core.backend import BaseBackend, EpPending, get_backend, register_backend
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


def _pack_send(group: EpGroup, x, gmap, quant: bool | None = None):
    """B1 into the payload: fp8 when ``quant`` (default: the group's fp8
    dispatch), else a copy at the payload dtype."""
    if group.cfg.quantize_dispatch if quant is None else quant:
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


# --------------------------------------------------------------------------
# training: the dispatch and combine under autograd
# --------------------------------------------------------------------------

def _unit(rows: torch.Tensor) -> torch.Tensor:
    return torch.ones(rows.shape, dtype=torch.float32, device=rows.device)


def dispatch_transpose(group: EpGroup, handles: list, d_y3ds: list) -> list:
    """The backward of dispatch for cotangents [L, A, H]: each rank's d_x
    [T, H] in the payload dtype, d_x[t] the f32 sum over k of the cotangent
    of entry (t, k)'s expert row, in k order (0 for a dropped entry). The
    combine path with unit weights, so the fp8 dispatch's backward is the
    bf16 one (straight-through): B1 copy pack through ``comb_send_gmap``
    (the positional layouts: the swap back), the exchange, B4 over
    ``comb_recv_rows``; the hierarchical path's in ``core/ht.py``."""
    if group.hierarchical:
        from repro_torch.core import ht as _ht  # ht imports this module
        return _ht.hier_dispatch_transpose(group, handles, d_y3ds)
    dt = group.cfg.payload_dtype
    plans = [P.ensure_plan(group, h) for h in handles]
    if P.positional_layout(group):
        N, L = group.ep_size, group.local_experts
        sends = [S.swap_blocks(d.to(dt), L, N) for d in d_y3ds]
    else:
        sends = [K.dispatch_pack(S.flat_rows(d.to(dt)).contiguous(), pl.comb_send_gmap,
                                 out_dtype=dt)[0] for d, pl in zip(d_y3ds, plans)]
    return [K.combine_gather_reduce(S.flat_rows(r), pl.comb_recv_rows, _unit(pl.comb_recv_rows))
            for r, pl in zip(group.comm.all_to_all(sends), plans)]


def comb_send_inverse(group: EpGroup, plan) -> torch.Tensor:
    """[L, A] int32: the combine send row (of [N * C_c]) that each expert
    row goes to, or the sentinel N * C_c for a row the combine never sends
    (empty, past the count, dropped). The inverse of ``comb_send_gmap``,
    which names each y3d row at most once. For HT flat it is
    ``disp_recv_gmap`` (combine mirrors dispatch slot for slot)."""
    L = group.local_experts
    g = plan.comb_send_gmap.reshape(-1)
    A = plan.disp_recv_gmap.shape[1]
    inv = torch.full((L * A + 1,), g.numel(), dtype=torch.int32, device=g.device)
    inv.scatter_(0, torch.where(g < L * A, g, L * A).long(),
                 torch.arange(g.numel(), dtype=torch.int32, device=g.device))
    return inv[:L * A].view(L, A)


def combine_transpose(group: EpGroup, handles: list, saved: list, d_outs: list):
    """The backward of combine for cotangents [T, H], from what the forward
    kept (``saved``: the rows each rank received; on the hierarchical path
    the expert rows its slot-domain sum read): (d_y3d per rank, [L, A, H]
    or its flat rows, rows the combine never read zero; d_w [T, K] f32 per
    rank). ``combine_gather_reduce_bwd`` over ``comb_recv_rows``, the
    exchange, then into [L, A, H]: a B2 gather through the inverse of
    ``comb_send_gmap``, or the positional layouts' swap."""
    if group.hierarchical:
        from repro_torch.core import ht as _ht  # ht imports this module
        return _ht.hier_combine_transpose(group, handles, saved, d_outs)
    plans = [P.ensure_plan(group, h) for h in handles]
    parts = [K.combine_gather_reduce_bwd(S.flat_rows(r), pl.comb_recv_rows,
                                         h.topk_weights.detach().float(),
                                         d.to(r.dtype).contiguous())
             for r, pl, h, d in zip(saved, plans, handles, d_outs)]
    back = group.comm.all_to_all([dr.view(r.shape) for (dr, _), r in zip(parts, saved)])
    if P.positional_layout(group):
        N, L = group.ep_size, group.local_experts
        d_y3ds = [S.swap_blocks(b, N, L) for b in back]
    else:
        d_y3ds = [K.recv_unpack(S.flat_rows(b), comb_send_inverse(group, pl))
                  for b, pl in zip(back, plans)]
    return d_y3ds, [dw for _, dw in parts]


class EpDispatch(torch.autograd.Function):
    """The staged dispatch of every hosted rank: inputs (group, handles,
    x_0, ..., x_n), outputs (y3d_0, ..., y3d_n, counts_0, ..., counts_n)."""

    @staticmethod
    def forward(ctx, group, handles, *xs):
        be = get_backend(group.mode)
        outs = be.complete(group, handles, be.dispatch(group, handles, list(xs),
                                                       send_only=True))
        ctx.group, ctx.handles = group, handles
        ctx.x_dtypes = [x.dtype for x in xs]
        counts = [c for _, c in outs]
        ctx.mark_non_differentiable(*counts)
        return tuple(y for y, _ in outs) + tuple(counts)

    @staticmethod
    def backward(ctx, *grads):
        n = len(ctx.handles)
        d_x = dispatch_transpose(ctx.group, ctx.handles, list(grads[:n]))
        return (None, None) + tuple(d.to(dt) for d, dt in zip(d_x, ctx.x_dtypes))


class EpCombine(torch.autograd.Function):
    """The staged combine of every hosted rank: inputs (group, handles,
    y3d_0, ..., y3d_n, w_0, ..., w_n) with w_r rank r's combine weights
    (its handle's ``topk_weights``), outputs the combined [T, H] per rank."""

    @staticmethod
    def forward(ctx, group, handles, *args):
        n = len(handles)
        y3ds = list(args[:n])
        ctx.y_meta = [(y.dtype, y.shape) for y in y3ds]
        if group.hierarchical:
            # the expert-side backward reads the rows the slot-domain sum
            # read, and not the stage-1 combine buffers
            from repro_torch.core import ht as _ht  # ht imports this module
            y3ds = [_ht.combine_rows(group, y) for y in y3ds]
        be = get_backend(group.mode)
        pendings = be.combine(group, handles, y3ds, send_only=True)
        outs = be.complete(group, handles, pendings)
        ctx.group, ctx.handles = group, handles
        ctx.save_for_backward(*(y3ds if group.hierarchical else (p.recv for p in pendings)))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *d_outs):
        d_y3ds, d_ws = combine_transpose(ctx.group, ctx.handles, list(ctx.saved_tensors),
                                         list(d_outs))
        return (None, None) + tuple(d.to(dt).view(shape) for d, (dt, shape)
                                    in zip(d_y3ds, ctx.y_meta)) + tuple(d_ws)


def ep_dispatch_autograd(group: EpGroup, handles: list, xs: list) -> list:
    """``ep_complete(ep_dispatch(..., send_only=True))`` as a Function:
    [(y3d, counts)] per rank, y3d differentiable in its rank's tokens."""
    out = EpDispatch.apply(group, handles, *xs)
    n = len(xs)
    return list(zip(out[:n], out[n:]))


def ep_combine_autograd(group: EpGroup, handles: list, y3ds: list) -> list:
    """``ep_complete(ep_combine(..., send_only=True))`` as a Function: the
    combined [T, H] per rank, differentiable in the expert outputs and in
    the handles' combine weights."""
    return list(EpCombine.apply(group, handles, *y3ds, *(h.topk_weights for h in handles)))


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
