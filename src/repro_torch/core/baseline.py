"""Baseline: the CPU-orchestrated AllToAll dispatcher of Megatron-Core and
Tutel (paper §I), the pattern NCCL EP and DeepEP are set against (port of
``src/repro/core/baseline.py``).

Tokens are permuted by their routing into per-(expert, source rank) blocks
of Ce slots, exchanged, and unpermuted after the experts. Against the fused
LL and HT paths: no routing dedup (every (token, k) entry crosses the wire),
padding moved per expert pair, and no quantization (the payload travels at
the model's dtype whatever ``quantize_dispatch`` says). The slots are
positional, as in the LL ``deepep`` layout, so the dispatch recv and the
combine send are the same transposes (``ll.positional_*``) and the combine
recv is LL's ``combine_gather_reduce`` over the plan's rows. The handle is
HT's (the routing all-gather and the plan, ``plan._baseline_plan``).
"""
from __future__ import annotations

import math

from repro_torch.core import ht as _ht
from repro_torch.core import ll as _ll
from repro_torch.core import plan as P
from repro_torch.core.backend import BaseBackend, EpPending, register_backend
from repro_torch.core.group import EpGroup
from repro_torch.kernels import ops as K


def _per_expert_cap(group: EpGroup) -> int:
    """Per-(expert, src-rank) slot count Ce: the capacity factor times the
    expected entries, in multiples of 8, at most T; T at zero drop."""
    T, Kk, E = (group.cfg.max_tokens_per_rank, group.cfg.top_k,
                group.cfg.num_experts)
    cf = group.cfg.capacity_factor
    if cf is None:
        return T
    return min(max(8, int(math.ceil(cf * T * Kk / E / 8.0) * 8)), T)


baseline_create_handle = _ht.ht_create_handle


def baseline_dispatch_send(group: EpGroup, handles: list, xs: list) -> list[EpPending]:
    """Permute each rank's [T, H] tokens into [N, L·Ce, H] at the payload
    dtype and exchange."""
    sends = [K.dispatch_pack(x, P.ensure_plan(group, h).disp_send_gmap,
                             out_dtype=group.cfg.payload_dtype)[0]
             for h, x in zip(handles, xs)]
    return [EpPending(mode=group.mode, op="dispatch", recv=r)
            for r in group.comm.all_to_all(sends)]


baseline_dispatch_complete = _ll.positional_dispatch_recv
baseline_combine_send = _ll.positional_combine_send
baseline_combine_complete = _ll.ll_complete_combine


class BaselineBackend(BaseBackend):
    """The a2a dispatcher behind the EpBackend protocol."""

    mode = "baseline"

    def create_handle(self, group, topk_idx, topk_weights, num_tokens=None):
        return baseline_create_handle(group, topk_idx, topk_weights, num_tokens)

    def dispatch_send(self, group, handles, tokens):
        return baseline_dispatch_send(group, handles, tokens)

    def dispatch_complete(self, group, handles, pendings):
        return baseline_dispatch_complete(group, handles, pendings)

    def combine_send(self, group, handles, expert_out):
        return baseline_combine_send(group, handles, expert_out)

    def combine_complete(self, group, handles, pendings):
        return baseline_combine_complete(group, handles, pendings)


register_backend(BaselineBackend())
