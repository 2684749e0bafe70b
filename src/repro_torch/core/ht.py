"""High-Throughput (HT) mode, flat path (port of ``src/repro/core/ht.py``).

HT targets prefill and training (4096+ tokens per rank). The flat path
serves a single EP axis, the single-pod layout: one entry-level all-to-all
each way, every (t, k) entry its own slot in the [N, C] send blocks, output
grouped by local expert into [L, A, H] with per-expert counts (Fig. 4's
deterministic 2D layout with static capacities). Entries past the pair
capacity C or the expert region A are dropped and contribute zero.

Every phase is one pass over maps the plan derived at handle creation: the
dispatch send is the fused ``dispatch_pack`` (with fp8 quantization when the
group asks) and the all-to-all, the dispatch recv one ``recv_unpack`` (with
the fused dequant), the combine send ``dispatch_pack`` over the expert
output into the mirrored slots, the combine recv ``combine_gather_reduce``.
Every function takes one value per hosted rank. The hierarchical two-stage
path and its chunk pipeline need sub-group all-to-alls (ROADMAP A2, A5);
``ep_create_group`` refuses a hierarchical group.
"""
from __future__ import annotations

from repro_torch.core import ll as _ll
from repro_torch.core.backend import register_backend

# The flat path moves data exactly as the LL ``nccl_ep`` layout does: the
# routing all-gather and the plan at handle creation (``plan.build_plan``
# picks ``_ht_flat_plan`` by the group's mode), then one pass per phase
# through the plan's maps, one all-to-all each way. Only the maps differ
# (each (t, k) entry its own slot, combine mirroring dispatch), so the
# handle and the four phases are LL's, tagging their pendings with the
# group's mode (JAX's ht_create_handle, _flat_dispatch_send,
# ht_dispatch_complete, _flat_combine_send and _flat_combine_complete
# behind the unified ht_* halves).
ht_create_handle = _ll.ll_create_handle
ht_dispatch_send = _ll.ll_dispatch_send
ht_dispatch_complete = _ll.ll_complete_dispatch
ht_combine_send = _ll.ll_combine_send
ht_combine_complete = _ll.ll_complete_combine


class HtBackend(_ll.LLBackend):
    """HT mode behind the EpBackend protocol (flat path): LL's handle and
    phases, over the flat plan that ``plan.build_plan`` derives for ht."""

    mode = "ht"


register_backend(HtBackend())
