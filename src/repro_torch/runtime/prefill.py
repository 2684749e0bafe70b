"""Micro-batched HT prefill driver (port of ``sequential_prefill`` and
``prefill_moe`` in ``src/repro/runtime/prefill.py``).

``prefill_moe`` runs one prefill MoE layer over P micro-batches on the
staged EP surface (``send_only=True`` + ``ep_complete``): micro-batch i+1's
dispatch send is issued before micro-batch i is completed, so its
all-to-all can overlap i's unpack and expert GEMMs, and every combine
drains at the end. ``sequential_prefill`` runs each micro-batch through
handle, dispatch, experts and combine in turn: the same computation in
another order, so the two are bitwise equal (no kernel on the path sums in
a run-dependent order).

As everywhere in the port's EP API, a value per hosted rank is a list
indexed like ``group.comm.ranks``. Size the group's ``max_tokens_per_rank``
to the micro-batch (T / P): each micro-batch carries its own handle.
``rebalancing_prefill`` swaps EPLB placements between batches.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import ep_combine, ep_complete, ep_create_handle, ep_dispatch
from repro_torch.core import placement as PL
from repro_torch.core.group import EpGroup, EpGroupConfig

# router_fn: one rank's tokens [T, H] -> (topk_idx [T, K], topk_weights [T, K])
RouterFn = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
# expert_fn: (rank, y3d [L, A, H], counts [L]) -> [L, A, H], the rank's experts
ExpertFn = Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor]


def _micro_batches(xs: list, mb: int) -> list[list]:
    T = xs[0].shape[0]
    if T % mb:
        raise ValueError(f"{mb} micro-batches must divide the {T} tokens per rank")
    Tm = T // mb
    return [[x[i * Tm:(i + 1) * Tm] for x in xs] for i in range(mb)]


def _handle(group: EpGroup, router_fn: RouterFn, xi: list):
    routed = [router_fn(x) for x in xi]
    return ep_create_handle(group, [r[0] for r in routed], [r[1] for r in routed])


def _experts(group: EpGroup, expert_fn: ExpertFn, recv: list) -> list:
    return [expert_fn(r, y3d, counts) for r, (y3d, counts) in zip(group.comm.ranks, recv)]


def sequential_prefill(group: EpGroup, router_fn: RouterFn, expert_fn: ExpertFn,
                       xs: list, num_microbatches: int = 2) -> list:
    """The unpipelined reference: each micro-batch runs handle -> dispatch ->
    experts -> combine fully in turn. xs: [T, H] per hosted rank -> the
    combined [T, H] per hosted rank."""
    outs = []
    for xi in _micro_batches(xs, num_microbatches):
        h = _handle(group, router_fn, xi)
        outs.append(ep_combine(group, h, _experts(group, expert_fn, ep_dispatch(group, h, xi))))
    return [torch.cat(parts) for parts in zip(*outs)]


def prefill_moe(group: EpGroup, router_fn: RouterFn, expert_fn: ExpertFn,
                xs: list, num_microbatches: int = 2) -> list:
    """One prefill MoE layer over xs ([T, H] per hosted rank), pipelined
    ``num_microbatches`` ways; returns the combined tokens in input order."""
    mbs = _micro_batches(xs, num_microbatches)
    handles = [_handle(group, router_fn, xi) for xi in mbs]
    mb = len(mbs)
    pend = [None] * mb
    comb = [None] * mb
    pend[0] = ep_dispatch(group, handles[0], mbs[0], send_only=True)
    for i in range(mb):
        if i + 1 < mb:      # the next micro-batch's all-to-all over this GEMM
            pend[i + 1] = ep_dispatch(group, handles[i + 1], mbs[i + 1], send_only=True)
        recv = ep_complete(group, handles[i], pend[i])
        comb[i] = ep_combine(group, handles[i], _experts(group, expert_fn, recv),
                             send_only=True)
    outs = [ep_complete(group, handles[i], comb[i]) for i in range(mb)]
    return [torch.cat(parts) for parts in zip(*outs)]


def rebalancing_prefill(base_cfg: EpGroupConfig, make_layer, batches, *,
                        rebalance_every: int, ep_size: int, comm=None,
                        num_redundant: int = 0, inner_size: int | None = None,
                        decay: float = 0.0, rebalance_fn=PL.rebalance, params=None,
                        expert_keys: tuple = PL.EXPERT_PARAM_KEYS,
                        donate_params: bool = True, min_replicas: int = 1,
                        fault_domains=None, max_slots_per_rank: int | None = None):
    """Prefill mirror of ``runtime/decode.py rebalancing_decode_loop``:
    placements swap between batches, the natural boundary (within one batch
    the micro-batched pipeline runs on one placement). ``make_layer(group)
    -> fn(x) -> (out, heat)`` runs one staged prefill layer (typically
    ``prefill_moe`` plus a routed-token histogram) on a group over
    ``comm``. Every ``rebalance_every`` batches the folded heat drives the
    shared ``RebalanceScheduler``. Returns ``(outs, placements)``, one
    placement per batch (None = contiguous); ``params`` as in the decode
    driver."""
    return PL.run_rebalancing(
        base_cfg, make_layer, list(batches), advance_every=rebalance_every,
        ep_size=ep_size, comm=comm, num_redundant=num_redundant,
        inner_size=inner_size, decay=decay, rebalance_fn=rebalance_fn, params=params,
        expert_keys=expert_keys, donate_params=donate_params,
        min_replicas=min_replicas, fault_domains=fault_domains,
        max_slots_per_rank=max_slots_per_rank)
