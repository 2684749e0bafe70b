"""Unified EP API (port of ``src/repro/core/api.py``).

    group   = ep_create_group(cfg, comm)
    handles = ep_create_handle(group, topk_idx, topk_weights)
    outs    = ep_dispatch(group, handles, tokens)        # [(y3d, counts)]
    ...expert FFN...
    ys      = ep_combine(group, handles, expert_out)

Every per-rank value is a list indexed like ``group.comm.ranks``; the calls
are collectives over the group, as in the JAX package they run inside
``shard_map``. Each entry point routes through the backend registry keyed by
the group's mode, and ``send_only=True`` returns the staged ``EpPending``s
that ``ep_complete`` finishes.
"""
from __future__ import annotations

from repro_torch.core import ll as _ll  # noqa: F401  (registers the LL backend)
from repro_torch.core.backend import EpPending, get_backend
from repro_torch.core.group import EpGroup, EpGroupConfig, EpHandle, ep_create_group

__all__ = [
    "EpGroup", "EpGroupConfig", "EpHandle", "EpPending", "ep_create_group",
    "ep_create_handle", "ep_dispatch", "ep_combine", "ep_complete",
]


def _check(group: EpGroup, name: str, values) -> None:
    n = len(group.comm.ranks)
    if len(values) != n:
        raise ValueError(f"{name}: got {len(values)} per-rank values for the "
                         f"{n} ranks this process hosts")


def ep_create_handle(group: EpGroup, topk_idx: list, topk_weights: list,
                     num_tokens=None) -> list[EpHandle]:
    """``ncclEpCreateHandle``: gather the routing, build every rank's plan.
    ``num_tokens`` is one int for every rank, a list of them, or None."""
    _check(group, "ep_create_handle", topk_idx)
    _check(group, "ep_create_handle", topk_weights)
    return get_backend(group.mode).create_handle(group, topk_idx,
                                                 topk_weights, num_tokens)


def ep_dispatch(group: EpGroup, handles: list, tokens: list, *,
                send_only: bool = False):
    """``ncclEpDispatch``: [(expert_major [L, A, H], tokens_per_expert [L])]
    per rank, or the staged ``EpPending``s with ``send_only=True``."""
    _check(group, "ep_dispatch", tokens)
    return get_backend(group.mode).dispatch(group, handles, tokens,
                                            send_only=send_only)


def ep_combine(group: EpGroup, handles: list, expert_out: list, *,
               send_only: bool = False):
    """``ncclEpCombine``: [T, H] weighted-combined tokens per rank, or the
    staged ``EpPending``s with ``send_only=True``."""
    _check(group, "ep_combine", expert_out)
    return get_backend(group.mode).combine(group, handles, expert_out,
                                           send_only=send_only)


def ep_complete(group: EpGroup, handles: list, pendings: list):
    """``ncclEpComplete``: finish staged operations, routed by their tags."""
    _check(group, "ep_complete", pendings)
    return get_backend(group.mode).complete(group, handles, pendings)
