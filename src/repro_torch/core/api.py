"""Unified EP API (port of ``src/repro/core/api.py``).

    group   = ep_create_group(cfg, comm)
    handles = ep_create_handle(group, topk_idx, topk_weights)
    handles = ep_handle_refresh(group, handles, topk_weights, topk_idx)  # next step
    outs    = ep_dispatch(group, handles, tokens)        # [(y3d, counts)]
    ...expert FFN...
    ys      = ep_combine(group, handles, expert_out)

or, on the tagged surface (the paper's ``ncclNDTensor_t``), with one list
of ``EpTensor`` inputs per hosted rank:

    outs = ep_dispatch_tensors(group, handles, [[EpTensor(x, TOKENS)], ...])

Every per-rank value is a list indexed like ``group.comm.ranks``; the calls
are collectives over the group, as in the JAX package they run inside
``shard_map``. Each entry point routes through the backend registry keyed by
the group's mode, and ``send_only=True`` returns the staged ``EpPending``s
that ``ep_complete`` finishes.
"""
from __future__ import annotations

import torch

from repro_torch.core import baseline as _baseline  # noqa: F401  (registers baseline)
from repro_torch.core import ht as _ht  # noqa: F401  (registers the HT backend)
from repro_torch.core import ll as _ll  # noqa: F401  (registers the LL backend)
from repro_torch.core import plan as _plan
from repro_torch.core.backend import EpPending, get_backend, registered_modes
from repro_torch.core.group import (EpGroup, EpGroupConfig, EpHandle, ep_create_group,
                                    ep_handle_destroy, ep_handle_get_num_recv_tokens)
from repro_torch.core.tensor import EpTensor, EpTensorTag, validate

__all__ = [
    "EpGroup", "EpGroupConfig", "EpHandle", "EpPending", "ep_create_group",
    "ep_create_handle", "ep_handle_refresh", "ep_dispatch", "ep_combine",
    "ep_complete", "ep_dispatch_tensors", "ep_combine_tensors",
    "ep_handle_get_num_recv_tokens", "ep_handle_destroy", "registered_modes",
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


def ep_handle_refresh(group: EpGroup, handles: list, topk_weights: list,
                      topk_idx: list | None = None, num_tokens=None) -> list[EpHandle]:
    """``ncclEpHandleRefresh``-style steady-state path: rebind per-step
    routing into existing handles without rebuilding their slot maps.
    ``topk_idx=None`` (or each handle's own tensor) rebinds the weights
    only; a new ``topk_idx`` reuses the cached maps where the gathered
    routing's hash is unchanged and rebuilds them where it changed, decided
    on the device (``plan.refresh_handle``). Mode-agnostic."""
    _check(group, "ep_handle_refresh", handles)
    _check(group, "ep_handle_refresh", topk_weights)
    if topk_idx is not None:
        _check(group, "ep_handle_refresh", topk_idx)
    return _plan.refresh_handle(group, handles, topk_weights, topk_idx, num_tokens)


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


# ---------------------------------------------------------------------------
# tagged-tensor surface (C-API parity)
# ---------------------------------------------------------------------------

def _tokens(inputs, ndim: int) -> torch.Tensor:
    """The one TOKENS-tagged input, checked (dtype, rank)."""
    toks = next((t for t in inputs if getattr(t, "tag", None) == EpTensorTag.TOKENS), None)
    if toks is None:
        raise ValueError("no input tagged TOKENS")
    return validate(toks, tag=EpTensorTag.TOKENS, ndim=ndim)


def ep_dispatch_tensors(group: EpGroup, handles: list, inputs: list, *,
                        send_only: bool = False):
    """``ep_dispatch`` on tagged tensors: ``inputs[r]`` is rank r's list of
    ``EpTensor`` holding one [T, H] TOKENS tensor. Returns per rank
    (TOKENS [L, A, H], TOKENS_PER_EXPERTS [L]), or the staged pendings with
    ``send_only=True``."""
    _check(group, "ep_dispatch_tensors", inputs)
    out = ep_dispatch(group, handles, [_tokens(i, 2) for i in inputs],
                      send_only=send_only)
    if send_only:
        return out
    return [(EpTensor(y, EpTensorTag.TOKENS), EpTensor(c, EpTensorTag.TOKENS_PER_EXPERTS))
            for y, c in out]


def ep_combine_tensors(group: EpGroup, handles: list, inputs: list, *,
                       send_only: bool = False):
    """``ep_combine`` on tagged tensors: ``inputs[r]`` holds rank r's
    [L, A, H] TOKENS expert output. Returns per rank a TOKENS [T, H]
    tensor, or the staged pendings with ``send_only=True``."""
    _check(group, "ep_combine_tensors", inputs)
    out = ep_combine(group, handles, [_tokens(i, 3) for i in inputs],
                     send_only=send_only)
    if send_only:
        return out
    return [EpTensor(y, EpTensorTag.TOKENS) for y in out]
