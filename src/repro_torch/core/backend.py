"""EpBackend: the staged-EP backend protocol and its registry (port of
``src/repro/core/backend.py``).

Send and complete are the primitive; eager ``dispatch``/``combine`` are
derived as send then complete, so no backend can accept ``send_only`` and
silently run eager. ``EpPending`` carries its mode and op so ``ep_complete``
routes by tag. In the port every phase takes and returns one value per
hosted rank (a list indexed like ``group.comm.ranks``).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EpPending:
    """One rank's in-flight staged EP operation: received but unconsumed
    payload rows, plus the fp8 scales when the payload is quantized."""

    mode: str                               # owning backend ("ll", ...)
    op: str                                 # "dispatch" | "combine"
    recv: torch.Tensor
    recv_scales: torch.Tensor | None = None


class BaseBackend:
    """Driver half of the protocol: eager = send ∘ complete. Subclasses
    implement ``create_handle`` and the four phase halves."""

    mode: str = "?"

    def create_handle(self, group, topk_idx, topk_weights, num_tokens=None):
        raise NotImplementedError

    def dispatch_send(self, group, handles, tokens) -> list[EpPending]:
        raise NotImplementedError

    def dispatch_complete(self, group, handles, pendings):
        raise NotImplementedError

    def combine_send(self, group, handles, expert_out) -> list[EpPending]:
        raise NotImplementedError

    def combine_complete(self, group, handles, pendings):
        raise NotImplementedError

    def dispatch(self, group, handles, tokens, *, send_only: bool = False):
        pendings = self.dispatch_send(group, handles, tokens)
        if send_only:
            return pendings
        return self.dispatch_complete(group, handles, pendings)

    def combine(self, group, handles, expert_out, *, send_only: bool = False):
        pendings = self.combine_send(group, handles, expert_out)
        if send_only:
            return pendings
        return self.combine_complete(group, handles, pendings)

    def complete(self, group, handles, pendings):
        ops = set()
        for p in pendings:
            if not isinstance(p, EpPending):
                raise TypeError(f"not a pending EP operation: {type(p)}")
            if p.mode != self.mode:
                raise ValueError(
                    f"pending op belongs to mode {p.mode!r}, but the group "
                    f"resolved mode {self.mode!r}")
            ops.add(p.op)
        if len(ops) != 1:
            raise ValueError(f"pendings mix operations {sorted(ops)}")
        op = ops.pop()
        if op == "dispatch":
            return self.dispatch_complete(group, handles, pendings)
        if op == "combine":
            return self.combine_complete(group, handles, pendings)
        raise ValueError(f"unknown pending op: {op!r}")


_REGISTRY: dict[str, BaseBackend] = {}


def register_backend(backend: BaseBackend) -> BaseBackend:
    """Register a backend under its ``mode`` (last registration wins)."""
    _REGISTRY[backend.mode] = backend
    return backend


def get_backend(mode: str) -> BaseBackend:
    """The only mode dispatch in the API layer."""
    if mode in _REGISTRY:
        return _REGISTRY[mode]
    raise KeyError(f"no EP backend registered for mode {mode!r}; "
                   f"known: {sorted(_REGISTRY)}")
