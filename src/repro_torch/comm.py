"""Communicators for the EP group.

The EP API takes one value per hosted rank, as a list indexed like
``comm.ranks``. A communicator offers only what the LL path needs: the rank
count, the ranks this process hosts, a non-tiled all-to-all over the leading
dim and an all-gather.

``LocalComm(n)`` hosts all n ranks of the group in one process on one
device, the port's counterpart of the JAX package's fake devices under
``shard_map``: its all-to-all is a device-side transpose of the stacked send
buffers and its all-gather a stack.
"""
from __future__ import annotations

import torch


class LocalComm:
    """All ``n`` EP ranks hosted in this process (``ranks == range(n)``)."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"LocalComm needs at least one rank, got {n}")
        self.size = n
        self.ranks = tuple(range(n))

    def all_to_all(self, sends: list[torch.Tensor]) -> list[torch.Tensor]:
        """sends[src]: [N_dst, C, ...] -> recvs[dst]: [N_src, C, ...], each
        contiguous — ``jax.lax.all_to_all(x, split_axis=0, concat_axis=0,
        tiled=False)`` over the group."""
        if len(sends) != self.size:
            raise ValueError(f"all_to_all got {len(sends)} buffers for "
                             f"{self.size} ranks")
        return list(torch.stack(sends).transpose(0, 1).contiguous().unbind(0))

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """xs[r]: [T, ...] -> every rank gets [N, T, ...] in rank order."""
        if len(xs) != self.size:
            raise ValueError(f"all_gather got {len(xs)} tensors for "
                             f"{self.size} ranks")
        g = torch.stack(xs)
        return [g] * self.size
