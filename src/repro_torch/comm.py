"""Communicators for the EP group.

The EP API takes one value per hosted rank, as a list indexed like
``comm.ranks``. A communicator offers what the EP paths need: the rank
count, the ranks this process hosts, the EP mesh's axes, a non-tiled
all-to-all over the whole group or over one axis of the mesh, and an
all-gather.

``LocalComm(n)`` hosts all n ranks of the group in one process on one
device, the port's counterpart of the JAX package's fake devices under
``shard_map``: its all-to-all is a device-side transpose of the stacked send
buffers and its all-gather a stack. ``axes`` names the EP mesh's axes and
sizes, outermost first, as the JAX mesh does (``(("pod", 2), ("data", 4))``
is two pods of four); the rank is row-major over them, so the pod of a rank
is ``rank // inner_size`` (``src/repro/core/plan.py rank_pod``).
"""
from __future__ import annotations

import math

import torch


class LocalComm:
    """All ``n`` EP ranks hosted in this process (``ranks == range(n)``)
    on a mesh of ``axes`` ((name, size) pairs, outermost first; one axis
    ``"data"`` of n by default)."""

    def __init__(self, n: int, axes=None):
        if n < 1:
            raise ValueError(f"LocalComm needs at least one rank, got {n}")
        axes = (("data", n),) if axes is None else tuple((str(a), int(s)) for a, s in axes)
        if not axes or math.prod(s for _, s in axes) != n or min(s for _, s in axes) < 1:
            raise ValueError(f"mesh axes {axes} do not hold {n} ranks")
        if len({a for a, _ in axes}) != len(axes):
            raise ValueError(f"mesh axes {axes} repeat a name")
        self.size = n
        self.ranks = tuple(range(n))
        self.axes = axes

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def inner_size(self) -> int:
        """Size of the innermost axis: the ranks of one pod."""
        return self.axes[-1][1]

    def all_to_all(self, sends: list[torch.Tensor], axis: str | None = None) -> list[torch.Tensor]:
        """sends[src]: [N_axis, C, ...] -> recvs[dst]: [N_axis, C, ...], each
        contiguous — ``jax.lax.all_to_all(x, axis, split_axis=0,
        concat_axis=0, tiled=False)``. ``axis=None`` exchanges over the
        whole group (N_axis = n); a mesh axis name exchanges among the ranks
        that differ only in that coordinate, block j going to the rank
        whose coordinate is j. One device copy: the stacked buffers
        [s_0, ..., s_m, N_axis, C, ...] with the axis's dim and the block
        dim swapped."""
        if len(sends) != self.size:
            raise ValueError(f"all_to_all got {len(sends)} buffers for "
                             f"{self.size} ranks")
        if axis is None:
            sizes, k = [self.size], 0
        elif axis in self.axis_names:
            sizes, k = [s for _, s in self.axes], self.axis_names.index(axis)
        else:
            raise ValueError(f"all_to_all over {axis!r}: the mesh axes are "
                             f"{self.axis_names}")
        dt = sends[0].dtype
        if dt.is_floating_point and dt.itemsize == 1:
            # fp8 payloads move as their bytes: not every copy kernel takes fp8
            sends = [s.view(torch.uint8) for s in sends]
        x = torch.stack(sends)
        if x.shape[1] != sizes[k]:
            raise ValueError(f"all_to_all over {axis or 'the group'} wants "
                             f"{sizes[k]} blocks per rank, got {x.shape[1]}")
        x = x.view(tuple(sizes) + tuple(x.shape[1:]))
        out = x.transpose(k, len(sizes)).contiguous().view(dt)
        return list(out.view((self.size,) + tuple(out.shape[len(sizes):])).unbind(0))

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """xs[r]: [T, ...] -> every rank gets [N, T, ...] in rank order."""
        if len(xs) != self.size:
            raise ValueError(f"all_gather got {len(xs)} tensors for "
                             f"{self.size} ranks")
        g = torch.stack(xs)
        return [g] * self.size
