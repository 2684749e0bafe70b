"""Slot-map arithmetic (port of ``src/repro/core/slots.py``).

Both endpoints of every transfer derive the same (pair, slot) coordinates
from the replicated routing: an exclusive running count over a fixed entry
order plays the part of the paper's atomic slot counters, so messages need
no headers. ``positions_by_dest`` is the sort-based O(M log M) form, bit for
bit equal to the one-hot oracle in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch


def positions_by_dest(dest: torch.Tensor, num_dest: int, valid: torch.Tensor):
    """For flat entries with destinations ``dest`` [M] and validity ``valid``
    [M]: each entry's slot within its destination's block (the count of valid
    in-range entries j < m with the same clipped destination), and the
    per-destination totals. Returns (pos [M] int32, counts [num_dest] int32);
    invalid entries get a deterministic value the caller masks."""
    M = dest.shape[0]
    dev = dest.device
    if M == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((num_dest,), dtype=torch.int32, device=dev))
    d_clip = dest.clamp(0, num_dest - 1).to(torch.int64)
    eff = (valid & (dest >= 0) & (dest < num_dest)).to(torch.int32)
    order = torch.argsort(d_clip, stable=True)
    d_s = d_clip[order]
    v_s = eff[order]
    excl = (torch.cumsum(v_s, 0) - v_s).to(torch.int32)
    is_start = torch.ones((M,), dtype=torch.bool, device=dev)
    is_start[1:] = d_s[1:] != d_s[:-1]
    # each segment's base is excl at its first element; excl never decreases,
    # so a running max carries the base forward (JAX: associative_scan max)
    base = torch.cummax(torch.where(is_start, excl, 0), 0).values
    pos = torch.zeros((M,), dtype=torch.int32, device=dev)
    pos[order] = excl - base
    counts = torch.zeros((num_dest,), dtype=torch.int32, device=dev)
    counts.scatter_add_(0, d_clip, eff)
    return pos, counts


def build_gather_map(dest: torch.Tensor, pos: torch.Tensor, src: torch.Tensor,
                     valid: torch.Tensor, num_dest: int, capacity: int,
                     sentinel: int) -> torch.Tensor:
    """Map [num_dest, capacity]: map[d, c] = src of the entry in slot (d, c),
    or ``sentinel`` for an empty slot. Invalid entries and entries at
    pos >= capacity are dropped (a masked scatter: JAX's mode="drop")."""
    m = torch.full((num_dest * capacity,), sentinel, dtype=torch.int32,
                   device=dest.device)
    keep = valid & (pos >= 0) & (pos < capacity)
    flat = dest.clamp(0, num_dest - 1).to(torch.int64) * capacity + pos.to(torch.int64)
    m[flat[keep]] = src[keep].to(torch.int32)
    return m.view(num_dest, capacity)


def flat_rows(x: torch.Tensor) -> torch.Tensor:
    """Collapse leading dims so gather maps can address [M, H] rows."""
    return x.reshape((-1,) + tuple(x.shape[-1:]))
