"""Replica-aware expert-weight rebinding (port of ``rebind_expert_leaves``
and ``adopt_expert_params`` of ``src/repro/checkpoint/store.py``; saving
and restoring a checkpoint with its placement is ROADMAP A10b).

Expert-stacked weights are logical [E, ...] by default, or in a placement's
physical slot order [N*S, ...] under ``MoESpec.params_physical`` (the
adopt-once serving layout). A rebind from one layout to another collapses
through the source placement's primary replicas and expands for the
destination: replicas of one expert hold identical bits, so a rebalance
that moves or replicates an expert never loses weight state.

Over a ``DistComm`` each process holds the rows of its own slots, and an
adoption moves rows between processes (``migrate_expert_params``): every
process derives the same move list from the two placements, one source
replica for each new slot (the primary, as ``collapse_expert_params``
takes it), and the rows move with one ``all_to_all_single`` over the EP
group per leaf and layer; rows that stay on their card are copied locally.
An expert-TP shard (the ``model`` axis) moves along EP only. The result is
bitwise the same rows as the adoption of the whole tree on one card.

Donation (``donate=True``): the rebind takes ownership of the tree. It
rebinds the tree's dict in place, so each old leaf is freed as soon as its
new one is written (when nobody else holds it) and the peak is the tree
plus one leaf; where the slot count stays the same, the leaf itself is
permuted in place one layer at a time, and the peak is the tree plus one
layer of one leaf. Without donation the input tree is left as it was and
a new tree is returned.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import placement as PL
from repro_torch.device import synchronize

EXPERT_PARAM_KEYS = PL.EXPERT_PARAM_KEYS


def _same_layout(src_placement, dst_placement) -> bool:
    if src_placement is dst_placement:
        return True
    if src_placement is None or dst_placement is None:
        # None = logical order; only an identity table matches it exactly
        other = src_placement if dst_placement is None else dst_placement
        return other.is_identity()
    return src_placement.slot_expert == dst_placement.slot_expert


def _source_rows(src_placement, dst_placement, num_experts: int) -> np.ndarray:
    """For each destination row (logical expert, or physical slot of
    ``dst_placement``), the source row it copies: the expert's primary
    replica under ``src_placement`` (its own row when logical)."""
    prim = (np.arange(num_experts) if src_placement is None
            else PL.tables(src_placement).primary_row.astype(np.int64))
    if dst_placement is None:
        return prim
    perm = PL.tables(dst_placement).slot_expert.reshape(-1)
    return prim[np.where(perm == PL.EMPTY, 0, perm)]


def _rebind_leaf(w, src_placement, dst_placement, axis: int, donate: bool):
    if _same_layout(src_placement, dst_placement):
        return w
    num_experts = (src_placement or dst_placement).num_experts
    rows = torch.from_numpy(_source_rows(src_placement, dst_placement, num_experts))
    rows = rows.to(w.device)
    if not (donate and rows.numel() == w.shape[axis] and w.is_contiguous()):
        return torch.index_select(w, axis, rows)
    # the same slot count: permute in place, one layer (or the one leaf) at
    # a time, through a temporary of that size
    if axis == 0:
        w.copy_(torch.index_select(w, 0, rows))
        return w
    for layer in w.reshape((-1,) + tuple(w.shape[axis:])).unbind(0):
        layer.copy_(torch.index_select(layer, 0, rows))
    return w


def rebind_expert_leaves(tree, expert_keys=EXPERT_PARAM_KEYS,
                         src_placement=None, dst_placement=None, *,
                         axis: int = 0, donate: bool = False):
    """Rebind the leaves of ``tree`` whose dict key is in ``expert_keys``
    from ``src_placement``'s slot order (None = logical [E, ...]) to
    ``dst_placement``'s (None = back to logical), along ``axis``. Every
    other leaf passes through as the same object. Tensors rebind on their
    device; ``donate`` as the module says."""
    keys = set(expert_keys)

    def go(node):
        if not isinstance(node, dict):
            return node
        out = node if donate else {}
        for k in list(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = go(v)
            elif k in keys:
                out[k] = None if donate else v     # drop the old leaf first
                out[k] = _rebind_leaf(v, src_placement, dst_placement, axis, donate)
                del v
            else:
                out[k] = v
        return out

    return go(tree)


def adopt_expert_params(params, specs, src_placement=None, dst_placement=None,
                        *, donate: bool = True):
    """Adopt-once rebinding over a whole parameter tree: every leaf whose
    ``ParamSpec`` names an ``"expert"`` axis is rebound from
    ``src_placement``'s slot order to ``dst_placement``'s along that axis
    (a stacked [n_layers, slots, ...] leaf along its second). Other leaves
    pass through. The ``MoESpec.params_physical`` serving path rebinds once
    at a placement's adoption instead of expanding every step. ``donate``
    (the default: adoption takes ownership) rebinds ``params`` in place."""
    def go(spec, node):
        if isinstance(spec, dict):
            out = node if donate else {}
            for k in spec:
                out[k] = go(spec[k], node[k])
            return out
        axes = spec.axes or ()
        if "expert" not in axes:
            return node
        return _rebind_leaf(node, src_placement, dst_placement,
                            axes.index("expert"), donate)

    return go(specs, params)


def migration_plan(src_placement, dst_placement, num_experts: int, ep_size: int):
    """The moves of an adoption over ``ep_size`` processes: for each (source
    rank, destination rank), the source slots and destination slots, in
    destination-slot order (the same lists in every process). Each
    destination slot reads its expert's primary replica in the source
    layout, the row a one-card rebind reads (``_source_rows``)."""
    s_old = num_experts // ep_size if src_placement is None else src_placement.slots_per_rank
    s_new = num_experts // ep_size if dst_placement is None else dst_placement.slots_per_rank
    moves = {(a, b): ([], []) for a in range(ep_size) for b in range(ep_size)}
    for flat, row in enumerate(_source_rows(src_placement, dst_placement, num_experts)):
        d, slot = divmod(flat, s_new)
        r, s_src = divmod(int(row), s_old)
        moves[(r, d)][0].append(s_src)
        moves[(r, d)][1].append(slot)
    return moves


def migrate_expert_params(params, specs, src_placement, dst_placement, comm):
    """Adopt ``dst_placement`` over a ``DistComm``: this process's expert
    leaves hold its rank's slots of ``src_placement`` (None: its block of
    logical experts) and come back holding its slots of ``dst_placement``.
    Rebinds ``params`` in place (each old leaf is freed when its new one is
    written) and returns (params, {"bytes_sent", "bytes_local", "seconds"}).
    A collective: every process of the EP group calls it with the same
    placements."""
    import time
    t0 = time.perf_counter()
    me, n = comm.ranks[0], comm.size
    E = (src_placement or dst_placement).num_experts
    moves = migration_plan(src_placement, dst_placement, E, n)
    send_src = [s for d in range(n) if d != me for s in moves[(me, d)][0]]
    send_counts = [0 if d == me else len(moves[(me, d)][0]) for d in range(n)]
    recv_counts = [0 if r == me else len(moves[(r, me)][0]) for r in range(n)]
    recv_dst = [s for r in range(n) if r != me for s in moves[(r, me)][1]]
    local_src, local_dst = moves[(me, me)]
    s_new = (dst_placement.slots_per_rank if dst_placement is not None else E // n)
    stats = dict(bytes_sent=0, bytes_local=0)

    def migrate(w, axis):
        dev = w.device
        idx = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
               for k, v in (("send", send_src), ("recv", recv_dst),
                            ("lsrc", local_src), ("ldst", local_dst))}
        shape = list(w.shape)
        shape[axis] = s_new
        out = w.new_empty(shape)
        lead = w.reshape((-1,) + tuple(w.shape[axis:]))
        for old_l, new_l in zip(lead.unbind(0), out.reshape(lead.shape[:1] + (s_new,)
                                                            + tuple(w.shape[axis + 1:]))
                                .unbind(0)):
            if idx["ldst"].numel():
                new_l.index_copy_(0, idx["ldst"], old_l.index_select(0, idx["lsrc"]))
            got = comm.all_to_all_rows(old_l.index_select(0, idx["send"]),
                                       send_counts, recv_counts)
            if idx["recv"].numel():
                new_l.index_copy_(0, idx["recv"], got)
            row = old_l[0].numel() * old_l.element_size()
            stats["bytes_sent"] += len(send_src) * row
            stats["bytes_local"] += len(local_src) * row
        return out

    def go(spec, node):
        if isinstance(spec, dict):
            for k in spec:
                node[k] = go(spec[k], node[k])
            return node
        axes = spec.axes or ()
        if "expert" not in axes:
            return node
        return migrate(node, axes.index("expert"))

    go(specs, params)
    synchronize(_tree_device(params))
    stats["seconds"] = time.perf_counter() - t0
    return params, stats


def _tree_device(tree) -> torch.device:
    """The device of a parameter tree's first leaf."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device
