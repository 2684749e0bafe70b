"""Replica-aware expert-weight rebinding and placement-tagged checkpoints
(port of ``src/repro/checkpoint/store.py``).

Expert-stacked weights are logical [E, ...] by default, or in a placement's
physical slot order [N*S, ...] under ``MoESpec.params_physical`` (the
adopt-once serving layout). A rebind from one layout to another collapses
through the source placement's primary replicas and expands for the
destination: replicas of one expert hold identical bits, so a rebalance
that moves or replicates an expert never loses weight state. A slot that
hosts nothing (``EMPTY``: a degraded table's dead row) has no source: a
rebind leaves its rows zero, and a migration moves nothing to it, so a card
whose row is all ``EMPTY`` receives no bytes. Plan-time assignment never
routes a token to such a slot.

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

Checkpoints (``save_checkpoint``, ``latest_step``, ``restore_checkpoint``)
use the reference's format: ``step_{step:08d}/leaf_{i:05d}.npy``, one file
a leaf in JAX's flatten order (dict keys sorted), and ``index.json`` with
the leaf count, each leaf's shape and dtype name, ``extra`` and, under a
placement, ``expert_layout`` (the expert keys, the placement's fingerprint
and its table). bfloat16 goes to disk as its ``uint16`` bits and
float8_e4m3fn / float8_e5m2 as ``uint8``, under the reference's dtype
names, so a checkpoint of the same tree holds the same bytes as the JAX
package's and either package restores the other's. A checkpoint is written
to ``step_*.tmp`` and published by a rename. Restore rebinds the expert
leaves host-side when the requested layout differs from the stored one.
One process writes the whole tree: a ``DistComm`` server, whose process
holds only its own slots, refuses ``ckpt_dir`` (ROADMAP A10d).
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import time

import numpy as np
import torch

from repro_torch.core import placement as PL
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.config import ParamSpec

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
    replica under ``src_placement`` (its own row when logical); -1 for an
    ``EMPTY`` slot, which copies nothing."""
    prim = (np.arange(num_experts) if src_placement is None
            else PL.tables(src_placement).primary_row.astype(np.int64))
    if dst_placement is None:
        return prim
    perm = PL.tables(dst_placement).slot_expert.reshape(-1)
    return np.where(perm == PL.EMPTY, -1, prim[np.where(perm == PL.EMPTY, 0, perm)])


def _rebind_leaf(w, src_placement, dst_placement, axis: int, donate: bool):
    """``w`` rebound along ``axis``; an ``EMPTY`` destination row is zero.
    A numpy leaf is rebound on the host."""
    if _same_layout(src_placement, dst_placement):
        return w
    num_experts = (src_placement or dst_placement).num_experts
    src = _source_rows(src_placement, dst_placement, num_experts)
    empty = np.flatnonzero(src < 0)
    take = np.maximum(src, 0)
    if isinstance(w, np.ndarray):
        out = np.take(w, take, axis=axis)
        if empty.size:
            idx = [slice(None)] * out.ndim
            idx[axis] = empty
            out[tuple(idx)] = 0
        return out
    rows = torch.from_numpy(take).to(w.device)
    holes = torch.from_numpy(empty).to(w.device) if empty.size else None
    if not (donate and rows.numel() == w.shape[axis] and w.is_contiguous()):
        out = torch.index_select(w, axis, rows)
        return out if holes is None else out.index_fill_(axis, holes, 0)
    # the same slot count: permute in place, one layer (or the one leaf) at
    # a time, through a temporary of that size
    layers = [w] if axis == 0 else w.reshape((-1,) + tuple(w.shape[axis:])).unbind(0)
    for layer in layers:
        layer.copy_(torch.index_select(layer, 0, rows))
        if holes is not None:
            layer.index_fill_(0, holes, 0)
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
    layout, the row a one-card rebind reads (``_source_rows``); an
    ``EMPTY`` destination slot reads nothing."""
    s_old = num_experts // ep_size if src_placement is None else src_placement.slots_per_rank
    s_new = num_experts // ep_size if dst_placement is None else dst_placement.slots_per_rank
    moves = {(a, b): ([], []) for a in range(ep_size) for b in range(ep_size)}
    for flat, row in enumerate(_source_rows(src_placement, dst_placement, num_experts)):
        if row < 0:
            continue                 # an EMPTY slot: nothing moves to it
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
    written) and returns (params, {"bytes_sent", "bytes_local",
    "bytes_received", "seconds"}). This process's ``EMPTY`` slots of
    ``dst_placement`` come back zero and receive no bytes. A collective:
    every process of the EP group calls it with the same placements."""
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
    holes = ([] if dst_placement is None else
             [s for s, e in enumerate(dst_placement.slot_expert[me]) if e == PL.EMPTY])
    stats = dict(bytes_sent=0, bytes_local=0, bytes_received=0)

    def migrate(w, axis):
        dev = w.device
        idx = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
               for k, v in (("send", send_src), ("recv", recv_dst),
                            ("lsrc", local_src), ("ldst", local_dst), ("holes", holes))}
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
            if idx["holes"].numel():
                new_l.index_fill_(0, idx["holes"], 0)
            row = old_l[0].numel() * old_l.element_size()
            stats["bytes_sent"] += len(send_src) * row
            stats["bytes_received"] += len(recv_dst) * row
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


# ---------------------------------------------------------------------------
# checkpoints: the reference's on-disk format
# ---------------------------------------------------------------------------

# the dtypes numpy cannot hold, by the reference's name: stored as the
# unsigned integers of their bits, re-viewed on restore
_BIT_DTYPES = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
               torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
               torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8)}
_BY_NAME = {name: (bits, dt) for dt, (name, bits, _) in _BIT_DTYPES.items()}


def _flatten(tree, path=()):
    """(path, leaf) pairs in JAX's flatten order (dict keys sorted, lists
    and tuples in order, None holds no leaf) and the tree's structure as
    JAX prints a ``PyTreeDef``."""
    if isinstance(tree, dict):
        out, parts = [], []
        for k in sorted(tree):
            sub, d = _flatten(tree[k], path + (k,))
            out += sub
            parts.append(f"{k!r}: {d}")
        return out, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        out, parts = [], []
        for i, v in enumerate(tree):
            sub, d = _flatten(v, path + (i,))
            out += sub
            parts.append(d)
        body = ", ".join(parts) + ("," if isinstance(tree, tuple) and len(parts) == 1 else "")
        return out, ("[" + body + "]" if isinstance(tree, list) else "(" + body + ")")
    if tree is None:
        return [], "None"
    return [(path, tree)], "*"


def _unflatten(tree, values):
    """``tree``'s structure with its leaves replaced, in flatten order."""
    it = iter(values)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        if node is None:
            return None
        return next(it)
    return go(tree)


def _keystr(path) -> str:
    """A leaf's path as ``jax.tree_util.keystr`` prints it."""
    return "".join(f"[{k!r}]" for k in path)


def _leaf_name(path):
    """The innermost dict key on a leaf's path: which leaves are expert
    weights, for the save-time check and the restore-time rebind."""
    return next((k for k in reversed(path) if isinstance(k, str)), None)


def _to_savable(leaf):
    """(numpy array to write, the reference's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _BIT_DTYPES:
            name, bits, view = _BIT_DTYPES[t.dtype]
            return t.view(view).numpy().view(bits), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, name: str, dtype, device) -> torch.Tensor:
    """A stored array (bit views re-viewed by ``name``) as a tensor of
    ``dtype`` on ``device``."""
    if name in _BY_NAME:
        bits, dt = _BY_NAME[name]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16 if bits is np.uint16 else np.uint8)).view(dt)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    # ascontiguousarray makes a 0-d array 1-d (an optimizer's step)
    t = t.reshape(arr.shape)
    return t.to(device=device, dtype=dtype)


def save_checkpoint(ckpt_dir, step: int, tree, *, extra: dict | None = None,
                    placement=None, expert_keys=EXPERT_PARAM_KEYS):
    """Write one checkpoint of ``tree`` (tensors, numpy arrays or scalars in
    dicts, lists and tuples). With ``placement`` the tree's expert leaves
    are declared to be in that placement's physical slot order (the
    adopt-once serving layout): its table and fingerprint are recorded, so
    ``restore_checkpoint`` can validate the layout or rebind to whatever
    placement the restoring process wants. The declaration is checked
    before anything is written: every expert leaf must hold the
    placement's slot count on its expert axis (0, or 1 for stacked
    leaves). Returns the checkpoint's directory."""
    leaves, treedef = _flatten(tree)
    if placement is not None:
        keys, S = set(expert_keys), placement.num_slots
        for path, leaf in leaves:
            if _leaf_name(path) in keys and S not in tuple(leaf.shape[:2]):
                raise ValueError(
                    f"save_checkpoint(placement=...): expert leaf {_keystr(path)} has "
                    f"shape {tuple(leaf.shape)} but the placement defines {S} physical "
                    "slots — the tree is not in this placement's physical layout "
                    "(adopt_expert_params first)")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    index = dict(step=step, n_leaves=len(leaves), treedef=f"PyTreeDef({treedef})",
                 time=time.time(), extra=extra or {})
    if placement is not None:
        index["expert_layout"] = dict(keys=list(expert_keys),
                                      fingerprint=placement.fingerprint(),
                                      placement=PL.placement_to_jsonable(placement))
    shapes = []
    for i, (_, leaf) in enumerate(leaves):
        arr, name = _to_savable(leaf)
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        shapes.append([list(arr.shape), name])
    index["shapes"] = shapes
    (tmp / "index.json").write_text(json.dumps(index))
    if d.exists():                    # publish by a rename
        shutil.rmtree(d)
    tmp.rename(d)
    return d


def latest_step(ckpt_dir) -> int | None:
    """The highest published step under ``ckpt_dir`` (None: none)."""
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir() if (m := re.match(r"step_(\d+)$", p.name))]
    return max(steps) if steps else None


# restore the expert leaves as stored (no layout change)
_AS_STORED = object()


def restore_checkpoint(ckpt_dir, step: int, target_tree, *, placement=_AS_STORED,
                       expert_keys=None, device=None):
    """Restore checkpoint ``step`` into the structure of ``target_tree``:
    a tree of tensors (each restored leaf takes its target's dtype and
    device), of ``ParamSpec`` (dtype from the spec, on ``device``; CUDA by
    default, as every entry point) or of numpy arrays (a numpy leaf stays
    numpy, at its target's dtype). Returns (tree, index).

    ``placement`` asks for the expert leaves' layout: an ``EpPlacement``
    (its physical slot order), None (logical [E, ...]) or omitted (as
    stored). When it differs from the stored layout (fingerprints' tables
    compared; no record = logical), the expert leaves are rebound on the
    host: collapsed through the stored placement's primary replicas and
    expanded for the requested one, ``EMPTY`` slots zero. A ``ParamSpec``
    target names the expert axis (``axes``); a plain target's expert leaves
    (by ``expert_keys``, default the keys recorded at save) are rebound
    along their leading axis, which must hold the stored slot count."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    index = json.loads((d / "index.json").read_text())
    leaves, _ = _flatten(target_tree)
    if len(leaves) != index["n_leaves"]:
        raise ValueError(f"leaf count mismatch: {len(leaves)} vs {index['n_leaves']}")
    layout = index.get("expert_layout")
    src_pl = PL.placement_from_jsonable(layout["placement"]) if layout else None
    dst_pl = src_pl if placement is _AS_STORED else placement
    need_rebind = not _same_layout(src_pl, dst_pl)
    keys = set(expert_keys if expert_keys is not None
               else (layout["keys"] if layout else EXPERT_PARAM_KEYS))
    src_rows = (src_pl.num_slots if src_pl else dst_pl.num_experts if dst_pl else None)
    dev = None
    out = []
    for i, (path, tgt) in enumerate(leaves):
        name = index["shapes"][i][1]
        arr = np.load(d / f"leaf_{i:05d}.npy")
        if need_rebind:
            axes = tgt.axes if isinstance(tgt, ParamSpec) else None
            if axes and "expert" in axes:
                arr = _rebind_leaf(arr, src_pl, dst_pl, axes.index("expert"), False)
            elif _leaf_name(path) in keys:
                if arr.shape[0] != src_rows:
                    raise ValueError(
                        f"cannot rebind leaf {_keystr(path)}: axis 0 has {arr.shape[0]} "
                        f"rows but the stored layout defines {src_rows} expert slots — "
                        "for stacked expert leaves restore against a ParamSpec target "
                        "(the spec's \"expert\" axis names the rebind axis)")
                arr = _rebind_leaf(arr, src_pl, dst_pl, 0, False)
        if isinstance(tgt, ParamSpec):
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(
                    f"restored leaf {_keystr(path)} has shape {tuple(arr.shape)} but the "
                    f"target spec says {tuple(tgt.shape)} — for expert-stacked weights "
                    "this usually means the checkpoint's placement layout doesn't match "
                    "the requested one (pass placement=... to rebind)")
            dev = resolve_device(device) if dev is None else dev
            out.append(_to_tensor(arr, name, tgt.dtype, dev))
        elif isinstance(tgt, torch.Tensor):
            out.append(_to_tensor(arr, name, tgt.dtype, tgt.device))
        elif isinstance(tgt, (np.ndarray, np.generic)):
            if name in _BY_NAME:
                arr = _to_tensor(arr, name, torch.float32, "cpu").numpy()
            out.append(np.asarray(arr, dtype=tgt.dtype))
        else:
            out.append(arr)
    return _unflatten(target_tree, out), index
