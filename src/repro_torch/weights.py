"""Parameters: random init on the device, and the bridge from the JAX
package's parameter tree.

``init_params`` follows ``src/repro/parallel/sharding.py:init_from_specs``:
ones and zeros where the spec says, else normal × scale/√fan_in with fan_in
the second-to-last dim. The values are drawn on the device from a seeded
``torch.Generator`` (DBRX-132B at full width has ~10¹⁰ values per 4 layers,
too many to draw on the CPU); they are not JAX's values. Tests that compare
the packages build one tree with JAX and carry it over with
``params_from_jax``. Both keep JAX's layouts and names.

``shard_params`` cuts a full tree down to what one process of a
``DistComm`` mesh holds: the experts of its EP rank and, under expert
tensor parallelism, its F-slice of them (``src/repro/models/moe.py``'s
``ew_spec``); everything else is replicated. ``init_params(..., comm=)``
draws the same values as the full tree and keeps only that shard, one leaf
(and of stacked experts, one layer) at a time.

EPLB: under ``MoESpec.params_physical`` with a placement the expert leaves
are in the placement's slot order. ``init_params`` still draws the logical
tree (so replicas of one expert hold the same bits, and the values equal a
server's without EPLB on the same seed) and adopts the placement once,
layer by layer; a process of a ``DistComm`` keeps the rows of its own
slots. ``params_from_jax`` takes a physical tree as the spec says.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import dataclasses

from repro_torch.core import placement as PL
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import ep_active
from repro_torch.models.transformer import check_supported, lm_spec

# numpy dtypes torch.from_numpy does not know, by name -> (bit view, torch dtype)
_BIT_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order (JAX's dict flatten order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# expert-stacked weights and the dim of each that expert-TP slices
# (w_gate, w_up [..., E, D, F]: F last; w_down [..., E, F, D])
_EXPERT_F_DIM = {"w_gate": -1, "w_up": -1, "w_down": -2}


def _shard_leaf(path, t: torch.Tensor, cfg: ArchConfig, comm) -> torch.Tensor:
    """The part of leaf ``path`` that this process of ``comm`` holds."""
    if len(path) < 2 or path[-2] != "moe" or path[-1] not in _EXPERT_F_DIM \
            or not ep_active(cfg, comm):
        return t
    if len(comm.ranks) == comm.size and comm.tp_axis is None:
        return t                             # every rank is hosted here
    m = cfg.moe
    L = (m.placement.num_slots if m.params_physical and m.placement is not None
         else m.num_experts) // comm.size
    e_dim = t.dim() - 3                      # after a stacked layer dim, if any
    t = t.narrow(e_dim, comm.ranks[0] * L, len(comm.ranks) * L)
    if comm.tp_axis is not None:
        m = dict(comm.mesh)[comm.tp_axis]
        f_dim = t.dim() + _EXPERT_F_DIM[path[-1]]
        if t.shape[f_dim] % m:
            raise ValueError(f"{'/'.join(path)}: d_ff_expert {t.shape[f_dim]} must "
                             f"split evenly over {comm.tp_axis}={m}")
        f = t.shape[f_dim] // m
        t = t.narrow(f_dim, comm.coords[comm.tp_axis] * f, f)
    return t.contiguous()


def shard_params(params, cfg: ArchConfig, comm):
    """This process's part of the full tree ``params`` (``init_params`` or
    ``params_from_jax``): the experts (physical mode: the slots) [r*L,
    (r+1)*L) of each hosted EP rank r, their F-slice at its ``model`` coordinate under expert-TP, the rest
    as it is. A ``LocalComm`` hosts every rank: its part is the whole tree.
    Leaves that are not cut are the same tensors."""
    out: dict = {}
    for path, t in _leaves(params):
        _set(out, path, _shard_leaf(path, t, cfg, comm))
    return out


def _draw(shape, s, gen, dev) -> torch.Tensor:
    """One leaf of spec ``s`` at ``shape``: its constant, or normal values
    drawn from ``gen``."""
    if s.init in ("zeros", "ones"):
        return (torch.zeros if s.init == "zeros" else torch.ones)(shape, dtype=s.dtype,
                                                                  device=dev)
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    std = s.scale / math.sqrt(max(fan_in, 1))
    return torch.empty(shape, dtype=s.dtype, device=dev).normal_(0.0, std, generator=gen)


def _physical(cfg: ArchConfig):
    """The placement the expert weights of ``cfg`` are laid out for, or
    None when they are logical."""
    m = cfg.moe
    return m.placement if m is not None and m.params_physical else None


def init_params(cfg: ArchConfig, seed: int = 0, device=None, comm=None):
    """Random parameters for ``cfg``, drawn on ``device`` (CUDA by default);
    with ``comm``, the shard of them this process holds
    (``shard_params(init_params(cfg, seed, device), cfg, comm)``). A leaf of
    stacked experts ([layers, E, D, F]: 7.5 GB a layer at DeepSeek-V3's
    width) is drawn one layer at a time, with or without ``comm``, and each
    layer is adopted into the physical slot order (under
    ``params_physical``) and cut to the shard at once, so a process never
    holds more than one full layer of it beside its shard."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    placement = _physical(cfg)
    # draw the logical tree: replicas then hold identical bits
    logical = cfg if placement is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, params_physical=False))
    params: dict = {}
    for path, s in _leaves(lm_spec(logical)):
        if path[-1] in _EXPERT_F_DIM and len(path) >= 2 and path[-2] == "moe" \
                and len(s.shape) == 4:
            t = None
            for i in range(s.shape[0]):
                layer = _draw(s.shape[1:], s, gen, dev)
                if placement is not None:
                    layer = PL.expand_expert_params(layer, placement)
                part = layer if comm is None else _shard_leaf(path, layer, cfg, comm)
                if t is None:
                    t = torch.empty((s.shape[0],) + tuple(part.shape), dtype=s.dtype,
                                    device=dev)
                t[i].copy_(part)
                del layer, part
            _set(params, path, t)
        else:
            t = _draw(s.shape, s, gen, dev)
            if placement is not None and s.axes is not None and "expert" in s.axes:
                t = PL.expand_expert_params(t, placement, s.axes.index("expert"))
            _set(params, path, t if comm is None else _shard_leaf(path, t, cfg, comm))
        del t
    return params


def _to_torch(a: np.ndarray) -> torch.Tensor:
    view = _BIT_VIEWS.get(str(a.dtype))
    a = np.array(a, order="C")           # a writable copy (device_get's are not)
    if view is None:
        return torch.from_numpy(a)
    return torch.from_numpy(a.view(view[0])).view(view[1])


def params_from_jax(tree, cfg: ArchConfig, device=None):
    """The JAX package's parameter tree (numpy arrays, e.g. from
    ``jax.device_get``) as the port's parameters: same names, same layouts,
    each leaf checked against the port's spec."""
    check_supported(cfg)
    dev = resolve_device(device)
    specs = dict(_leaves(lm_spec(cfg)))
    got = dict(_leaves(tree))
    if specs.keys() != got.keys():
        raise ValueError(f"parameter trees differ: missing "
                         f"{sorted(specs.keys() - got.keys())}, extra "
                         f"{sorted(got.keys() - specs.keys())}")
    params: dict = {}
    for path, s in specs.items():
        t = _to_torch(np.asarray(got[path]))
        if tuple(t.shape) != s.shape or t.dtype != s.dtype:
            raise ValueError(f"{'/'.join(path)}: got {t.dtype} {tuple(t.shape)}, "
                             f"the spec wants {s.dtype} {s.shape}")
        _set(params, path, t.to(dev))
    return params
