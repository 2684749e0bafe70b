"""Parameters: random init on the device, and the bridge from the JAX
package's parameter tree.

``init_params`` follows ``src/repro/parallel/sharding.py:init_from_specs``:
ones and zeros where the spec says, else normal × scale/√fan_in with fan_in
the second-to-last dim. The values are drawn on the device from a seeded
``torch.Generator`` (DBRX-132B at full width has ~10¹⁰ values per 4 layers,
too many to draw on the CPU); they are not JAX's values. Tests that compare
the packages build one tree with JAX and carry it over with
``params_from_jax``. Both keep JAX's layouts and names.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
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


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    """Random parameters for ``cfg``, drawn on ``device`` (CUDA by default)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: dict = {}
    for path, s in _leaves(lm_spec(cfg)):
        if s.init == "zeros":
            t = torch.zeros(s.shape, dtype=s.dtype, device=dev)
        elif s.init == "ones":
            t = torch.ones(s.shape, dtype=s.dtype, device=dev)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale / math.sqrt(max(fan_in, 1))
            t = torch.empty(s.shape, dtype=s.dtype, device=dev).normal_(
                0.0, std, generator=gen)
        _set(params, path, t)
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
