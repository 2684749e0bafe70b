"""AdamW with global-norm clipping and a cosine schedule (port of
``src/repro/optim/adamw.py``).

The state is ``{"m": tree, "v": tree, "step": int32 scalar}``, the moments
shaped like the parameters in ``state_dtype``: f32 by default, bf16 for the
large configurations (a one-card DBRX-132B layer does not fit with f32
moments beside its f32 gradient sums). The update follows the reference
line for line: the global gradient norm and the clip in f32, the bias
corrections from the f32 step, the decay on the f32 parameter, and each
result cast back to its leaf's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.config import ParamSpec


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: Any = torch.float32


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay to
    0 at ``total_steps``; f32 of the step."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def adamw_init_specs(param_specs, cfg: AdamWConfig):
    """The state's ParamSpecs: moments shaped and laid out like the
    parameters, in ``state_dtype``, and the step."""
    def one(s: ParamSpec):
        return ParamSpec(s.shape, cfg.state_dtype, "zeros", s.scale, s.axes)
    return dict(m=_map(one, param_specs), v=_map(one, param_specs),
                step=ParamSpec((), torch.int32, "zeros"))


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments on each parameter's device, step 0."""
    dev = next(iter(_leaves(params))).device
    z = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    return dict(m=_map(z, params), v=_map(z, params),
                step=torch.zeros((), dtype=torch.int32, device=dev))


# elements per slice of a leaf in the update: its f32 temporaries stay at
# a few slices' size (one expert leaf of DBRX-132B holds 1.06e9 elements,
# 4.2 GB in f32)
CHUNK = 1 << 26


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


@torch.no_grad()
def sq_sum(leaves, device) -> torch.Tensor:
    """The f32 sum of the squares of ``leaves``' elements, slice by slice,
    in order."""
    gsq = torch.zeros((), dtype=torch.float32, device=device)
    for g in leaves:
        for gs in _slices(g):
            gsq = gsq + gs.float().square().sum()
    return gsq


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, gsq: torch.Tensor | None = None):
    """One AdamW step -> (params, state, {"grad_norm", "lr"}). Parameters
    and moments are updated in place, a slice of each leaf at a time, and
    returned (the reference's jitted step donates both); the step is a new
    tensor. Every element's arithmetic is the reference's, so the slicing
    changes no value. ``gsq`` is the global sum of the gradients' squares
    where ``grads`` holds only this process's part of the gradients (the
    train step over a ``DistComm``); by default ``sq_sum`` of ``grads``."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    if gsq is None:
        gsq = sq_sum(_leaves(grads), step.device)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    sf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)

    def upd(p, g, m, v):
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            gf = gs.float() * scale
            m2 = cfg.b1 * ms.float() + (1 - cfg.b1) * gf
            v2 = cfg.b2 * vs.float() + (1 - cfg.b2) * gf * gf
            mh, vh = m2 / bc1, v2 / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * delta)
            ms.copy_(m2)
            vs.copy_(v2)

    _map(upd, params, grads, state["m"], state["v"])
    return params, dict(m=state["m"], v=state["v"], step=step), dict(grad_norm=gnorm, lr=lr)
