"""MoE routers (port of ``src/repro/core/routing.py``): top-k gating that
produces the (topk_idx, topk_weights) pair driving dispatch and combine.

Softmax top-k (DBRX) and sigmoid with group-limited selection and a
selection-only bias (DeepSeek-V3), plus the load-balancing aux loss and the
router z loss. ``jax.lax.top_k`` breaks ties toward the lower index and
``torch.topk`` promises no order, so ``_top_k`` sorts stably instead.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    num_experts: int
    top_k: int
    gating: Literal["softmax", "sigmoid"] = "softmax"
    n_groups: int = 1
    topk_groups: int = 1
    use_selection_bias: bool = False
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    aux_loss_weight: float = 0.0
    z_loss_weight: float = 0.0


@dataclasses.dataclass
class RouterOutput:
    topk_idx: torch.Tensor       # [T, K] int32 global expert ids
    topk_weights: torch.Tensor   # [T, K] f32 combine weights
    aux_loss: torch.Tensor       # scalar
    z_loss: torch.Tensor         # scalar
    expert_load: torch.Tensor    # [E] f32 fraction of tokens routed to e


def _top_k(x: torch.Tensor, k: int):
    """Largest k along the last dim, ties to the lower index (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_limited_mask(scores: torch.Tensor, cfg: RouterConfig) -> torch.Tensor:
    """Keep the topk_groups groups with the largest sum of their top-2
    scores. scores [T, E] -> bool [T, E] of eligible experts."""
    T, E = scores.shape
    g = cfg.n_groups
    per = E // g
    top2 = _top_k(scores.reshape(T, g, per), min(2, per))[0].sum(-1)   # [T, g]
    _, gidx = _top_k(top2, cfg.topk_groups)
    gmask = torch.zeros((T, g), dtype=torch.bool, device=scores.device)
    gmask.scatter_(1, gidx, True)
    return gmask.repeat_interleave(per, dim=-1)


def route(logits: torch.Tensor, cfg: RouterConfig,
          selection_bias: torch.Tensor | None = None) -> RouterOutput:
    """Top-k routing from raw router logits [T, E]."""
    T, E = logits.shape
    logits = logits.float()
    scores = logits.softmax(-1) if cfg.gating == "softmax" else logits.sigmoid()
    select = scores
    if cfg.use_selection_bias and selection_bias is not None:
        select = scores + selection_bias[None, :]
    if cfg.n_groups > 1:
        select = torch.where(_group_limited_mask(select, cfg), select, -torch.inf)
    _, idx = _top_k(select, cfg.top_k)
    topk_w = torch.gather(scores, -1, idx)      # weights from unbiased scores
    if cfg.norm_topk_prob:
        topk_w = topk_w / topk_w.sum(-1, keepdim=True).clamp_min(1e-20)
    topk_w = topk_w * cfg.routed_scaling_factor
    # Switch/GShard load-balancing aux loss: E * sum_e f_e * p_e
    f = F.one_hot(idx, E).float().sum(1).mean(0)
    p = logits.softmax(-1).mean(0)
    aux = E * (f * p).sum() * cfg.aux_loss_weight
    z = (torch.logsumexp(logits, -1) ** 2).mean() * cfg.z_loss_weight
    return RouterOutput(topk_idx=idx.to(torch.int32), topk_weights=topk_w.float(),
                        aux_loss=aux, z_loss=z, expert_load=f)
