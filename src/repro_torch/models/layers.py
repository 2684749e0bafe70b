"""Shared primitive layers (port of ``src/repro/models/layers.py``): norms,
RoPE, gated FFNs, embeddings, the cross-entropy loss."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ParamSpec


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    x2 = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(x2 + eps)).to(x.dtype) * w


def rmsnorm_spec(d: int, dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec((d,), dtype, init="ones")


def rope_frequencies(rot_dim: int, base: float) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))


@functools.lru_cache(maxsize=None)
def _rope_table(rot_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` as f32 on ``device``, made once per (width,
    base, device): a step then copies no host data to the device, which a
    captured step could not do."""
    return torch.tensor(rope_frequencies(rot_dim, base), dtype=torch.float32,
                        device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]. Rotates the first
    ``fraction * D`` components (interleaved pairs)."""
    B, S, H, D = x.shape
    rot = int(D * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = _rope_table(rot, base, x.device)
    ang = positions.float()[:, :, None] * inv[None, None, :]      # [B, S, rot/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(B, S, H, rot)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def ffn_spec(d: int, f: int, dtype=torch.bfloat16, act: str = "swiglu"):
    if act == "gelu":
        return dict(w_in=ParamSpec((d, f), dtype), w_out=ParamSpec((f, d), dtype))
    return dict(w_gate=ParamSpec((d, f), dtype), w_up=ParamSpec((d, f), dtype),
                w_down=ParamSpec((f, d), dtype))


def ffn_apply(p, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    if act == "gelu":
        return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = (F.gelu(g, approximate="tanh") if act == "geglu" else F.silu(g)) * u
    return h @ p["w_down"]


def embed_spec(vocab: int, d: int, dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec((vocab, d), dtype, init="embed")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def logits_out(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Final projection in f32 (stable softmax / argmax)."""
    return torch.einsum("bsd,vd->bsv", x.float(), table.float())


# rows per log-sum-exp pass of cross_entropy
CE_ROWS = 1024


def cross_entropy_sum(logits: torch.Tensor, targets: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """[the summed token NLL of ``logits`` [..., V] against ``targets``
    [...], the count of tokens it sums] (masked with ``mask``), as one [2]
    tensor that a process group can sum. Each row's log-sum-exp is taken
    over blocks of ``CE_ROWS`` rows, so the temporaries stay at one block's
    size (the f32 logits of a 32k-token batch over a 100k vocabulary are 13
    GB); every row's value is the same as in one pass."""
    flat = logits.reshape(-1, logits.shape[-1])
    lse = torch.cat([torch.logsumexp(flat[i:i + CE_ROWS], dim=-1)
                     for i in range(0, flat.shape[0], CE_ROWS)])
    ll = torch.take_along_dim(flat, targets.reshape(-1, 1).long(), dim=-1)[:, 0]
    return _masked_sum((lse - ll).reshape(targets.shape), mask)


def _masked_sum(nll: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """[sum of nll under mask, the mask's sum] as one [2] tensor."""
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.to(nll.dtype)
    return torch.stack([(nll * mask).sum(), mask.sum()])


def _block_nll(xb: torch.Tensor, table_f: torch.Tensor, tg: torch.Tensor) -> torch.Tensor:
    """The token NLL of rows xb [n, D] through the f32 head ``table_f``."""
    logits = xb.float() @ table_f.t()
    ll = torch.take_along_dim(logits, tg[:, None].long(), dim=-1)[:, 0]
    return torch.logsumexp(logits, dim=-1) - ll


def head_cross_entropy_sum(x: torch.Tensor, table: torch.Tensor, targets: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """``cross_entropy_sum(logits_out(x, table), targets, mask)`` for
    training: the f32 head and the loss in blocks of ``CE_ROWS`` rows, each
    block recomputed in the backward (``torch.utils.checkpoint``), so
    neither the [B, S, V] f32 logits nor their gradient (6.6 GB each at 16k
    tokens over a 100k vocabulary) is ever whole. The same rows' values,
    summed in the same row order. The f32 copy of the table is made once
    and its gradient accumulates over the blocks."""
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    tg = targets.reshape(-1)
    table_f = table.float()
    nll = torch.cat([checkpoint(_block_nll, xf[i:i + CE_ROWS], table_f, tg[i:i + CE_ROWS],
                                use_reentrant=False)
                     for i in range(0, xf.shape[0], CE_ROWS)]).reshape(targets.shape)
    return _masked_sum(nll, mask)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL of ``logits`` [..., V] against ``targets`` [...] (masked
    mean with ``mask``)."""
    return mean_of_sum(cross_entropy_sum(logits, targets, mask))


def mean_of_sum(sc: torch.Tensor) -> torch.Tensor:
    """[sum, count] -> the mean (0 over no tokens)."""
    return sc[0] / torch.clamp_min(sc[1], 1.0)
