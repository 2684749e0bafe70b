"""Shared primitive layers (port of ``src/repro/models/layers.py``): norms,
RoPE, gated FFNs, embeddings."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ParamSpec


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    x2 = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(x2 + eps)).to(x.dtype) * w


def rmsnorm_spec(d: int, dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec((d,), dtype, init="ones")


def rope_frequencies(rot_dim: int, base: float) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]. Rotates the first
    ``fraction * D`` components (interleaved pairs)."""
    B, S, H, D = x.shape
    rot = int(D * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = torch.tensor(rope_frequencies(rot, base), dtype=torch.float32,
                       device=x.device)
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
