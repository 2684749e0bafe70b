"""GQA attention with RoPE and a dense KV cache: the decode-with-cache
branch of ``src/repro/models/attention.py`` (port).

There was no kernel here on the TPU either: decode attention over a dense
cache is plain ``_sdpa``. The cache is updated in place (the JAX step
returns a new cache instead); the filled length is a host int.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig, AttnSpec, ParamSpec
from repro_torch.models.layers import apply_rope, rmsnorm


def attn_spec(cfg: ArchConfig, dtype=None):
    a = cfg.attn
    dtype = dtype or cfg.dtype
    d, hq, hkv, hd = cfg.d_model, cfg.padded_heads(), a.n_kv, a.head_dim
    sp = dict(
        wq=ParamSpec((d, hq, hd), dtype),
        wk=ParamSpec((d, hkv, hd), dtype),
        wv=ParamSpec((d, hkv, hd), dtype),
        wo=ParamSpec((hq, hd, d), dtype),
    )
    if a.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), dtype, init="ones")
        sp["k_norm"] = ParamSpec((hd,), dtype, init="ones")
    return sp


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor     # [B, S_max, n_kv, hd] (or stacked [n, B, S_max, ...])
    v: torch.Tensor
    length: int         # filled prefix


def kv_cache_shape(cfg: ArchConfig, batch: int, max_len: int):
    return (batch, max_len, cfg.attn.n_kv, cfg.attn.head_dim)


def _scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window):
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _sdpa(q, k, v, mask, softcap, scale):
    """q: [B, Sq, Hq, hd], k/v: [B, Sk, Hkv, hd]: grouped attention with f32
    scores and f32 accumulation of the (q.dtype) probabilities times v."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[None, None, None], s, -1e30)
    p = s.softmax(-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.float(), v.float())
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def attention(p, x: torch.Tensor, cfg: ArchConfig, *, cache: KVCache,
              positions=None, window="cfg", attn: AttnSpec | None = None):
    """Decode step: append this step's K/V to the cache (in place) and
    attend over the filled prefix. Returns (out [B, S, D], new_cache)."""
    a = attn or cfg.attn
    if window == "cfg":
        window = a.window
    if cache is None:
        raise NotImplementedError("attention without a KV cache (training and "
                                  "fused prefill) is not ported yet (ROADMAP A8)")
    B, S, _ = x.shape
    if positions is None:
        positions = (torch.arange(S, device=x.device)[None] + cache.length).expand(B, S)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if a.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if a.rope_fraction > 0:
        q = apply_rope(q, positions, a.rope_base, a.rope_fraction)
        k = apply_rope(k, positions, a.rope_base, a.rope_fraction)
    start = cache.length
    cache.k[:, start:start + S] = k.to(cache.k.dtype)
    cache.v[:, start:start + S] = v.to(cache.v.dtype)
    new_len = start + S
    k_pos = torch.arange(cache.k.shape[1], device=x.device)
    mask = _scores_mask(positions[0], k_pos, window) & (k_pos < new_len)[None, :]
    out = _sdpa(q, cache.k, cache.v, mask, a.logit_softcap, a.head_dim ** -0.5)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, KVCache(k=cache.k, v=cache.v, length=new_len)
