"""GQA attention with RoPE (port of ``src/repro/models/attention.py``): the
forward without a cache (prefill and training), the decode-with-cache
branch and ``paged_attention``.

Without a cache, causal attention at ``S >= CHUNKED_ATTN_THRESHOLD`` with
no softcap and ``S % 128 == 0`` goes through
``kernels.ops.flash_attention_bshd`` on every device (the JAX package takes
that route only on the TPU), through the Function of
``kernels/autograd.py``, whose backward is the kernel pair; softcap or a
ragged S takes ``_sdpa_chunked``, shorter or non-causal sequences ``_sdpa``. There was no kernel for the dense
cache on the TPU either: decode attention over it is plain ``_sdpa``. The
cache is updated in place (the JAX step returns a new cache instead); the
filled length is a 0-dim int32 tensor on the cache's device, as in JAX, so
no host value decides where a step writes and the step can be captured as a
CUDA graph. The paged path writes its pool in place too and attends through
``kernels.ops.paged_decode_attention``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import autograd as KA
from repro_torch.kernels import ops as K
from repro_torch.models.config import ArchConfig, AttnSpec, ParamSpec
from repro_torch.models.kv_pages import write_token
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
    length: torch.Tensor  # [] int32 filled prefix, on the cache's device


def kv_cache_shape(cfg: ArchConfig, batch: int, max_len: int):
    return (batch, max_len, cfg.attn.n_kv, cfg.attn.head_dim)


def _scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window):
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


# Sequence length at and above which attention without a cache walks KV
# chunks with an online softmax instead of building the [Sq, Sk] scores.
CHUNKED_ATTN_THRESHOLD = 2048


def _sdpa_chunked(q, k, v, softcap, scale, window, chunk=1024):
    """Causal grouped attention with an online softmax over KV chunks of
    ``chunk`` (``AttnSpec.kv_chunk``). q: [B, Sq, Hq, hd], k/v: [B, Sk, Hkv,
    hd]. A ragged tail (Sk % chunk) is zero-padded and masked out exactly;
    probabilities are cast to q's dtype before the PV product, as in JAX."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    pad = (-Sk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, G, Sq), -1e30, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, hd), device=q.device)
    for ci in range((Sk + pad) // chunk):
        k_c = k[:, ci * chunk:(ci + 1) * chunk]
        v_c = v[:, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_c.float()) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        k_pos = ci * chunk + torch.arange(chunk, device=q.device)
        msk = (k_pos[None, :] <= q_pos[:, None]) & (k_pos < Sk)[None, :]
        if window is not None:
            msk &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(msk[None, None, None], s, -1e30)
        m2 = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m2[..., None])
        corr = torch.exp(m - m2)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(q.dtype).float(), v_c.float())
        m = m2
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


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


def attention(p, x: torch.Tensor, cfg: ArchConfig, *, positions=None,
              cache: KVCache | None = None, window="cfg",
              attn: AttnSpec | None = None, kv_override=None, causal: bool = True):
    """Without a cache: attention over x itself (prefill, training). With
    one: append this step's K/V to the cache (in place) and attend over the
    filled prefix. Returns (out [B, S, D], new_cache)."""
    a = attn or cfg.attn
    if window == "cfg":
        window = a.window
    if kv_override is not None:
        raise NotImplementedError("cross-attention (kv_override, encdec) is not "
                                  "ported yet (ROADMAP A12)")
    B, S, _ = x.shape
    if cache is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
        q, k, v = _project_qkv(p, x, a, cfg, positions)
        scale = a.head_dim ** -0.5
        if causal and S >= CHUNKED_ATTN_THRESHOLD:
            if a.logit_softcap is None and S % 128 == 0:
                out = KA.flash_attention_bshd(q, k, v, scale=scale, window=window)
            else:
                out = _sdpa_chunked(q, k, v, a.logit_softcap, scale, window,
                                    chunk=a.kv_chunk)
        else:
            q_pos = torch.arange(S, device=x.device)
            mask = (_scores_mask(q_pos, q_pos, window) if causal
                    else torch.ones((S, S), dtype=torch.bool, device=x.device))
            out = _sdpa(q, k, v, mask, a.logit_softcap, scale)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), None
    start = cache.length
    steps = torch.arange(S, device=x.device)
    if positions is None:
        positions = (steps + start)[None].expand(B, S)
    q, k, v = _project_qkv(p, x, a, cfg, positions)
    # rows start.. of the cache, the start clamped so that S rows fit (JAX's
    # dynamic_update_slice); the length itself advances unclamped
    rows = start.clamp(0, cache.k.shape[1] - S).long() + steps
    cache.k.index_copy_(1, rows, k.to(cache.k.dtype))
    cache.v.index_copy_(1, rows, v.to(cache.v.dtype))
    new_len = start + S
    k_pos = torch.arange(cache.k.shape[1], device=x.device)
    mask = _scores_mask(positions[0], k_pos, window) & (k_pos < new_len)[None, :]
    out = _sdpa(q, cache.k, cache.v, mask, a.logit_softcap, a.head_dim ** -0.5)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, KVCache(k=cache.k, v=cache.v, length=new_len)


def _project_qkv(p, x, a: AttnSpec, cfg: ArchConfig, positions):
    """q, k, v [B, S, H, hd] of x, normed and rotated at ``positions``."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if a.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if a.rope_fraction > 0:
        q = apply_rope(q, positions, a.rope_base, a.rope_fraction)
        k = apply_rope(k, positions, a.rope_base, a.rope_fraction)
    return q, k, v


def paged_attention(p, x: torch.Tensor, cfg: ArchConfig, pool, page_tbl,
                    kv_lens, active, *, num_kv_splits: int = 1,
                    attn: AttnSpec | None = None):
    """One-token decode attention against the paged KV pool.

    x: [B, 1, D]; pool: {"k", "v"} [P+1, page, n_kv, hd]
    (``models/kv_pages``); page_tbl: [B, max_pages] int32 (pad entries =
    P); kv_lens: [B] int32 tokens already held; active: [B] int32 0/1.
    Writes this token's K/V at (tbl[b, len // page], len % page) in place,
    then attends over len + active positions through the split-KV paged
    decode kernel (idle rows attend over nothing and get exact zeros).
    Returns (y [B, 1, D], pool)."""
    a = attn or cfg.attn
    if a.window is not None:
        raise NotImplementedError("paged decode attention does not support "
                                  "sliding-window layers")
    if a.logit_softcap is not None:
        raise NotImplementedError("paged decode attention does not support "
                                  "logit softcap")
    q, k, v = _project_qkv(p, x, a, cfg, kv_lens[:, None])
    write_token(pool["k"], k[:, 0], page_tbl, kv_lens)
    write_token(pool["v"], v[:, 0], page_tbl, kv_lens)
    eff = kv_lens + active            # the token just written counts iff active
    out = K.paged_decode_attention(q[:, 0].contiguous(), pool["k"], pool["v"],
                                   page_tbl, eff, scale=a.head_dim ** -0.5,
                                   num_kv_splits=num_kv_splits)
    out = out.to(x.dtype)[:, None]                         # [B, 1, Hq, hd]
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, pool
