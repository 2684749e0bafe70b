"""Multi-head Latent Attention, DeepSeek-V2/V3 (port of
``src/repro/models/mla.py``).

Without a cache (training, prefill): queries through the low-rank q path;
keys and values decompressed from the shared latent ``c_kv`` plus one shared
RoPE key head. At ``S >= CHUNKED_ATTN_THRESHOLD`` the keys and values are
decompressed one KV chunk at a time under an online softmax
(``_mla_chunked``), so only the compressed latents stay resident.

Decode is the *absorbed* form: the cache holds only [c_kv (r_kv) | k_rope]
per token, W_uk is absorbed into the query and W_uv into the output
projection, and scores are taken against the compressed cache directly. The
dense cache is written in place at its device-side ``length`` (a 0-dim int32
tensor, as ``KVCache``), so the step can be captured as a CUDA graph; the
paged form (``paged_mla_attention``) writes the one shared pool of
``models/kv_pages.paged_mla_pool_spec`` and attends through
``kernels.ops.paged_decode_attention`` in its shared-pool mode.

One departure from the reference: its short-sequence branch masks with the
transpose of the causal mask (``src/repro/models/mla.py:195-197``), so each
query attends to the keys at and *after* its position. Here that branch is
causal, the function of the reference's own chunked branch
(``tests/test_torch_mla.py`` pins the reference's mask).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as K
from repro_torch.models.attention import CHUNKED_ATTN_THRESHOLD
from repro_torch.models.config import ArchConfig, ParamSpec
from repro_torch.models.kv_pages import write_token
from repro_torch.models.layers import apply_rope, rmsnorm


def mla_spec(cfg: ArchConfig, dtype=None):
    m, d = cfg.mla, cfg.d_model
    dtype = dtype or cfg.dtype
    h = cfg.padded_heads()
    qk = m.qk_nope_dim + m.qk_rope_dim
    return dict(
        wq_a=ParamSpec((d, m.q_lora_rank), dtype),
        q_norm=ParamSpec((m.q_lora_rank,), dtype, init="ones"),
        wq_b=ParamSpec((m.q_lora_rank, h, qk), dtype),
        wkv_a=ParamSpec((d, m.kv_lora_rank + m.qk_rope_dim), dtype),
        kv_norm=ParamSpec((m.kv_lora_rank,), dtype, init="ones"),
        wk_b=ParamSpec((m.kv_lora_rank, h, m.qk_nope_dim), dtype),
        wv_b=ParamSpec((m.kv_lora_rank, h, m.v_head_dim), dtype),
        wo=ParamSpec((h, m.v_head_dim, d), dtype),
    )


@dataclasses.dataclass
class MLACache:
    ckv: torch.Tensor     # [B, S_max, r_kv] compressed latents (or stacked [n, ...])
    krope: torch.Tensor   # [B, S_max, rope_dim] shared rope key
    length: torch.Tensor  # [] int32 filled prefix, on the cache's device


def mla_cache_spec(cfg: ArchConfig, batch: int, max_len: int):
    """{"ckv", "krope"}: the zeroed arrays of one layer's dense cache."""
    m = cfg.mla
    return dict(ckv=ParamSpec((batch, max_len, m.kv_lora_rank), cfg.dtype, init="zeros"),
                krope=ParamSpec((batch, max_len, m.qk_rope_dim), cfg.dtype, init="zeros"))


def _dot32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """An einsum accumulated and returned in f32: the operands are upcast,
    which is exact, as the reference does on the CPU."""
    return torch.einsum(eq, *(o.float() for o in ops))


def _q_proj(p, x, cfg: ArchConfig, positions):
    m = cfg.mla
    q = rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q, p["wq_b"])          # [B, S, H, nope+rope]
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.attn.rope_base, 1.0)


def _latents(p, x, cfg: ArchConfig, positions):
    """(ckv [B, S, r_kv], k_rope [B, S, rope]) of x at ``positions``."""
    m = cfg.mla
    kv = x @ p["wkv_a"]                                        # [B, S, r_kv+rope]
    ckv = rmsnorm(kv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                        cfg.attn.rope_base, 1.0)[:, :, 0]
    return ckv, k_rope


def _mla_chunked(p, q_nope, q_rope, ckv, k_rope, scale, out_dtype, chunk=1024):
    """Causal online-softmax MLA attention, K/V decompressed one chunk of
    ``chunk`` (``AttnSpec.kv_chunk``) at a time. A ragged tail (S % chunk)
    is zero-padded and masked out exactly; probabilities are cast to
    ``out_dtype`` before the P·V product. Returns [B, Sq, H, dv] f32."""
    B, Sq, H, _ = q_nope.shape
    S = ckv.shape[1]
    pad = (-S) % chunk
    if pad:
        ckv = F.pad(ckv, (0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
    dev = q_nope.device
    q_pos = torch.arange(Sq, device=dev)
    dv = p["wv_b"].shape[-1]
    m = torch.full((B, H, Sq), -1e30, device=dev)
    l = torch.zeros((B, H, Sq), device=dev)
    acc = torch.zeros((B, H, Sq, dv), device=dev)
    for ci in range((S + pad) // chunk):
        ck = ckv[:, ci * chunk:(ci + 1) * chunk]
        kr = k_rope[:, ci * chunk:(ci + 1) * chunk]
        k_nope = torch.einsum("bsr,rhk->bshk", ck, p["wk_b"])
        v = torch.einsum("bsr,rhk->bshk", ck, p["wv_b"])
        s = (_dot32("bqhk,bshk->bhqs", q_nope, k_nope)
             + _dot32("bqhk,bsk->bhqs", q_rope, kr)) * scale
        k_pos = ci * chunk + torch.arange(chunk, device=dev)
        msk = (k_pos[None, :] <= q_pos[:, None]) & (k_pos < S)[None, :]
        s = torch.where(msk[None, None], s, -1e30)
        m2 = torch.maximum(m, s.amax(-1))
        pb = torch.exp(s - m2[..., None])
        corr = torch.exp(m - m2)
        l = l * corr + pb.sum(-1)
        acc = acc * corr[..., None] + _dot32("bhqs,bshk->bhqk", pb.to(out_dtype), v)
        m = m2
    out = acc / torch.clamp_min(l, 1e-30)[..., None]            # [B, H, Sq, dv]
    return out.permute(0, 2, 1, 3)


def mla_attention(p, x: torch.Tensor, cfg: ArchConfig, *, positions=None,
                  cache: MLACache | None = None):
    """Without a cache: causal attention over x itself (prefill, training).
    With one: append this step's latents to the cache in place and attend
    over the filled prefix in the absorbed form. Returns (y [B, S, D],
    new_cache or None)."""
    m = cfg.mla
    B, S, _ = x.shape
    steps = torch.arange(S, device=x.device)
    if positions is None:
        positions = steps[None].expand(B, S)
        if cache is not None:
            positions = positions + cache.length
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    ckv, k_rope = _latents(p, x, cfg, positions)
    q_nope, q_rope = _q_proj(p, x, cfg, positions)

    if cache is None:
        if S >= CHUNKED_ATTN_THRESHOLD:
            # one batch row at a time: a chunk step's f32 scores are [rows,
            # H, Sq, chunk], 2 GiB a row at 128 heads, Sq 4096 and chunk 1024,
            # and the sum, mask and exp copy them. Every row's arithmetic is
            # the same as in one call over the batch
            o = torch.cat([_mla_chunked(p, q_nope[b:b + 1], q_rope[b:b + 1], ckv[b:b + 1],
                                        k_rope[b:b + 1], scale, x.dtype,
                                        chunk=cfg.attn.kv_chunk) for b in range(B)])
        else:
            k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wk_b"])
            v = torch.einsum("bsr,rhk->bshk", ckv, p["wv_b"])
            s = (_dot32("bqhk,bshk->bhqs", q_nope, k_nope)
                 + _dot32("bqhk,bsk->bhqs", q_rope, k_rope)) * scale
            causal = steps[None, :] <= steps[:, None]            # [q, k]: k <= q
            s = torch.where(causal[None, None], s, -1e30)
            prob = s.softmax(-1).to(x.dtype)
            o = _dot32("bhqs,bshk->bqhk", prob, v)
        new_cache = None
    else:
        # rows start.. of the cache, the start clamped so that S rows fit
        # (JAX's dynamic_update_slice); the length advances unclamped
        rows = cache.length.clamp(0, cache.ckv.shape[1] - S).long() + steps
        cache.ckv.index_copy_(1, rows, ckv.to(cache.ckv.dtype))
        cache.krope.index_copy_(1, rows, k_rope.to(cache.krope.dtype))
        new_len = cache.length + S
        q_abs = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wk_b"])  # absorb W_uk
        s = (_dot32("bqhr,bsr->bhqs", q_abs, cache.ckv)
             + _dot32("bqhk,bsk->bhqs", q_rope, cache.krope)) * scale
        k_pos = torch.arange(cache.ckv.shape[1], device=x.device)
        # the reference masks every row with batch row 0's positions
        mask = (k_pos[None] <= positions[0][:, None]) & (k_pos < new_len)[None]
        s = torch.where(mask[None, None], s, -1e30)
        prob = s.softmax(-1).to(x.dtype)
        ctx = _dot32("bhqs,bsr->bqhr", prob, cache.ckv)
        o = torch.einsum("bqhr,rhk->bqhk", ctx.to(x.dtype), p["wv_b"])  # absorb W_uv
        new_cache = MLACache(ckv=cache.ckv, krope=cache.krope, length=new_len)

    y = torch.einsum("bqhk,hkd->bqd", o.to(x.dtype), p["wo"])
    return y, new_cache


def paged_mla_attention(p, x: torch.Tensor, cfg: ArchConfig, pool, page_tbl,
                        kv_lens, active, *, num_kv_splits: int = 1):
    """One-token absorbed-MLA decode against the paged latent pool.

    pool: {"kv"} [P+1, page, 1, r_kv+rope] holding [ckv | k_rope] rows, one
    shared pool: the query is [q_absorbed | q_rope] against the whole row
    and the values are its leading r_kv columns, so each page is read once
    (the shared-pool mode of ``kernels.ops.paged_decode_attention``). The
    row is written in place. Returns (y [B, 1, D], pool)."""
    m = cfg.mla
    positions = kv_lens[:, None]                                # [B, 1]
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    ckv, k_rope = _latents(p, x, cfg, positions)
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    write_token(pool["kv"], torch.cat([ckv, k_rope], dim=-1), page_tbl, kv_lens)
    q_abs = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wk_b"])   # absorb W_uk
    qcat = torch.cat([q_abs, q_rope], dim=-1)[:, 0]             # [B, H, r+rope]
    ctx = K.paged_decode_attention(qcat.contiguous(), pool["kv"], None, page_tbl,
                                   kv_lens + active, scale=scale,
                                   num_kv_splits=num_kv_splits,
                                   dv=m.kv_lora_rank)           # [B, H, r] f32
    o = torch.einsum("bhr,rhk->bhk", ctx.to(x.dtype), p["wv_b"])  # absorb W_uv
    y = torch.einsum("bqhk,hkd->bqd", o[:, None], p["wo"])
    return y, pool
