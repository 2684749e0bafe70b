"""Multi-head Latent Attention, DeepSeek-V2/V3 (port of
``src/repro/models/mla.py``).

Without a cache (training, prefill): queries through the low-rank q path;
keys and values decompressed from the shared latent ``c_kv`` plus one shared
RoPE key head. At ``S >= CHUNKED_ATTN_THRESHOLD`` the keys and values are
decompressed one KV chunk at a time under an online softmax
(``_mla_chunked``), so only the compressed latents stay resident; under
autograd through ``MlaChunked``, whose backward recomputes each chunk.

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


def _mla_loop(q_nope, q_rope, ckv, k_rope, wk_b, wv_b, scale, out_dtype, chunk):
    """The chunk loop of ``_mla_chunked`` -> (out [B, H, Sq, dv] f32
    normalised, the row max m and the row sum l [B, H, Sq] f32)."""
    B, Sq, H, _ = q_nope.shape
    S = ckv.shape[1]
    pad = (-S) % chunk
    if pad:
        ckv = F.pad(ckv, (0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
    dev = q_nope.device
    q_pos = torch.arange(Sq, device=dev)
    dv = wv_b.shape[-1]
    m = torch.full((B, H, Sq), -1e30, device=dev)
    l = torch.zeros((B, H, Sq), device=dev)
    acc = torch.zeros((B, H, Sq, dv), device=dev)
    for ci in range((S + pad) // chunk):
        ck = ckv[:, ci * chunk:(ci + 1) * chunk]
        kr = k_rope[:, ci * chunk:(ci + 1) * chunk]
        k_nope = torch.einsum("bsr,rhk->bshk", ck, wk_b)
        v = torch.einsum("bsr,rhk->bshk", ck, wv_b)
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
        # the scores go before the next chunk's are made (the arithmetic
        # is the same; without grad a chunk's tiles are 2 GiB each at
        # DeepSeek-V3's 128 heads and Sq 4096)
        del s, pb
    return acc / torch.clamp_min(l, 1e-30)[..., None], m, l


def _mla_chunked(p, q_nope, q_rope, ckv, k_rope, scale, out_dtype, chunk=1024):
    """Causal online-softmax MLA attention, K/V decompressed one chunk of
    ``chunk`` (``AttnSpec.kv_chunk``) at a time. A ragged tail (S % chunk)
    is zero-padded and masked out exactly; probabilities are cast to
    ``out_dtype`` before the P·V product. Returns [B, Sq, H, dv] f32.

    The plain loop: under autograd it keeps every chunk's scores and
    probabilities (about 6 GiB a chunk a row at DeepSeek-V3's widths).
    ``mla_attention`` runs it through ``MlaChunked``, whose forward is this
    loop and whose backward recomputes; the tests hold the two together."""
    out, _, _ = _mla_loop(q_nope, q_rope, ckv, k_rope, p["wk_b"], p["wv_b"], scale,
                          out_dtype, chunk)
    return out.permute(0, 2, 1, 3)


# calls of MlaChunked's forward and of its backward (chip_smoke.py reads
# them to show the training path went through the Function)
mla_chunked_calls = 0
mla_chunked_bwd_calls = 0


class MlaChunked(torch.autograd.Function):
    """``_mla_chunked`` with a recomputing backward, as FlashAttention-2's.

    The forward is the plain loop, bitwise, and saves only its inputs, the
    normalised f32 output and the row log-sum-exp ``m + log l``. The
    backward walks the KV chunks and, inside each, blocks of ``chunk``
    queries (a block wholly before the chunk is skipped: the causal mask
    leaves it nothing), recomputing the chunk's keys and values from its
    latents: P = exp(S - lse) under the forward's mask, dV = Pᵀ dO with P
    cast to ``out_dtype`` as the forward casts it into P·V, dS = P ∘ (dO Vᵀ
    - rowsum(dO ∘ O)) · scale; the queries', the rope keys', the latents'
    and ``wk_b`` / ``wv_b``'s gradients summed in f32 and returned in each
    input's dtype. Its transient memory is a few [B, H, chunk, chunk] f32
    tiles."""

    @staticmethod
    def forward(ctx, q_nope, q_rope, ckv, k_rope, wk_b, wv_b, scale, out_dtype, chunk):
        global mla_chunked_calls
        mla_chunked_calls += 1
        out, m, l = _mla_loop(q_nope, q_rope, ckv, k_rope, wk_b, wv_b, scale, out_dtype,
                              chunk)
        if any(ctx.needs_input_grad[:6]):
            ctx.save_for_backward(q_nope, q_rope, ckv, k_rope, wk_b, wv_b, out,
                                  m + torch.log(l))
            ctx.opts = (scale, out_dtype, chunk)
        return out.permute(0, 2, 1, 3)

    @staticmethod
    def backward(ctx, d_out):
        global mla_chunked_bwd_calls
        mla_chunked_bwd_calls += 1
        q_nope, q_rope, ckv, k_rope, wk_b, wv_b, out, lse = ctx.saved_tensors
        scale, out_dtype, chunk = ctx.opts
        Sq, S = q_nope.shape[1], ckv.shape[1]
        dev = q_nope.device
        do = d_out.float().permute(0, 2, 1, 3)                  # [B, H, Sq, dv]
        delta = (do * out).sum(-1)                              # [B, H, Sq]
        dqn = torch.zeros(q_nope.shape, device=dev)
        dqr = torch.zeros(q_rope.shape, device=dev)
        dckv = torch.zeros(ckv.shape, device=dev)
        dkr = torch.zeros(k_rope.shape, device=dev)
        dwk = torch.zeros(wk_b.shape, device=dev)
        dwv = torch.zeros(wv_b.shape, device=dev)
        for k0 in range(0, S, chunk):
            k1 = min(S, k0 + chunk)
            ck, kr = ckv[:, k0:k1], k_rope[:, k0:k1]
            k_nope = torch.einsum("bsr,rhk->bshk", ck, wk_b)
            v = torch.einsum("bsr,rhk->bshk", ck, wv_b)
            dkn = torch.zeros(k_nope.shape, device=dev)
            dvv = torch.zeros(v.shape, device=dev)
            k_pos = torch.arange(k0, k1, device=dev)
            for q0 in range(k0, Sq, chunk):
                q1 = min(Sq, q0 + chunk)
                qn, qr = q_nope[:, q0:q1], q_rope[:, q0:q1]
                s = (_dot32("bqhk,bshk->bhqs", qn, k_nope)
                     + _dot32("bqhk,bsk->bhqs", qr, kr)) * scale
                msk = k_pos[None, :] <= torch.arange(q0, q1, device=dev)[:, None]
                p = torch.where(msk[None, None], torch.exp(s - lse[:, :, q0:q1, None]), 0.0)
                del s
                dob = do[:, :, q0:q1]
                dvv += _dot32("bhqs,bhqk->bshk", p.to(out_dtype), dob)
                ds = p * (_dot32("bhqk,bshk->bhqs", dob, v) - delta[:, :, q0:q1, None]) * scale
                del p
                dqn[:, q0:q1] += _dot32("bhqs,bshk->bqhk", ds, k_nope)
                dqr[:, q0:q1] += _dot32("bhqs,bsk->bqhk", ds, kr)
                dkn += _dot32("bhqs,bqhk->bshk", ds, qn)
                dkr[:, k0:k1] += _dot32("bhqs,bqhk->bsk", ds, qr)
                del ds
            dckv[:, k0:k1] = (_dot32("bshk,rhk->bsr", dkn, wk_b)
                              + _dot32("bshk,rhk->bsr", dvv, wv_b))
            dwk += _dot32("bsr,bshk->rhk", ck, dkn)
            dwv += _dot32("bsr,bshk->rhk", ck, dvv)
        return (dqn.to(q_nope.dtype), dqr.to(q_rope.dtype), dckv.to(ckv.dtype),
                dkr.to(k_rope.dtype), dwk.to(wk_b.dtype), dwv.to(wv_b.dtype),
                None, None, None)


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
            # the same as in one call over the batch. Under autograd the
            # Function keeps a row's inputs, output and log-sum-exp, and its
            # backward recomputes the chunks
            o = torch.cat([MlaChunked.apply(q_nope[b:b + 1], q_rope[b:b + 1], ckv[b:b + 1],
                                            k_rope[b:b + 1], p["wk_b"], p["wv_b"], scale,
                                            x.dtype, cfg.attn.kv_chunk) for b in range(B)])
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
