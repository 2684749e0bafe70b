"""Plain PyTorch versions of the port's kernels: the semantics of record.

Each hand-written Hopper kernel in this package is held against the function
of the same name here, on the card (``chip_smoke.py``, the CUDA tests), and
these functions are what ``kernels/ops.py`` runs for a tensor on the CPU.
They follow ``src/repro/kernels/ref.py`` line for line, so the CPU tests can
hold each one against the JAX function of the same name.

``positions_by_dest`` is the one-hot-cumsum oracle of the sort-based
``repro_torch.core.slots.positions_by_dest``, as in the JAX package.
"""
from __future__ import annotations

import torch

_FLOAT_OUT = (torch.bfloat16, torch.float32, torch.float16)


def positions_by_dest(dest: torch.Tensor, num_dest: int, valid: torch.Tensor):
    """O(M·D) one-hot oracle: for each entry its slot within its destination
    (exclusive running count of valid entries), plus per-destination totals.
    Out-of-range destinations one-hot to an all-zero row, as in JAX."""
    ar = torch.arange(num_dest, device=dest.device)
    oh = (dest[:, None] == ar[None, :]).to(torch.int32) * valid[:, None].to(torch.int32)
    incl = torch.cumsum(oh, dim=0).to(torch.int32)
    idx = dest.clamp(0, num_dest - 1)[:, None].long()
    pos = torch.take_along_dim(incl - oh, idx, dim=1)[:, 0]
    if dest.shape[0] > 0:
        counts = incl[-1]
    else:
        counts = torch.zeros((num_dest,), dtype=torch.int32, device=dest.device)
    return pos.to(torch.int32), counts.to(torch.int32)


def combine_reduce(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y: [T, K, H], w: [T, K] -> [T, H] = sum_k w·y in f32, cast to y's
    dtype (bf16, f16, f32) or bf16."""
    acc = torch.einsum("tkh,tk->th", y.float(), w.float())
    return acc.to(y.dtype if y.dtype in _FLOAT_OUT else torch.bfloat16)


def combine_gather_reduce(recv: torch.Tensor, rows: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """recv: [R, H]; rows: [T, K] int32 with sentinel R (no contribution);
    w: [T, K] -> [T, H] = sum_k w[t,k]·recv[rows[t,k]]."""
    pad = torch.zeros((1, recv.shape[-1]), dtype=recv.dtype, device=recv.device)
    y = torch.cat([recv, pad], dim=0)[rows.long()]
    return combine_reduce(y, w)


def quantize_fp8(x: torch.Tensor, block: int = 128):
    """Block-wise fp8 e4m3: x [..., H] -> (q [..., H], scales [..., H/block]
    f32) with scale = amax/448, or 1.0 for an all-zero block."""
    H = x.shape[-1]
    if H % block:
        raise ValueError(f"hidden {H} must divide by the quant block {block}")
    g = x.reshape(x.shape[:-1] + (H // block, block)).float()
    amax = g.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on CUDA, torch turns division by a Python scalar into
    # a multiply by its reciprocal, which changes the bits
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 448.0), 1.0)
    q = (g / scale).to(torch.float8_e4m3fn)
    return q.reshape(x.shape), scale[..., 0].float()


def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_fp8. q: [..., H], scales: [..., H/block]."""
    H = q.shape[-1]
    block = H // scales.shape[-1]
    g = q.reshape(q.shape[:-1] + (H // block, block)).float()
    return (g * scales[..., None]).reshape(q.shape).to(out_dtype)


def dispatch_pack(x: torch.Tensor, gmap: torch.Tensor,
                  quant_block: int | None = None, out_dtype=None):
    """x: [T, H]; gmap: [N, C] int32 slot -> token with sentinel T (empty).
    Returns (packed [N, C, H], None), or with ``quant_block`` (fp8 [N, C, H],
    scales [N, C, H/qb]) where empty slots carry scale 1.0."""
    T, H = x.shape
    idx = gmap.long()
    if quant_block is not None:
        xq, sc = quantize_fp8(x, quant_block)
        xp = torch.cat([xq, torch.zeros((1, H), dtype=xq.dtype, device=x.device)])
        sp = torch.cat([sc, torch.ones((1, sc.shape[-1]), dtype=sc.dtype,
                                       device=x.device)])
        return xp[idx], sp[idx]
    xp = torch.cat([x, torch.zeros((1, H), dtype=x.dtype, device=x.device)])
    out = xp[idx]
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out, None


def recv_unpack(recv: torch.Tensor, gmap: torch.Tensor,
                scales: torch.Tensor | None = None, out_dtype=None):
    """recv: [R, H]; gmap: int32 of any shape with sentinel R (empty slot);
    scales: [R, H/block] f32 for an fp8 payload. Returns gmap.shape + (H,),
    dequantized (bf16 by default) when scales are given. Empty slots are
    exactly zero."""
    R, H = recv.shape
    idx = gmap.long()
    pad = torch.zeros((1, H), dtype=recv.dtype, device=recv.device)
    rows = torch.cat([recv, pad])[idx]
    if scales is None:
        return rows if out_dtype is None else rows.to(out_dtype)
    spad = torch.zeros((1, scales.shape[-1]), dtype=scales.dtype,
                       device=scales.device)
    sc = torch.cat([scales, spad])[idx]
    return dequantize_fp8(rows, sc, out_dtype or torch.bfloat16)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """x: [L, A, H] @ w: [L, H, F] -> [L, A, F] in f32, rows >= counts[l]
    zero, cast to x's dtype (bf16 for an fp8 x)."""
    L, A, H = x.shape
    out = torch.einsum("lah,lhf->laf", x.float(), w.float())
    mask = torch.arange(A, device=x.device)[None, :] < counts[:, None]
    out = torch.where(mask[..., None], out, 0.0)
    return out.to(torch.bfloat16 if x.dtype == torch.float8_e4m3fn else x.dtype)


def grouped_gemm_dw(x: torch.Tensor, dy: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``grouped_gemm``: x [L, A, H], dy [L, A, F] ->
    dW [L, H, F] = sum over the live rows a < counts[l] of x[l, a]ᵀ dy[l, a],
    in f32, cast to x's dtype."""
    A = x.shape[1]
    live = (torch.arange(A, device=x.device)[None, :] < counts[:, None])[..., None]
    xm = torch.where(live, x.float(), 0.0)
    return torch.einsum("lah,laf->lhf", xm, dy.float()).to(x.dtype)


def combine_gather_reduce_bwd(recv: torch.Tensor, rows: torch.Tensor,
                              w: torch.Tensor, dout: torch.Tensor):
    """The backward of ``combine_gather_reduce`` for the cotangent dout [T,
    H], where the valid rows name each recv row at most once (the EP maps
    it runs over: ``comb_recv_rows`` in every layout and the hierarchical
    ``h_slot_rows``, in every drop and placement case; see
    ``tests/test_torch_train_layouts.py``): (d_recv [R, H] in recv's dtype, d_w [T, K] f32) with
    d_recv[rows[t, k]] = w[t, k] dout[t] and every other row 0, d_w[t, k] =
    recv[rows[t, k]]·dout[t] in f32 and 0 at the sentinel R."""
    R, H = recv.shape
    valid = rows < R
    idx = torch.where(valid, rows, R).long().reshape(-1)
    contrib = (w.float()[..., None] * dout.float()[:, None, :]).to(recv.dtype)
    d_recv = torch.zeros((R + 1, H), dtype=recv.dtype, device=recv.device)
    d_recv = d_recv.index_copy(0, idx, contrib.reshape(-1, H))[:R]
    pad = torch.zeros((1, H), dtype=recv.dtype, device=recv.device)
    y = torch.cat([recv, pad])[idx].reshape(rows.shape + (H,))
    d_w = torch.einsum("tkh,th->tk", y.float(), dout.float())
    return d_recv, torch.where(valid, d_w, 0.0)


NEG_INF = -1e30


def paged_decode_stage1(q, k_pages, v_pages, kv_indices, kv_lens, *,
                        scale, num_kv_splits, dv=None):
    """Stage 1 of split-KV paged decode attention: per-(request, split)
    partial outputs and log-sum-exp.

    q: [B, Hq, dk] one decode query per request. k_pages: [P+1, page, Hkv,
    dk] paged key pool whose last row is the pad page. v_pages: same layout
    with trailing dv, or None for the absorbed-MLA shared pool, where values
    are the first ``dv`` key columns (Hkv == 1). kv_indices: [B, max_pages]
    int32 page table padded with P. kv_lens: [B] int32 live tokens (0 for an
    idle slot). max_pages must divide by num_kv_splits.

    Returns (o [B, S, Hq, dv] f32, lse [B, S, Hq] f32). An empty split gives
    o == 0 and lse == NEG_INF exactly; masked positions contribute an exact
    0 (``where``, not exp underflow), so garbage in unreferenced pages never
    reaches a live request."""
    B, max_pages = kv_indices.shape
    page, Hkv, dk = k_pages.shape[1:]
    Hq = q.shape[1]
    G = Hq // Hkv
    S = num_kv_splits
    if max_pages % S:
        raise ValueError(f"max_pages {max_pages} must divide by the split "
                         f"count {S}")
    if v_pages is None:
        if dv is None or Hkv != 1:
            raise ValueError("the shared pool needs dv and Hkv == 1")
        v_pages = k_pages[..., :dv]
    dv = v_pages.shape[-1]
    idx = kv_indices.long()
    k = k_pages[idx].reshape(B, max_pages * page, Hkv, dk)
    v = v_pages[idx].reshape(B, max_pages * page, Hkv, dv)
    qg = q.reshape(B, Hkv, G, dk).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    pos = torch.arange(max_pages * page, device=q.device)
    valid = pos[None, :] < kv_lens[:, None]                 # [B, Stot]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    sc = s.reshape(B, Hkv, G, S, -1)                        # split the KV axis
    vc = v.reshape(B, S, -1, Hkv, dv).float()
    mc = valid.reshape(B, 1, 1, S, -1)
    m = sc.amax(-1)                                         # [B, Hkv, G, S]
    p = torch.where(mc, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgsk,bskhv->bhgsv", p, vc)
    live = l > 0
    safe = torch.where(live, l, 1.0)
    o = torch.where(live[..., None], acc / safe[..., None], 0.0)
    lse = torch.where(live, m + torch.log(safe), NEG_INF)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, dv)
    lse = lse.permute(0, 3, 1, 2).reshape(B, S, Hq)
    return o, lse


def paged_decode_stage2(o_parts: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Stage 2: LSE-weighted reduction across the splits. o_parts [B, S, Hq,
    dv] f32, lse [B, S, Hq] f32 -> [B, Hq, dv] f32. An empty split has
    exactly zero weight; a request with no live split returns exactly 0."""
    mx = lse.amax(dim=1)                                    # [B, Hq]
    live = lse > NEG_INF / 2
    w = torch.where(live, torch.exp(lse - mx[:, None]), 0.0)
    denom = w.sum(dim=1)
    out = torch.einsum("bsh,bshv->bhv", w, o_parts)
    safe = torch.where(denom > 0, denom, 1.0)
    return torch.where((denom > 0)[..., None], out / safe[..., None], 0.0)


def paged_decode_attention(q, k_pages, v_pages, kv_indices, kv_lens, *,
                           scale, num_kv_splits=1, dv=None) -> torch.Tensor:
    """Two-stage split-KV paged decode attention (the semantics of record
    for ``csrc/paged_decode_attention.cu``). Returns [B, Hq, dv] f32."""
    o, lse = paged_decode_stage1(q, k_pages, v_pages, kv_indices, kv_lens,
                                 scale=scale, num_kv_splits=num_kv_splits,
                                 dv=dv)
    return paged_decode_stage2(o, lse)


FLASH_BK = 128    # KV tile of the plain flash_attention, the Pallas kernel's bk


def _put_rows(t: torch.Tensor, lo: int, hi: int, rows: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with its rows [lo, hi) along ``dim`` replaced by ``rows``, as a
    new tensor: autograd can differentiate it, where a slice assignment
    would modify a tensor it saved."""
    n = t.shape[dim]
    parts = [t.narrow(dim, 0, lo), rows, t.narrow(dim, hi, n - hi)]
    return torch.cat([p for p in parts if p.shape[dim]], dim=dim)


def _flash(q, k, v, scale, window, causal):
    """The online softmax of ``flash_attention`` -> (out [B, Hkv, G, Sq, d]
    f32, m, l [B, Hkv, G, Sq] f32)."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, d).float()
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, d), device=q.device)
    for k0 in range(0, Sk, FLASH_BK):
        k1 = min(k0 + FLASH_BK, Sk)
        lo = min(k0, Sq) if causal else 0
        hi = Sq if window is None else max(lo, min(Sq, k1 - 1 + window))
        if lo == hi:
            continue
        rows = slice(lo, hi)
        kt, vt = k[:, :, k0:k1].float(), v[:, :, k0:k1].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, rows], kt) * scale
        k_pos = torch.arange(k0, k1, device=q.device)
        qp = q_pos[rows, None]
        mask = torch.ones((hi - lo, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= qp
        if window is not None:
            mask &= (qp - k_pos[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
        m_prev = m[..., rows]
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l = _put_rows(l, lo, hi, l[..., rows] * corr + p.sum(-1), -1)
        acc = _put_rows(acc, lo, hi, acc[..., rows, :] * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, vt), -2)
        m = _put_rows(m, lo, hi, m_new, -1)
    return acc / torch.clamp_min(l, 1e-30)[..., None], m, l


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, window: int | None = None,
                    causal: bool = True) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention: q [B, Hq, Sq, d],
    k/v [B, Hkv, Sk, d] -> [B, Hq, Sq, d] in q's dtype; query head h reads
    kv head h // G. Positions start at 0 on both sides.

    The Pallas kernel's online softmax in f32 over KV tiles of ``FLASH_BK``:
    masked scores are the finite NEG_INF, and the output divides by
    max(l, 1e-30). Each tile updates only the query rows it can reach (a
    fully masked tile leaves a row's m, l and acc exactly as they were once
    the row has seen a live key, and a row that has not is wiped by the
    first live one), so memory stays at [B, Hq, Sq, FLASH_BK]. The updates
    build new tensors, so autograd can differentiate the function."""
    out, _, _ = _flash(q, k, v, scale, window, causal)
    B, Hq, Sq, d = q.shape
    return out.reshape(B, Hq, Sq, d).to(q.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, window: int | None = None,
                        causal: bool = True):
    """``flash_attention`` and each row's natural log-sum-exp of its scaled,
    masked scores, m + log(max(l, 1e-30)): (out [B, Hq, Sq, d], lse [B, Hq,
    Sq] f32), what the training forward saves for the backward."""
    out, m, l = _flash(q, k, v, scale, window, causal)
    B, Hq, Sq, d = q.shape
    lse = (m + torch.log(torch.clamp_min(l, 1e-30))).reshape(B, Hq, Sq)
    return out.reshape(B, Hq, Sq, d).to(q.dtype), lse


def flash_attention_bwd(q, k, v, o, do, lse, *, scale: float,
                        window: int | None = None, causal: bool = True):
    """The backward of ``flash_attention`` from its output ``o`` and row
    log-sum-exp ``lse`` (``flash_attention_fwd``), for the cotangent ``do``:
    (dq, dk, dv) in the inputs' dtypes, [B, H, S, d] as the inputs. In f32,
    one KV tile of ``FLASH_BK`` keys at a time: p = exp(scale q·k - lse) on
    the live pairs, dv = pᵀ do, ds = p (do·v - rowsum(do * o)), dk = scale
    dsᵀ q summed over the G query heads of each kv head, dq = scale ds k."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, d).float()
    dog = do.reshape(B, Hkv, G, Sq, d).float()
    delta = (dog * o.reshape(B, Hkv, G, Sq, d).float()).sum(-1)
    lg = lse.reshape(B, Hkv, G, Sq).float()
    q_pos = torch.arange(Sq, device=q.device)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for k0 in range(0, Sk, FLASH_BK):
        k1 = min(k0 + FLASH_BK, Sk)
        kt, vt = k[:, :, k0:k1].float(), v[:, :, k0:k1].float()
        k_pos = torch.arange(k0, k1, device=q.device)
        mask = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt) * scale
        p = torch.where(mask, torch.exp(s - lg[..., None]), 0.0)
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, dog))
        ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dog, vt) - delta[..., None])
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale)
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kt) * scale
    dk = torch.cat(dks, dim=2) if dks else torch.zeros_like(k, dtype=torch.float32)
    dv = torch.cat(dvs, dim=2) if dvs else torch.zeros_like(v, dtype=torch.float32)
    return (dq.reshape(B, Hq, Sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def hbm_bytes(B, Hq, Hkv, Sq, Sk, d, dtype_bytes=2) -> int:
    """flash_attention's definitional device-memory traffic: Q + K + V + O,
    each once."""
    return dtype_bytes * (B * Hq * Sq * d * 2 + B * Hkv * Sk * d * 2)
