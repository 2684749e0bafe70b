"""paged_decode_attention on Hopper: split-KV flash decoding over a paged KV
pool, one query token per request.

Replaces ``src/repro/kernels/decode_attention.py:112 paged_decode_attention``
(the Pallas pair ``_stage1_kernel``, ``_stage2_kernel``). Bound on the H100
by bytes: every live K/V row is read once. The kernel
(``csrc/paged_decode_attention.cu``) runs stage 1 as one block per (request,
split, kv head, tile of at most 16 query heads) that streams its split's
live tokens through the page table into a ring of stages in the pool's own
type, with q and the sums in registers and an online softmax in f32, and
never reads a token at or past ``kv_len``. bf16 GQA with head widths of 64
or 128 (DBRX) moves each row with one bulk copy on the TMA engine and runs
both products on tensor cores (``mma.sync``, P as a bf16 high and low
part). The shared pool of absorbed MLA at DeepSeek-V3's widths (bf16, Hkv
1, a multiple of 64 query heads, dk 576, dv 512, pages of 8, 16 or 32) runs
on ``wgmma``: one block per 64 heads of a (request, split), pages loaded by
TMA into swizzled tiles of 64 tokens, P as a bf16 high and low part, the
values read from the key tile. Every other case uses 16-byte ``cp.async``
and CUDA cores; the C entry chooses by shape and type. How a request is
split depends only on its own ``kv_len`` and the
caller's split count (``kv_splits``): a request of one split is written
directly, and stage 2, launched only when a request of the table's width
could be split (``splits_possible``), merges the splits of the others in a
fixed order. Each stage has its own launch count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0          # stage-1 launches by this wrapper (chip_smoke reads it)
stage2_launches = 0   # stage-2 launches (only calls where splits_possible)

TILE = 32             # tokens per stage-1 tile (csrc: TT)
MIN_SPLIT = 256       # fewest tokens of a split but the last (csrc: MIN_SPLIT)

_IN = (torch.float32, torch.bfloat16, torch.float16)


def kv_splits(kv_len: int, num_kv_splits: int) -> tuple[int, int]:
    """(splits, span) of one request, as the kernel cuts it (``split_span``
    in the .cu): at most ``num_kv_splits`` splits, every one but the last
    ``span`` tokens (a multiple of ``TILE``, at least ``MIN_SPLIT``); split s
    covers tokens [s * span, min((s + 1) * span, kv_len)). An idle
    request (kv_len 0) has one empty split. Nothing but the request's own
    length and the caller's bound goes in, so a request's bits do not depend
    on its neighbours."""
    if kv_len <= 0:
        return 1, TILE
    n = max(1, min(num_kv_splits, kv_len // MIN_SPLIT))
    span = -(-(-(-kv_len // n)) // TILE) * TILE
    return -(-kv_len // span), span


def splits_possible(num_kv_splits: int, max_pages: int, page: int) -> bool:
    """Whether a request of this table could be cut into more than one split
    (its kv_len is at most the table's ``max_pages * page`` tokens): only
    then do the partials exist and stage 2 launch."""
    return kv_splits(max_pages * page, num_kv_splits)[0] > 1


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor | None,
                           kv_indices: torch.Tensor, kv_lens: torch.Tensor, *,
                           scale: float, num_kv_splits: int = 1,
                           dv: int | None = None) -> torch.Tensor:
    """q: [B, Hq, dk]; k_pages: [P+1, page, Hkv, dk]; v_pages: [P+1, page,
    Hkv, dv] of k's dtype, or None for the shared pool (Hkv == 1, values the
    leading ``dv`` key columns); kv_indices: [B, max_pages] int32; kv_lens:
    [B] int32, all on the card. Same contract as
    ``ref.paged_decode_attention``: returns [B, Hq, dv] f32."""
    global launches, stage2_launches
    name = "paged_decode_attention"
    share = v_pages is None
    _build.check_cuda(name, q, k_pages, kv_indices, kv_lens,
                      *(() if share else (v_pages,)))
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"{name}: want q [B, Hq, dk] and pages [P+1, page, "
                         f"Hkv, dk], got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, Hq, dk = q.shape
    _, page, Hkv, dkp = k_pages.shape
    if kv_indices.dtype != torch.int32 or kv_indices.dim() != 2 or kv_indices.shape[0] != B:
        raise ValueError(f"{name}: kv_indices must be int32 [{B}, max_pages], got "
                         f"{kv_indices.dtype} {tuple(kv_indices.shape)}")
    if kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (B,):
        raise ValueError(f"{name}: kv_lens must be int32 [{B}], got "
                         f"{kv_lens.dtype} {tuple(kv_lens.shape)}")
    if dkp != dk or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    if share:
        if dv is None or Hkv != 1 or dv > dk:
            raise ValueError(f"{name}: the shared pool needs Hkv == 1 and "
                             f"dv <= dk, got Hkv {Hkv}, dv {dv}")
    else:
        if v_pages.shape[:3] != k_pages.shape[:3] or v_pages.dtype != k_pages.dtype:
            raise ValueError(f"{name}: v pages {v_pages.dtype} {tuple(v_pages.shape)} "
                             f"do not match k pages {k_pages.dtype} {tuple(k_pages.shape)}")
        dv = v_pages.shape[-1]
    S, max_pages = int(num_kv_splits), kv_indices.shape[1]
    if S < 1 or max_pages % S:
        raise ValueError(f"{name}: max_pages {max_pages} must divide by the "
                         f"split count {S}")
    if dk % 8 or dv % 8 or dv > 512:
        raise ValueError(f"{name}: dk {dk} and dv {dv} must be multiples of 8, "
                         "dv at most 512")
    qdt = _build.dtype_code(name, q.dtype, _IN)
    kdt = _build.dtype_code(name, k_pages.dtype, _IN)
    if not _build.aligned16(q, k_pages, *(() if share else (v_pages,))):
        raise ValueError(f"{name}: q and the pools must be 16-byte aligned")
    out = torch.empty((B, Hq, dv), dtype=torch.float32, device=q.device)
    o = lse = None
    split = splits_possible(S, max_pages, page)
    if split:
        o = torch.empty((B, S, Hq, dv), dtype=torch.float32, device=q.device)
        lse = torch.empty((B, S, Hq), dtype=torch.float32, device=q.device)
    vp = k_pages if share else v_pages
    _build.launch("ep_paged_decode_stage1", q.data_ptr(), k_pages.data_ptr(),
                  vp.data_ptr(), kv_indices.data_ptr(), kv_lens.data_ptr(),
                  out.data_ptr(), None if o is None else o.data_ptr(),
                  None if lse is None else lse.data_ptr(), B, S, Hq, Hkv, dk, dv,
                  page, max_pages, k_pages.shape[0], float(scale), qdt, kdt, int(share))
    launches += 1
    if split:
        _build.launch("ep_paged_decode_stage2", o.data_ptr(), lse.data_ptr(),
                      kv_lens.data_ptr(), out.data_ptr(), B, S, Hq, dv,
                      max_pages * page)
        stage2_launches += 1
    return out
