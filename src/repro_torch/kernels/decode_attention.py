"""paged_decode_attention on Hopper: split-KV flash decoding over a paged KV
pool, one query token per request.

Replaces ``src/repro/kernels/decode_attention.py:112 paged_decode_attention``
(the Pallas pair ``_stage1_kernel``, ``_stage2_kernel``). Bound on the H100
by bytes: every live K/V row is read once. The kernel
(``csrc/paged_decode_attention.cu``) runs stage 1 as one block per (request,
split, kv head, tile of at most 16 query heads) that walks its split's live
tokens through the page table in chunks of 16, with an online softmax in f32,
and never reads a token at or past ``kv_len``; stage 2 reduces the splits in
a fixed order. Both stages launch from here, each with its own count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0          # stage-1 launches by this wrapper (chip_smoke reads it)
stage2_launches = 0   # stage-2 launches

_IN = (torch.float32, torch.bfloat16, torch.float16)


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
    o = torch.empty((B, S, Hq, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, S, Hq), dtype=torch.float32, device=q.device)
    vp = k_pages if share else v_pages
    _build.launch("ep_paged_decode_stage1", q.data_ptr(), k_pages.data_ptr(),
                  vp.data_ptr(), kv_indices.data_ptr(), kv_lens.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), B, S, Hq, Hkv, dk, dv, page,
                  max_pages, float(scale), qdt, kdt, int(share))
    launches += 1
    out = torch.empty((B, Hq, dv), dtype=torch.float32, device=q.device)
    _build.launch("ep_paged_decode_stage2", o.data_ptr(), lse.data_ptr(),
                  out.data_ptr(), B, S, Hq, dv)
    stage2_launches += 1
    return out
