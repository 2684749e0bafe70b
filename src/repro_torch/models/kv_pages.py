"""Paged KV cache: page-table-indexed pools and the host-side free-list
allocator (port of ``src/repro/models/kv_pages.py``): GQA pools {"k", "v"}
and the absorbed-MLA pool {"kv"}.

    pool      [num_pages + 1, page_size, Hkv, d]   (device, per layer)
    page_tbl  [B, max_pages] int32                  (host-built, per step)
    kv_lens   [B] int32                             (host-built, per step)

Row ``num_pages`` is the pad page: idle slots and unallocated table entries
point at it. Its content never matters, because the decode kernel gives
every position at or past ``kv_lens`` an exact zero
(``csrc/paged_decode_attention.cu``), so neither the pad page nor the
garbage of a recycled page can perturb a live request. Memory scales with
the pages allocated to live requests, not ``batch × max_len``.

Allocation is host-side and happens only at step boundaries
(``runtime/scheduler.py``). The allocator is a LIFO free list: recycling hot
pages quickly is deliberate, since it stresses the masking contract.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig, ParamSpec


class PagePoolExhausted(RuntimeError):
    """Raised when an alloc cannot be satisfied; names the pool capacity."""


class PageAllocator:
    """Host-side LIFO free-list allocator over ``num_pages`` page ids.

    A page id is never handed to two live owners; a double free raises;
    exhaustion raises ``PagePoolExhausted`` naming the capacity."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"need num_pages >= 1 and page_size >= 1, got "
                             f"{num_pages}, {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.pad_page = self.num_pages          # pool row used for idle slots
        self._free = list(range(num_pages - 1, -1, -1))   # pop() yields 0 first
        self._live: set[int] = set()
        self.peak_live = 0                      # high-water mark of live pages

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return len(self._live)

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free):
            raise PagePoolExhausted(
                f"page pool exhausted: requested {n} page(s) with "
                f"{len(self._free)} free of {self.num_pages} total "
                f"(page_size={self.page_size}); raise num_pages or lower "
                f"admission concurrency")
        ids = [self._free.pop() for _ in range(n)]
        self._live.update(ids)
        self.peak_live = max(self.peak_live, len(self._live))
        return ids

    def free(self, ids) -> None:
        for i in ids:
            if i not in self._live:
                raise ValueError(f"free of page {i} which is not live")
            self._live.remove(i)
            self._free.append(i)


def pages_for_tokens(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV entries."""
    return -(-tokens // page_size)


def paged_kv_pool_spec(cfg: ArchConfig, num_pages: int, page_size: int):
    """GQA per-layer pools: {"k", "v"} each [num_pages+1, page, n_kv, hd],
    zeros (the pad page included)."""
    a = cfg.attn
    arr = ParamSpec((num_pages + 1, page_size, a.n_kv, a.head_dim), cfg.dtype,
                    init="zeros")
    return {"k": arr, "v": arr}


def paged_mla_pool_spec(cfg: ArchConfig, num_pages: int, page_size: int):
    """Absorbed-MLA per-layer pool: {"kv"} [num_pages+1, page, 1,
    r_kv+rope] holding [ckv | k_rope], zeros: one shared pool whose leading
    r_kv columns are the values."""
    m = cfg.mla
    width = m.kv_lora_rank + m.qk_rope_dim
    return {"kv": ParamSpec((num_pages + 1, page_size, 1, width), cfg.dtype,
                            init="zeros")}


def write_token(pool: torch.Tensor, new: torch.Tensor, page_tbl: torch.Tensor,
                kv_lens: torch.Tensor) -> torch.Tensor:
    """Write one decode token's KV row per request into the pool, in place
    (the JAX version returns a new pool), and return the pool.

    pool: [P+1, page, Hkv, d]; new: [B, Hkv, d]; page_tbl: [B, max_pages]
    int32; kv_lens: [B] int32 tokens already held. The row lands at
    (tbl[b, kv_lens[b] // page], kv_lens[b] % page). Idle slots carry
    all-pad tables, so their rows land in the pad page; on the card the
    duplicate writes leave any one of them there, which no live request
    reads."""
    max_pages = page_tbl.shape[1]
    page = pool.shape[1]
    lens = kv_lens.long()
    ord_ = torch.clamp(lens // page, 0, max_pages - 1)
    page_ids = torch.gather(page_tbl, 1, ord_[:, None])[:, 0].long()
    pool[page_ids, lens % page] = new.to(pool.dtype)
    return pool


def dense_equiv_tokens(batch: int, max_len: int) -> int:
    """Token capacity a dense [B, S_max] cache reserves."""
    return batch * max_len
