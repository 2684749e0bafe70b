"""The kernels' entry points: route by where the tensor lies.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. Any
other tensor goes to the hand-written Hopper kernel, whose wrapper launches
it or raises (wrong device, dtype, shape or alignment); nothing falls back.
Unlike the TPU routing in ``src/repro/kernels/ops.py`` there are no
``H % 128`` lane gates or ``M % 8`` row gates: the kernels take any H that
is a multiple of 8, any fp8 block that divides H, and ``recv_unpack`` any
row width; nor the ``dk % 128`` / ``page % 8`` gates of paged decode
attention, whose kernel takes any page size and head widths that are
multiples of 8; nor the TPU gate of ``flash_attention_bshd``, which picks
the kernel or the plain version by device and has no chunked-XLA fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import combine_gather_reduce as _cgr
from repro_torch.kernels import combine_reduce as _cr
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dispatch_pack as _dp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fp8 as _fp8
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import recv_unpack as _ru


def _plain(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def combine_reduce(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[T, K, H] responses reduced under [T, K] weights -> [T, H]."""
    if _plain(y):
        return _ref.combine_reduce(y, w)
    return _cr.combine_reduce(y, w)


def quantize_fp8(x: torch.Tensor, block: int = 128):
    """Block-wise fp8 e4m3: [..., H] -> (q, scales [..., H/block])."""
    if _plain(x):
        return _ref.quantize_fp8(x, block)
    return _fp8.quantize_fp8(x, block)


def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_fp8: q times its block's scale."""
    if _plain(q):
        return _ref.dequantize_fp8(q, scales, out_dtype)
    return _fp8.dequantize_fp8(q, scales, out_dtype)


def dispatch_pack(x: torch.Tensor, gmap: torch.Tensor,
                  quant_block: int | None = None, out_dtype=None):
    """Slot-pack [T, H] rows through gmap [N, C] (+ optional fp8)."""
    if _plain(x):
        return _ref.dispatch_pack(x, gmap, quant_block, out_dtype)
    return _dp.dispatch_pack(x, gmap, quant_block=quant_block,
                             out_dtype=out_dtype)


def recv_unpack(recv: torch.Tensor, gmap: torch.Tensor,
                scales: torch.Tensor | None = None, out_dtype=None):
    """Unpack received rows through a slot map (+ optional fp8 dequant)."""
    if _plain(recv):
        return _ref.recv_unpack(recv, gmap, scales, out_dtype)
    return _ru.recv_unpack(recv, gmap, scales, out_dtype=out_dtype)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """Per-expert [L, A, H] @ [L, H, F], rows >= counts[l] zero."""
    if _plain(x):
        return _ref.grouped_gemm(x, w, counts)
    return _gg.grouped_gemm(x, w, counts)


def combine_gather_reduce(recv: torch.Tensor, rows: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Gather [T, K] rows of recv and reduce them under the weights."""
    if _plain(recv):
        return _ref.combine_gather_reduce(recv, rows, w)
    return _cgr.combine_gather_reduce(recv, rows, w)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor | None,
                           kv_indices: torch.Tensor, kv_lens: torch.Tensor, *,
                           scale: float, num_kv_splits: int = 1,
                           dv: int | None = None) -> torch.Tensor:
    """Split-KV paged decode attention: q [B, Hq, dk] over the pools through
    the page table -> [B, Hq, dv] f32."""
    if _plain(q):
        return _ref.paged_decode_attention(q, k_pages, v_pages, kv_indices,
                                           kv_lens, scale=scale,
                                           num_kv_splits=num_kv_splits, dv=dv)
    return _da.paged_decode_attention(q, k_pages, v_pages, kv_indices, kv_lens,
                                      scale=scale, num_kv_splits=num_kv_splits,
                                      dv=dv)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float, window: int | None = None,
                         causal: bool = True) -> torch.Tensor:
    """Flash attention on the [B, S, H, d] layout: q [B, Sq, Hq, d], k/v
    [B, Sk, Hkv, d] -> [B, Sq, Hq, d]."""
    if _plain(q):
        out = _ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), scale=scale,
                                   window=window, causal=causal)
        return out.transpose(1, 2)
    return _fa.flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(),
                                    scale=scale, window=window, causal=causal)
