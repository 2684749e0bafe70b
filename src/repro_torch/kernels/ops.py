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

The training backward has its own entries (``grouped_gemm_dw``,
``combine_gather_reduce_bwd``, ``flash_attention_fwd`` with the row
log-sum-exp, ``flash_attention_bwd``), routed the same way, which the
``torch.autograd.Function``s of ``kernels/autograd.py`` and the EP
combine's in ``core/ll.py`` call in their forward and backward. A kernel records no autograd graph: an entry that
gets a CUDA tensor requiring grad while grad mode is on raises (``_guard``),
so a gradient never stops silently at a kernel; the Functions run their
forward and backward with grad mode off.
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


def _guard(name: str, *tensors) -> None:
    """Refuse, on the card, an input that autograd would have to follow
    through a kernel: go through ``kernels.autograd`` instead."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name}: a CUDA input requires grad, but a kernel records no autograd "
            "graph; call it through repro_torch.kernels.autograd")


def combine_reduce(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[T, K, H] responses reduced under [T, K] weights -> [T, H]."""
    if _plain(y):
        return _ref.combine_reduce(y, w)
    _guard("combine_reduce", y, w)
    return _cr.combine_reduce(y, w)


def quantize_fp8(x: torch.Tensor, block: int = 128):
    """Block-wise fp8 e4m3: [..., H] -> (q, scales [..., H/block])."""
    if _plain(x):
        return _ref.quantize_fp8(x, block)
    _guard("quantize_fp8", x)
    return _fp8.quantize_fp8(x, block)


def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_fp8: q times its block's scale."""
    if _plain(q):
        return _ref.dequantize_fp8(q, scales, out_dtype)
    _guard("dequantize_fp8", q, scales)
    return _fp8.dequantize_fp8(q, scales, out_dtype)


def dispatch_pack(x: torch.Tensor, gmap: torch.Tensor,
                  quant_block: int | None = None, out_dtype=None):
    """Slot-pack [T, H] rows through gmap [N, C] (+ optional fp8)."""
    if _plain(x):
        return _ref.dispatch_pack(x, gmap, quant_block, out_dtype)
    _guard("dispatch_pack", x)
    return _dp.dispatch_pack(x, gmap, quant_block=quant_block,
                             out_dtype=out_dtype)


def recv_unpack(recv: torch.Tensor, gmap: torch.Tensor,
                scales: torch.Tensor | None = None, out_dtype=None):
    """Unpack received rows through a slot map (+ optional fp8 dequant)."""
    if _plain(recv):
        return _ref.recv_unpack(recv, gmap, scales, out_dtype)
    _guard("recv_unpack", recv, scales)
    return _ru.recv_unpack(recv, gmap, scales, out_dtype=out_dtype)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """Per-expert [L, A, H] @ [L, H, F], rows >= counts[l] zero."""
    if _plain(x):
        return _ref.grouped_gemm(x, w, counts)
    _guard("grouped_gemm", x, w)
    return _gg.grouped_gemm(x, w, counts)


def combine_gather_reduce(recv: torch.Tensor, rows: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Gather [T, K] rows of recv and reduce them under the weights."""
    if _plain(recv):
        return _ref.combine_gather_reduce(recv, rows, w)
    _guard("combine_gather_reduce", recv, w)
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
    _guard("paged_decode_attention", q, k_pages, v_pages)
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
    _guard("flash_attention", q, k, v)
    return _fa.flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(),
                                    scale=scale, window=window, causal=causal)


# ---- the training backward ----

def grouped_gemm_dw(x: torch.Tensor, dy: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """grouped_gemm's weight gradient: [L, A, H]ᵀ·[L, A, F] over each
    expert's live rows -> [L, H, F]."""
    if _plain(x):
        return _ref.grouped_gemm_dw(x, dy, counts)
    _guard("grouped_gemm_dw", x, dy)
    return _gg.grouped_gemm_dw(x, dy, counts)


def combine_gather_reduce_bwd(recv: torch.Tensor, rows: torch.Tensor,
                              w: torch.Tensor, dout: torch.Tensor):
    """combine_gather_reduce's backward -> (d_recv [R, H], d_w [T, K] f32),
    where the valid rows name each received row at most once: d_recv is
    stored, not summed, once per (t, k). The EP maps it runs over hold
    that in every layout, drop and placement (``comb_recv_rows``, the
    hierarchical ``h_slot_rows``; ``tests/test_torch_train_layouts.py``
    checks them and ``h_rail_rows`` and ``h_src_rows``, whose transposes
    are B2 and B1 copies)."""
    if _plain(recv):
        return _ref.combine_gather_reduce_bwd(recv, rows, w, dout)
    _guard("combine_gather_reduce_bwd", recv, w, dout)
    return _cgr.combine_gather_reduce_bwd(recv, rows, w, dout)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, window: int | None = None, causal: bool = True):
    """``flash_attention_bshd`` that also returns each row's log-sum-exp:
    (out [B, Sq, Hq, d], lse [B, Hq, Sq] f32)."""
    if _plain(q):
        out, lse = _ref.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                            v.transpose(1, 2), scale=scale,
                                            window=window, causal=causal)
        return out.transpose(1, 2), lse
    _guard("flash_attention", q, k, v)
    return _fa.flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(),
                                    scale=scale, window=window, causal=causal,
                                    with_lse=True)


def flash_attention_bwd(q, k, v, o, do, lse, *, scale: float,
                        window: int | None = None, causal: bool = True):
    """Flash attention's backward on the [B, S, H, d] layout -> (dq, dk,
    dv)."""
    if _plain(q):
        grads = _ref.flash_attention_bwd(*(t.transpose(1, 2) for t in (q, k, v, o, do)),
                                         lse, scale=scale, window=window, causal=causal)
        return tuple(g.transpose(1, 2) for g in grads)
    _guard("flash_attention_bwd", q, k, v, o, do)
    return _fa.flash_attention_bwd(*(t.contiguous() for t in (q, k, v, o, do)), lse,
                                   scale=scale, window=window, causal=causal)
