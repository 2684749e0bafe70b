"""The EP kernels' entry points: route by where the tensor lies.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. Any
other tensor goes to the hand-written Hopper kernel, whose wrapper launches
it or raises (wrong device, dtype, shape or alignment); nothing falls back.
Unlike the TPU routing in ``src/repro/kernels/ops.py`` there are no
``H % 128`` lane gates: the kernels take any H that is a multiple of 8, any
fp8 block that divides H, and ``recv_unpack`` any row width.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import combine_gather_reduce as _cgr
from repro_torch.kernels import dispatch_pack as _dp
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import recv_unpack as _ru


def _plain(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


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
