"""recv_unpack on Hopper: slot-map row gather plus optional fp8 dequant.

Replaces ``src/repro/kernels/recv_unpack.py:43 recv_unpack`` (Pallas,
scalar-prefetched gather). Bound on the H100 by bytes: one received row
(and its scale row) read and one row written per output slot; at the DBRX
decode slice it fills the [2, 128, 6144] expert-major tensor. The kernels
(``csrc/recv_unpack.cu``): copy mode runs the row gather that
``dispatch_pack``'s copy mode runs (``csrc/gather.cuh``: a grid over
(output row, chunk) whose threads issue all their 16-byte loads before
their stores, a sentinel row stored as zeros without a load, a dtype change
through f32) wherever ``copy_route`` allows it, and any other row width
element by element (HT stage 2 later gathers f32 scale rows H/block wide).
Dequant reads the payload 16 fp8 values at a time into bf16 or f16 (8
where the block width or the output type allows no more,
``dequant_piece``), issues all of a thread's loads and scales before the
first multiply, multiplies in f32 and rounds once, bit-equal to
``ref.recv_unpack``, and stores contiguously across a warp; an empty slot
is an exact zero row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches by this wrapper (chip_smoke reads it)

_ANY = (torch.float32, torch.bfloat16, torch.float16, torch.float8_e4m3fn)


def copy_route(H: int, rdt: torch.dtype, odt: torch.dtype, *ptrs: int) -> int:
    """1 where the copy runs the shared row gather: rows of a multiple of 8
    elements at 16-byte aligned addresses ``ptrs`` whose dtype changes or
    whose bytes make whole 16-byte pieces (an fp8 row of 8 + 16k elements
    does not); else 0, element by element."""
    if H % 8 or any(p % 16 for p in ptrs):
        return 0
    return int(rdt != odt or H * rdt.itemsize % 16 == 0)


def dequant_piece(blk: int, odt: torch.dtype, recv_ptr: int, out_ptr: int) -> int:
    """Payload bytes a thread-step of the dequant: 16 where the quant block
    holds whole 16-byte pieces, the payload is 16-byte aligned and the
    output a 2-byte type (a lane's 16 outputs then make two 16-byte stores
    that a lane pair interleaves); 8 where the block and the payload allow 8;
    else 1 (element by element). Both vector routes need a 16-byte aligned
    output."""
    if out_ptr % 16:
        return 1
    if blk % 16 == 0 and recv_ptr % 16 == 0 and odt.itemsize == 2:
        return 16
    return 8 if blk % 8 == 0 and recv_ptr % 8 == 0 else 1


def recv_unpack(recv: torch.Tensor, gmap: torch.Tensor,
                scales: torch.Tensor | None = None, *, out_dtype=None):
    """recv: [R, H] CUDA; gmap: int32 of any shape with sentinel R; scales:
    [R, H/block] f32 for an fp8 payload. Same contract as
    ``ref.recv_unpack``: gmap.shape + (H,)."""
    global launches
    name = "recv_unpack"
    tensors = (recv, gmap) if scales is None else (recv, gmap, scales)
    _build.check_cuda(name, *tensors)
    if recv.dim() != 2 or gmap.dtype != torch.int32:
        raise ValueError(f"{name}: want recv [R, H] and an int32 gmap, got "
                         f"{tuple(recv.shape)} and {gmap.dtype}")
    R, H = recv.shape
    M = gmap.numel()
    if scales is None:
        odt_t = recv.dtype if out_dtype is None else out_dtype
        rdt = _build.dtype_code(name, recv.dtype, _ANY)
        odt = _build.dtype_code(name, odt_t, _ANY)
        out = torch.empty(tuple(gmap.shape) + (H,), dtype=odt_t,
                          device=recv.device)
        route = copy_route(H, recv.dtype, odt_t, recv.data_ptr(), out.data_ptr())
        _build.launch("ep_recv_unpack_copy", recv.data_ptr(), gmap.data_ptr(),
                      out.data_ptr(), M, R, H, rdt, odt, route)
        launches += 1
        return out
    if recv.dtype != torch.float8_e4m3fn or scales.dtype != torch.float32:
        raise TypeError(f"{name}: dequant takes an fp8 e4m3 payload with f32 "
                        f"scales, got {recv.dtype} and {scales.dtype}")
    nblk = scales.shape[-1]
    if scales.shape != (R, nblk) or nblk == 0 or H % nblk:
        raise ValueError(f"{name}: scales {tuple(scales.shape)} do not block "
                         f"the payload [{R}, {H}]")
    blk = H // nblk
    odt_t = torch.bfloat16 if out_dtype is None else out_dtype
    odt = _build.dtype_code(name, odt_t, _ANY)
    out = torch.empty(tuple(gmap.shape) + (H,), dtype=odt_t, device=recv.device)
    piece = dequant_piece(blk, odt_t, recv.data_ptr(), out.data_ptr())
    _build.launch("ep_recv_unpack_dequant", recv.data_ptr(), scales.data_ptr(),
                  gmap.data_ptr(), out.data_ptr(), M, R, H, blk, odt, piece)
    launches += 1
    return out
