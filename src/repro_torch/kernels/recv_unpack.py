"""recv_unpack on Hopper: slot-map row gather plus optional fp8 dequant.

Replaces ``src/repro/kernels/recv_unpack.py:43 recv_unpack`` (Pallas,
scalar-prefetched gather). Bound on the H100 by bytes: one received row
(and its scale row) read and one row written per output slot; at the DBRX
decode slice it fills the [2, 128, 6144] expert-major tensor. The kernel
(``csrc/recv_unpack.cu``) runs one block per output row that loads its slot
index once; rows whose width is a multiple of 8 move in 16-byte pieces, any
other width element by element (HT stage 2 later gathers f32 scale rows
H/block wide). Dequant multiplies in f32 and rounds once, bit-equal to
``ref.recv_unpack``; an empty slot is an exact zero row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches by this wrapper (chip_smoke reads it)

_ANY = (torch.float32, torch.bfloat16, torch.float16, torch.float8_e4m3fn)


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
        vec = H % 8 == 0 and _build.aligned16(recv, out)
        _build.launch("ep_recv_unpack_copy", recv.data_ptr(), gmap.data_ptr(),
                      out.data_ptr(), M, R, H, rdt, odt, int(vec))
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
    vec = H % 8 == 0 and blk % 8 == 0 and _build.aligned16(out)
    _build.launch("ep_recv_unpack_dequant", recv.data_ptr(), scales.data_ptr(),
                  gmap.data_ptr(), out.data_ptr(), M, R, H, blk, odt, int(vec))
    launches += 1
    return out
