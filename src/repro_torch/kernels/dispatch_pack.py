"""dispatch_pack on Hopper: slot-map row gather plus optional block fp8.

Replaces ``src/repro/kernels/dispatch_pack.py:42 dispatch_pack`` (Pallas,
scalar-prefetched gather). Bound on the H100 by bytes: one token row read
and one packed row written per live slot; at the DBRX decode slice a call
moves 8·16 rows of 6144 bf16. The kernel (``csrc/dispatch_pack.cu``) runs
one block per slot row that loads its slot index once and moves the row in
16-byte pieces; in quant mode one warp per 128-wide block reduces amax in
f32, divides (never multiplies by a reciprocal) and rounds to e4m3 with
satfinite, so the result is bit-equal to ``ref.dispatch_pack``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches by this wrapper (chip_smoke reads it)

_IN = (torch.float32, torch.bfloat16, torch.float16)
_OUT = _IN + (torch.float8_e4m3fn,)


def dispatch_pack(x: torch.Tensor, gmap: torch.Tensor, *,
                  quant_block: int | None = None, out_dtype=None):
    """x: [T, H] CUDA; gmap: [N, C] int32 with sentinel T. Same contract as
    ``ref.dispatch_pack``: (packed [N, C, H], None) or, quantizing,
    (fp8 [N, C, H], f32 scales [N, C, H/quant_block])."""
    global launches
    name = "dispatch_pack"
    _build.check_cuda(name, x, gmap)
    if x.dim() != 2 or gmap.dim() != 2 or gmap.dtype != torch.int32:
        raise ValueError(f"{name}: want x [T, H] and int32 gmap [N, C], got "
                         f"{tuple(x.shape)} and {gmap.dtype} {tuple(gmap.shape)}")
    T, H = x.shape
    N, C = gmap.shape
    xdt = _build.dtype_code(name, x.dtype, _IN)
    if H % 8 or not _build.aligned16(x):
        raise ValueError(f"{name}: hidden {H} must be a multiple of 8 with "
                         "16-byte aligned rows")
    if quant_block is not None:
        if quant_block <= 0 or H % quant_block:
            raise ValueError(f"{name}: quant block {quant_block} must divide {H}")
        q = torch.empty((N, C, H), dtype=torch.float8_e4m3fn, device=x.device)
        s = torch.empty((N, C, H // quant_block), dtype=torch.float32,
                        device=x.device)
        _build.launch("ep_dispatch_pack_quant", x.data_ptr(), gmap.data_ptr(),
                      q.data_ptr(), s.data_ptr(), N * C, T, H, quant_block, xdt)
        launches += 1
        return q, s
    odt_t = x.dtype if out_dtype is None else out_dtype
    odt = _build.dtype_code(name, odt_t, _OUT)
    out = torch.empty((N, C, H), dtype=odt_t, device=x.device)
    _build.launch("ep_dispatch_pack_copy", x.data_ptr(), gmap.data_ptr(),
                  out.data_ptr(), N * C, T, H, xdt, odt, 1)
    launches += 1
    return out, None
