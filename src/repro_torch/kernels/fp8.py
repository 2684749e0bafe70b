"""quantize_fp8 / dequantize_fp8 on Hopper: standalone block-wise fp8 e4m3.

Replaces ``src/repro/kernels/fp8.py:50 quantize_fp8`` and ``:76
dequantize_fp8`` (Pallas, (row-block, hidden-block) tiles). Bound on the
H100 by bytes. On the LL ``deepep`` path dequantize turns each rank's
received rows, [2, 128, 6144] fp8 with [2, 128, 48] scales at the DBRX
decode slice, into the bf16 expert input. The kernels (``csrc/fp8.cu``):
quantize runs one warp per (row, quant block), computing what
``dispatch_pack``'s quant mode computes (amax, one true division, one
rounding), so the two agree bit for bit;
dequantize multiplies each value by its block's scale in f32 and rounds
once, bit-equal to ``ref.dequantize_fp8``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# kernel launches by this module's wrappers, one count per kernel
# (chip_smoke reads them)
quantize_launches = 0
dequantize_launches = 0

_FLOAT = (torch.float32, torch.bfloat16, torch.float16)


def quantize_fp8(x: torch.Tensor, block: int = 128):
    """x: [..., H] CUDA, H a multiple of 8 that ``block`` divides. Same
    contract as ``ref.quantize_fp8``: (q [..., H] fp8 e4m3, scales
    [..., H/block] f32)."""
    global quantize_launches
    name = "quantize_fp8"
    _build.check_cuda(name, x)
    xdt = _build.dtype_code(name, x.dtype, _FLOAT)
    H = x.shape[-1] if x.dim() else 0
    if H == 0 or H % 8 or block <= 0 or H % block:
        raise ValueError(f"{name}: want x [..., H] with H a positive multiple "
                         f"of 8 that the block {block} divides, got "
                         f"{tuple(x.shape)}")
    q = torch.empty(x.shape, dtype=torch.float8_e4m3fn, device=x.device)
    s = torch.empty(x.shape[:-1] + (H // block,), dtype=torch.float32,
                    device=x.device)
    vec = block % 8 == 0 and _build.aligned16(x)
    _build.launch("ep_quantize_fp8", x.data_ptr(), q.data_ptr(), s.data_ptr(),
                  x.numel() // H, H, block, xdt, int(vec))
    quantize_launches += 1
    return q, s


def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """q: [..., H] fp8 e4m3, scales: [..., H/block] f32, both CUDA. Same
    contract as ``ref.dequantize_fp8``: [..., H] in ``out_dtype``."""
    global dequantize_launches
    name = "dequantize_fp8"
    _build.check_cuda(name, q, scales)
    if q.dtype != torch.float8_e4m3fn or scales.dtype != torch.float32:
        raise TypeError(f"{name}: takes an fp8 e4m3 payload with f32 scales, "
                        f"got {q.dtype} and {scales.dtype}")
    odt = _build.dtype_code(name, out_dtype, _FLOAT)
    H = q.shape[-1] if q.dim() else 0
    nblk = scales.shape[-1] if scales.dim() else 0
    if (H == 0 or nblk == 0 or H % nblk
            or tuple(scales.shape[:-1]) != tuple(q.shape[:-1])):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} do not block "
                         f"the payload {tuple(q.shape)}")
    blk = H // nblk
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    vec = H % 8 == 0 and blk % 8 == 0 and q.data_ptr() % 8 == 0
    _build.launch("ep_dequantize_fp8", q.data_ptr(), scales.data_ptr(),
                  out.data_ptr(), q.numel() // H, H, blk, odt, int(vec))
    dequantize_launches += 1
    return out
