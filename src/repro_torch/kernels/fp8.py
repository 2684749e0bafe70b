"""quantize_fp8 / dequantize_fp8 on Hopper: standalone block-wise fp8 e4m3.

Replaces ``src/repro/kernels/fp8.py:50 quantize_fp8`` and ``:76
dequantize_fp8`` (Pallas, (row-block, hidden-block) tiles). Bound on the
H100 by bytes. On the LL ``deepep`` path dequantize turns each rank's
received rows, [2, 128, 6144] fp8 with [2, 128, 48] scales at the DBRX
decode slice, into the bf16 expert input; quantize has no call site. The
kernels (``csrc/fp8.cu``): quantize runs the quantizer ``dispatch_pack``'s
quant mode runs (``csrc/quant.cuh``), each row its own source, so the two
agree bit for bit: a block of ``8·2^k`` elements (k <= 7) on a 16-byte
aligned ``x`` is held in registers by a group of ``block / 8`` lanes (at
most 32) on a persistent grid, read once for its amax and its rounding
where the first kernel's warp per block read it twice with lanes idle;
an all-zero block is stored without dividing (a zero dividend takes the
division's slow path); a call of few rows is cut into more, shorter rows
(``row_split``) to cover more SMs; any other block or alignment takes one
warp per block. Both divide by the scale (never multiply by its
reciprocal) and round once. Dequantize
multiplies each value by its block's scale in f32 and rounds once,
bit-equal to ``ref.dequantize_fp8``.
"""
from __future__ import annotations

import functools

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
    M = x.numel() // H
    p = row_split(M, H, block, _sm_count(x.device.index))
    _build.launch("ep_quantize_fp8", x.data_ptr(), q.data_ptr(), s.data_ptr(),
                  M * p, H // p, block, xdt, int(vec))
    quantize_launches += 1
    return q, s


def row_split(M: int, H: int, block: int, sms: int) -> int:
    """Parts p of each row for quantize's launch: [M, H] is quantized as
    [M·p, H/p], the same bytes in and out, since blocks never straddle a
    part. The quantizer's grid has one block per row, up to 8 an SM, so a
    few rows (16 at DBRX's decode) would leave most SMs idle: p grows, as a
    divisor of the row's H/block quant blocks, while M·p < sms and a part
    keeps at least one round of the 256-thread block (8 elements a thread,
    max(2048, 8·block) elements)."""
    nblk, least, p = H // block, max(2048, 8 * block), 1
    for d in range(2, nblk + 1):
        if M * p >= sms or H // d < least:
            break
        if nblk % d == 0:
            p = d
    return p


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
