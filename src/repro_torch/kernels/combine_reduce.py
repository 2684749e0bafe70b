"""combine_reduce on Hopper: the K-way weighted reduction of gathered
responses.

Replaces ``src/repro/kernels/combine_reduce.py:32 combine_reduce`` (Pallas,
[bt, K, bh] tiles reduced over K on the VPU). No call site in the port
reaches it: ``combine_gather_reduce`` fuses the gather into the same sum.
Bound on the H100 by bytes: each of the T·K·H responses read once and each
output written once. The kernel (``csrc/combine_reduce.cu``) runs the
reduce ``combine_gather_reduce`` runs (``csrc/reduce.cuh``) with token t's
rows at ``t·K + k`` of ``y`` viewed as [T·K, H]: blocks of 64 threads over
(token, 64 16-byte output pieces), each thread issuing the loads of all K
rows (up to 8 at a time) before the first FMA, where the first kernel
walked k with a load and an FMA in a chain. The weights are read in their
own dtype; the sum runs in f32 over k = 0..K-1 in a fixed order and is
cast once, so with f32 weights it equals ``combine_gather_reduce`` over
identity rows bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches by this wrapper (chip_smoke reads it)

_FLOAT = (torch.float32, torch.bfloat16, torch.float16)


def combine_reduce(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y: [T, K, H], w: [T, K], both on the card. Same contract as
    ``ref.combine_reduce``: [T, H] in y's dtype (bf16 for fp8)."""
    global launches
    name = "combine_reduce"
    _build.check_cuda(name, y, w)
    if y.dim() != 3 or tuple(w.shape) != tuple(y.shape[:2]):
        raise ValueError(f"{name}: want y [T, K, H] and w [T, K], got "
                         f"{tuple(y.shape)} and {tuple(w.shape)}")
    ydt = _build.dtype_code(name, y.dtype, _FLOAT + (torch.float8_e4m3fn,))
    wdt = _build.dtype_code(name, w.dtype, _FLOAT)
    T, K, H = y.shape
    if H % 8 or not _build.aligned16(y):
        raise ValueError(f"{name}: hidden {H} must be a multiple of 8 with "
                         "16-byte aligned rows")
    odt_t = y.dtype if y.dtype in _FLOAT else torch.bfloat16
    out = torch.empty((T, H), dtype=odt_t, device=y.device)
    _build.launch("ep_combine_reduce", y.data_ptr(), w.data_ptr(), out.data_ptr(),
                  T, H, K, ydt, wdt, _build.DTYPE_CODES[odt_t])
    launches += 1
    return out
