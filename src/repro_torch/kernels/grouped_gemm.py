"""grouped_gemm on Hopper: per-expert x [L, A, H] @ w [L, H, F] with a
ragged row count.

Replaces ``src/repro/kernels/grouped_gemm.py:53 grouped_gemm`` (Pallas,
scalar-prefetched counts, tiles past the count skipped). At the DBRX decode
slice each call multiplies a few dozen valid rows per expert by 2·6144·10752
bf16 weights (264 MB), so it is bound by the weights' bytes, not by the
tensor cores. The kernel (``csrc/grouped_gemm.cu``) tiles the output 64x128
per block with tensor-core fragments over a three-stage cp.async ring, so
every live row tile streams its weight columns once with two tiles in
flight; a block whose rows all lie past ``counts[l]`` writes zeros and
loads nothing. f32 operands take a CUDA-core tiled path with exact f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches by this wrapper (chip_smoke reads it)

_DT = (torch.bfloat16, torch.float32)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """x: [L, A, H], w: [L, H, F] (same dtype, bf16 or f32), counts: [L]
    int32 on the card. Same contract as ``ref.grouped_gemm``."""
    global launches
    name = "grouped_gemm"
    _build.check_cuda(name, x, w, counts)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ {tuple(w.shape)} "
                         "do not chain as [L, A, H] @ [L, H, F]")
    if counts.dtype != torch.int32 or counts.shape != (x.shape[0],):
        raise ValueError(f"{name}: counts must be int32 [L], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: x is {x.dtype} but w is {w.dtype}")
    dt = _build.dtype_code(name, x.dtype, _DT)
    L, A, H = x.shape
    F = w.shape[2]
    if H % 8 or F % 8 or not _build.aligned16(x, w):
        raise ValueError(f"{name}: H={H} and F={F} must be multiples of 8 with "
                         "16-byte aligned operands")
    out = torch.empty((L, A, F), dtype=x.dtype, device=x.device)
    _build.launch("ep_grouped_gemm", x.data_ptr(), w.data_ptr(),
                  counts.data_ptr(), out.data_ptr(), L, A, H, F, dt)
    launches += 1
    return out
