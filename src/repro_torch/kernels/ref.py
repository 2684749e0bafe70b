"""Plain PyTorch versions of the EP kernels: the semantics of record.

Each hand-written Hopper kernel in this package is held against the function
of the same name here, on the card (``chip_smoke.py``, the CUDA tests), and
these functions are what ``kernels/ops.py`` runs for a tensor on the CPU.
They follow ``src/repro/kernels/ref.py`` line for line, so the CPU tests can
hold each one against the JAX function of the same name.

``positions_by_dest`` is the one-hot-cumsum oracle of the sort-based
``repro_torch.core.slots.positions_by_dest``, as in the JAX package.
"""
from __future__ import annotations

import torch

_FLOAT_OUT = (torch.bfloat16, torch.float32, torch.float16)


def positions_by_dest(dest: torch.Tensor, num_dest: int, valid: torch.Tensor):
    """O(M·D) one-hot oracle: for each entry its slot within its destination
    (exclusive running count of valid entries), plus per-destination totals.
    Out-of-range destinations one-hot to an all-zero row, as in JAX."""
    ar = torch.arange(num_dest, device=dest.device)
    oh = (dest[:, None] == ar[None, :]).to(torch.int32) * valid[:, None].to(torch.int32)
    incl = torch.cumsum(oh, dim=0).to(torch.int32)
    idx = dest.clamp(0, num_dest - 1)[:, None].long()
    pos = torch.take_along_dim(incl - oh, idx, dim=1)[:, 0]
    if dest.shape[0] > 0:
        counts = incl[-1]
    else:
        counts = torch.zeros((num_dest,), dtype=torch.int32, device=dest.device)
    return pos.to(torch.int32), counts.to(torch.int32)


def combine_reduce(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y: [T, K, H], w: [T, K] -> [T, H] = sum_k w·y in f32, cast to y's
    dtype (bf16, f16, f32) or bf16."""
    acc = torch.einsum("tkh,tk->th", y.float(), w.float())
    return acc.to(y.dtype if y.dtype in _FLOAT_OUT else torch.bfloat16)


def combine_gather_reduce(recv: torch.Tensor, rows: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """recv: [R, H]; rows: [T, K] int32 with sentinel R (no contribution);
    w: [T, K] -> [T, H] = sum_k w[t,k]·recv[rows[t,k]]."""
    pad = torch.zeros((1, recv.shape[-1]), dtype=recv.dtype, device=recv.device)
    y = torch.cat([recv, pad], dim=0)[rows.long()]
    return combine_reduce(y, w)


def quantize_fp8(x: torch.Tensor, block: int = 128):
    """Block-wise fp8 e4m3: x [..., H] -> (q [..., H], scales [..., H/block]
    f32) with scale = amax/448, or 1.0 for an all-zero block."""
    H = x.shape[-1]
    if H % block:
        raise ValueError(f"hidden {H} must divide by the quant block {block}")
    g = x.reshape(x.shape[:-1] + (H // block, block)).float()
    amax = g.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on CUDA, torch turns division by a Python scalar into
    # a multiply by its reciprocal, which changes the bits
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 448.0), 1.0)
    q = (g / scale).to(torch.float8_e4m3fn)
    return q.reshape(x.shape), scale[..., 0].float()


def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_fp8. q: [..., H], scales: [..., H/block]."""
    H = q.shape[-1]
    block = H // scales.shape[-1]
    g = q.reshape(q.shape[:-1] + (H // block, block)).float()
    return (g * scales[..., None]).reshape(q.shape).to(out_dtype)


def dispatch_pack(x: torch.Tensor, gmap: torch.Tensor,
                  quant_block: int | None = None, out_dtype=None):
    """x: [T, H]; gmap: [N, C] int32 slot -> token with sentinel T (empty).
    Returns (packed [N, C, H], None), or with ``quant_block`` (fp8 [N, C, H],
    scales [N, C, H/qb]) where empty slots carry scale 1.0."""
    T, H = x.shape
    idx = gmap.long()
    if quant_block is not None:
        xq, sc = quantize_fp8(x, quant_block)
        xp = torch.cat([xq, torch.zeros((1, H), dtype=xq.dtype, device=x.device)])
        sp = torch.cat([sc, torch.ones((1, sc.shape[-1]), dtype=sc.dtype,
                                       device=x.device)])
        return xp[idx], sp[idx]
    xp = torch.cat([x, torch.zeros((1, H), dtype=x.dtype, device=x.device)])
    out = xp[idx]
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out, None


def recv_unpack(recv: torch.Tensor, gmap: torch.Tensor,
                scales: torch.Tensor | None = None, out_dtype=None):
    """recv: [R, H]; gmap: int32 of any shape with sentinel R (empty slot);
    scales: [R, H/block] f32 for an fp8 payload. Returns gmap.shape + (H,),
    dequantized (bf16 by default) when scales are given. Empty slots are
    exactly zero."""
    R, H = recv.shape
    idx = gmap.long()
    pad = torch.zeros((1, H), dtype=recv.dtype, device=recv.device)
    rows = torch.cat([recv, pad])[idx]
    if scales is None:
        return rows if out_dtype is None else rows.to(out_dtype)
    spad = torch.zeros((1, scales.shape[-1]), dtype=scales.dtype,
                       device=scales.device)
    sc = torch.cat([scales, spad])[idx]
    return dequantize_fp8(rows, sc, out_dtype or torch.bfloat16)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """x: [L, A, H] @ w: [L, H, F] -> [L, A, F] in f32, rows >= counts[l]
    zero, cast to x's dtype (bf16 for an fp8 x)."""
    L, A, H = x.shape
    out = torch.einsum("lah,lhf->laf", x.float(), w.float())
    mask = torch.arange(A, device=x.device)[None, :] < counts[:, None]
    out = torch.where(mask[..., None], out, 0.0)
    return out.to(torch.bfloat16 if x.dtype == torch.float8_e4m3fn else x.dtype)
