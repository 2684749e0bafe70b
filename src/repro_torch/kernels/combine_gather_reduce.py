"""combine_gather_reduce on Hopper: gather K rows per token and reduce them
under the gate weights, without a [T, K, H] buffer.

Replaces ``src/repro/kernels/combine_gather_reduce.py:44
combine_gather_reduce`` (Pallas, k as the innermost sequential grid axis).
Bound on the H100 by bytes: K row reads and one row write per token; at the
DBRX decode slice 16 tokens gather 4 rows of 6144 bf16 each. The kernel
(``csrc/combine_gather_reduce.cu``, on the reduce it shares with
``combine_reduce``, ``csrc/reduce.cuh``) runs blocks of 64 threads over (token,
tile of 64 16-byte pieces), so the decode call has more blocks than the
card has SMs; each thread reads its token's K indices and weights once,
issues the loads of all its rows (up to 8 at a time) before the first FMA,
sums in f32 over k = 0..K-1 in that fixed order and casts once, so results
do not vary from run to run. A sentinel row is not loaded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches by this wrapper (chip_smoke reads it)

_IN = (torch.float32, torch.bfloat16, torch.float16)


def combine_gather_reduce(recv: torch.Tensor, rows: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """recv: [R, H]; rows: [T, K] int32 with sentinel R; w: [T, K] f32, all
    on the card. Same contract as ``ref.combine_gather_reduce``."""
    global launches
    name = "combine_gather_reduce"
    _build.check_cuda(name, recv, rows, w)
    if recv.dim() != 2 or rows.dim() != 2 or rows.dtype != torch.int32:
        raise ValueError(f"{name}: want recv [R, H] and int32 rows [T, K], got "
                         f"{tuple(recv.shape)} and {rows.dtype} {tuple(rows.shape)}")
    if w.dtype != torch.float32 or w.shape != rows.shape:
        raise ValueError(f"{name}: weights must be f32 {tuple(rows.shape)}, got "
                         f"{w.dtype} {tuple(w.shape)}")
    rdt = _build.dtype_code(name, recv.dtype, _IN)
    R, H = recv.shape
    T, K = rows.shape
    if H % 8 or not _build.aligned16(recv):
        raise ValueError(f"{name}: hidden {H} must be a multiple of 8 with "
                         "16-byte aligned rows")
    out = torch.empty((T, H), dtype=recv.dtype, device=recv.device)
    _build.launch("ep_combine_gather_reduce", recv.data_ptr(), rows.data_ptr(),
                  w.data_ptr(), out.data_ptr(), T, R, H, K, rdt)
    launches += 1
    return out


bwd_launches = 0   # launches of combine_gather_reduce_bwd (chip_smoke reads it)


def combine_gather_reduce_bwd(recv: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
                              dout: torch.Tensor):
    """The backward of ``combine_gather_reduce`` on the card
    (``csrc/combine_gather_reduce_bwd.cu``): recv [R, H], rows [T, K] int32
    with sentinel R (each valid row named once), w [T, K] f32, dout [T, H]
    of recv's dtype -> (d_recv [R, H], d_w [T, K] f32). One block a token
    stores w · dout into each of its rows and sums each row's products with
    dout in f32; rows no (t, k) names are zero. Same contract as
    ``ref.combine_gather_reduce_bwd``."""
    global bwd_launches
    name = "combine_gather_reduce_bwd"
    _build.check_cuda(name, recv, rows, w, dout)
    if recv.dim() != 2 or rows.dim() != 2 or rows.dtype != torch.int32:
        raise ValueError(f"{name}: want recv [R, H] and int32 rows [T, K], got "
                         f"{tuple(recv.shape)} and {rows.dtype} {tuple(rows.shape)}")
    if w.dtype != torch.float32 or w.shape != rows.shape:
        raise ValueError(f"{name}: weights must be f32 {tuple(rows.shape)}, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if dout.dtype != recv.dtype or dout.shape != (rows.shape[0], recv.shape[1]):
        raise ValueError(f"{name}: dout must be {recv.dtype} "
                         f"{(rows.shape[0], recv.shape[1])}, got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    rdt = _build.dtype_code(name, recv.dtype, _IN)
    R, H = recv.shape
    T, K = rows.shape
    if K > 8:
        raise ValueError(f"{name}: at most 8 rows a token, got {K}")
    if H % 8 or not _build.aligned16(recv, dout):
        raise ValueError(f"{name}: hidden {H} must be a multiple of 8 with "
                         "16-byte aligned rows")
    d_recv = torch.zeros_like(recv)
    d_w = torch.empty((T, K), dtype=torch.float32, device=recv.device)
    _build.launch("ep_combine_gather_reduce_bwd", recv.data_ptr(), rows.data_ptr(),
                  w.data_ptr(), dout.data_ptr(), d_recv.data_ptr(), d_w.data_ptr(),
                  T, R, H, K, rdt)
    bwd_launches += 1
    return d_recv, d_w
