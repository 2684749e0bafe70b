"""flash_attention on Hopper: causal (optionally sliding-window) GQA
attention for forwards without a KV cache (prefill, training).

Replaces ``src/repro/kernels/flash_attention.py:86 flash_attention`` (Pallas,
KV tiles walked innermost with m, l and the accumulator in VMEM scratch,
fully masked tiles skipped). At prefill lengths it is bound by the tensor
cores. The bf16 kernel (``csrc/flash_attention.cu``) is warp-specialised
for sm_90a: a persistent grid walks work tiles of 128 query rows of one
(batch, query head), heaviest causal tiles first; a producer thread loads Q
and 128-key K/V tiles by TMA from the model's ``[B, S, H, d]`` layout into
an mbarrier ring; two consumer warpgroups of 64 rows multiply on
``wgmma`` (S = Q·Kᵀ from shared memory, O += P·V with P in registers,
rounded to bf16 where the reference keeps it in f32), overlap one tile's
softmax with the next products and ping-pong the tensor cores between them;
only the KV tiles that cross a mask edge test each element. f32 inputs take
a CUDA-core path in exact f32. It reads q, k and v through their strides,
so it needs no transposes.

``tile_coords``, ``kv_tiles`` and ``lane_tiles`` mirror the bf16 kernel's
walk, so that the CPU tests can hold it against the reference's masks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches by this wrapper (chip_smoke reads it)

_DT = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128)

BQ = 128      # query rows per work tile of the bf16 kernel
BKV = 128     # keys per KV tile
SMS = 132     # an H100 SXM's SMs: the kernel launches min(tiles, SMs) lanes


def tile_coords(B: int, Hq: int, Sq: int, t: int,
                causal: bool = True) -> tuple[int, int, int]:
    """Work tile t -> (batch, query head, first row), heaviest first: under
    a causal mask the last query tiles reach the most keys, without one the
    first (a window cuts the keys before a tile, never after it). Heads run
    fastest, so the G heads of one kv head run side by side."""
    m_tiles = -(-Sq // BQ)
    mt, bh = t // (B * Hq), t % (B * Hq)
    if causal:
        mt = m_tiles - 1 - mt
    return bh // Hq, bh % Hq, mt * BQ


def work_tiles(B: int, Hq: int, Sq: int) -> int:
    return B * Hq * -(-Sq // BQ)


def lane_tiles(B: int, Hq: int, Sq: int, lanes: int = SMS) -> list[list[int]]:
    """The work tiles of each lane of the persistent grid, in its order:
    lane i takes tiles i, i + lanes, ..."""
    n = work_tiles(B, Hq, Sq)
    return [list(range(lane, n, lanes)) for lane in range(min(n, lanes))]


def kv_tiles(q0: int, Sq: int, Sk: int, causal: bool = True,
             window: int | None = None) -> list[tuple[int, bool]]:
    """The KV tiles that rows [q0, min(q0 + BQ, Sq)) walk, in the kernel's
    order (last first), each with whether it takes the per-element mask:
    it crosses Sk's tail, the causal diagonal or the window's far edge.
    Tiles that no row reaches are left out (never loaded)."""
    q_last = min(q0 + BQ, Sq) - 1
    nk = -(-Sk // BKV)
    hi = min(nk - 1, q_last // BKV) if causal else nk - 1
    lo = 0
    if window:
        first = q0 - window - BKV + 2     # tile j is reached iff j * BKV >= first
        lo = max(0, -(-first // BKV))
    tiles = []
    for j in range(hi, lo - 1, -1):
        k0, k_last = j * BKV, j * BKV + BKV - 1
        masked = (k_last >= Sk or (causal and k_last > q0)
                  or (bool(window) and q_last - k0 >= window))
        tiles.append((j, masked))
    return tiles


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float, window: int | None = None,
                         causal: bool = True) -> torch.Tensor:
    """q [B, Sq, Hq, d], k/v [B, Sk, Hkv, d] on the card, bf16 or f32, d in
    (64, 128); returns [B, Sq, Hq, d]. The function of
    ``ref.flash_attention`` on the [B, H, S, d] transposes."""
    global launches
    name = "flash_attention"
    _build.check_cuda(name, q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: want 4-d q and k/v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[-1] != d or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    dt = _build.dtype_code(name, q.dtype, _DT)
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported (takes {_HEAD_DIMS})")
    if not _build.aligned16(q, k, v):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be positive, got {window}")
    out = torch.empty_like(q)
    qs, ks = q.stride(), k.stride()
    # strides by (batch, head, seq), as the C entry takes them
    _build.launch("ep_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, Hq, Hkv, Sq, Sk, d, qs[0], qs[2], qs[1],
                  ks[0], ks[2], ks[1], float(scale), int(window or 0),
                  int(causal), dt)
    launches += 1
    return out
