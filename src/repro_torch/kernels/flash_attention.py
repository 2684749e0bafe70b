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
only the KV tiles that cross a mask edge test each element. Head widths
64 and 128 have instances of their own; 96 (Phi-3-vision) runs the 128
instance over tensor maps 96 columns wide, whose loads fill the last 32
columns with zeros and whose stores clip them. f32 inputs take a CUDA-core
path in exact f32. It reads q, k and v through their strides, so it needs
no transposes. The backward pair takes 64 and 128 only.

``tile_coords``, ``kv_tiles`` and ``lane_tiles`` mirror the bf16 kernel's
walk, so that the CPU tests can hold it against the reference's masks;
the backward's dQ kernel walks the same tiles, and ``dkv_tile_coords``,
``dkv_lane_tiles`` and ``q_tiles`` mirror its dK/dV kernel's walk.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches by this wrapper (chip_smoke reads it)
window_launches = 0   # those of them with a window

_DT = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 96, 128)   # the forward's; 96 runs the 128 instance over 96-column maps
_BWD_HEAD_DIMS = (64, 128)   # the backward pair's (d 96: ROADMAP A12a-train)

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


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, head_dims: tuple[int, ...], why: str = "") -> int:
    """The shapes, dtype and alignment a kernel takes, its head widths
    ``head_dims``; the dtype code."""
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
    if d not in head_dims:
        raise ValueError(f"{name}: head dim {d} not supported (takes {head_dims}){why}")
    if not _build.aligned16(q, k, v):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be positive, got {window}")
    return dt


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float, window: int | None = None,
                         causal: bool = True, with_lse: bool = False):
    """q [B, Sq, Hq, d], k/v [B, Sk, Hkv, d] on the card, bf16 or f32, d in
    (64, 96, 128); returns [B, Sq, Hq, d], and with ``with_lse`` also each
    row's log-sum-exp [B, Hq, Sq] f32 (what the backward reads). The
    function of ``ref.flash_attention`` (``ref.flash_attention_fwd``) on the
    [B, H, S, d] transposes."""
    global launches, window_launches
    dt = _check("flash_attention", q, k, v, window, _HEAD_DIMS)
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    qs, ks = q.stride(), k.stride()
    # strides by (batch, head, seq), as the C entry takes them
    _build.launch("ep_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, Hq, Hkv, Sq, Sk, d, qs[0], qs[2], qs[1],
                  ks[0], ks[2], ks[1], float(scale), int(window or 0),
                  int(causal), dt, None if lse is None else lse.data_ptr())
    launches += 1
    window_launches += window is not None
    return (out, lse) if with_lse else out


bwd_launches = 0   # launches of the backward's dQ and dK/dV kernels, two a call

# The backward's dQ kernel walks the forward's tiles (``tile_coords``,
# ``kv_tiles``: 128 query rows against KV tiles of 128 keys). Its dK/dV
# kernel takes work tiles of BKEY keys of one (batch, kv head) and walks,
# for each of the G query heads, the query tiles of BQT rows that reach them.
BKEY = 128    # keys per dK/dV work tile: two consumer warpgroups of 64
BQT = 64      # query rows per dK/dV step


def dkv_work_tiles(B: int, Hkv: int, Sk: int) -> int:
    return B * Hkv * -(-Sk // BKEY)


def dkv_tile_coords(B: int, Hkv: int, Sk: int, t: int,
                    causal: bool = True) -> tuple[int, int, int]:
    """dK/dV work tile t -> (batch, kv head, first key), heaviest first:
    under a causal mask the first keys are reached by the most query rows,
    without one the last (a window cuts the rows after a key tile, never
    before it). Heads run fastest."""
    n_tiles = -(-Sk // BKEY)
    nt, bk = t // (B * Hkv), t % (B * Hkv)
    if not causal:
        nt = n_tiles - 1 - nt
    return bk // Hkv, bk % Hkv, nt * BKEY


def dkv_lane_tiles(B: int, Hkv: int, Sk: int, lanes: int = SMS) -> list[list[int]]:
    """The dK/dV work tiles of each lane of its persistent grid, in order."""
    n = dkv_work_tiles(B, Hkv, Sk)
    return [list(range(lane, n, lanes)) for lane in range(min(n, lanes))]


def q_tiles(k0: int, Sq: int, Sk: int, causal: bool = True,
            window: int | None = None) -> list[tuple[int, bool]]:
    """The query tiles of BQT rows that keys [k0, min(k0 + BKEY, Sk)) meet,
    in the dK/dV kernel's order (first first), each with whether it takes
    the per-element mask: the tile pair crosses Sq's or Sk's tail, the
    causal diagonal or the window's far edge. The same for every query
    head of the kv head; tiles with no live pair are left out."""
    k_last = min(k0 + BKEY, Sk) - 1
    nq = -(-Sq // BQT)
    lo = k0 // BQT if causal else 0
    hi = nq - 1
    if window:
        hi = min(hi, (k_last + window - 1) // BQT)
    tiles = []
    for i in range(lo, hi + 1):
        q0, q_end = i * BQT, i * BQT + BQT - 1
        masked = (q_end >= Sq or k0 + BKEY - 1 >= Sk
                  or (causal and k0 + BKEY - 1 > q0)
                  or (bool(window) and q_end - k0 >= window))
        tiles.append((i, masked))
    return tiles


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                        scale: float, window: int | None = None, causal: bool = True):
    """The backward pair on the card (``csrc/flash_attention_bwd.cu``): q, o,
    do [B, Sq, Hq, d] and k, v [B, Sk, Hkv, d], contiguous, bf16 or f32,
    d in (64, 128), lse [B, Hq, Sq] f32 from the forward -> (dq, dk, dv) of the inputs'
    shapes and dtype. Same contract as ``ref.flash_attention_bwd`` on the
    transposes. Two launches: the dQ kernel computes rowsum(do * o) (delta)
    and dq, then the dK/dV kernel reads delta.

    It replaces no TPU kernel: the reference differentiates the plain form
    by AD. At training lengths the pair is bound by the tensor cores (five
    products of 2·d operations per live pair), so the bf16 kernels have the
    forward's shape: persistent grids walking their tiles heaviest first, a
    producer's TMA loads into mbarrier rings, two consumer warpgroups on
    ``wgmma``. dQ takes the forward's tiles (``tile_coords``, ``kv_tiles``):
    S = Q·Kᵀ and dP = dO·Vᵀ from shared memory, dQ += dS·K with dS in
    registers. dK/dV takes 128 keys of a (batch, kv head)
    (``dkv_tile_coords``) and walks the G query heads' tiles of 64 rows
    that reach them (``q_tiles``), on the transposed products Sᵀ = K·Qᵀ,
    dPᵀ = V·dOᵀ, dV += Pᵀ·dO, dK += dSᵀ·Q, so GQA's sum stays in one block
    with no atomics: two calls give the same bits. P and dS are rounded to
    bf16 before their products, where the plain version keeps f32. f32
    inputs take two CUDA-core kernels in exact f32."""
    global bwd_launches
    name = "flash_attention_bwd"
    dt = _check(name, q, k, v, window, _BWD_HEAD_DIMS,
                "; the pair at d 96 waits for ROADMAP A12a-train")
    _build.check_cuda(name, o, do, lse)
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"{name}: o and do must be {q.dtype} {tuple(q.shape)}, got "
                         f"{o.dtype} {tuple(o.shape)} and {do.dtype} {tuple(do.shape)}")
    if not _build.aligned16(o, do):
        raise ValueError(f"{name}: o and do must be 16-byte aligned")
    if lse.dtype != torch.float32 or lse.shape != (B, Hq, Sq):
        raise ValueError(f"{name}: lse must be f32 {(B, Hq, Sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.launch("ep_flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, d,
                  float(scale), int(window or 0), int(causal), dt)
    bwd_launches += 2
    return dq, dk, dv
