"""grouped_gemm on Hopper: per-expert x [L, A, H] @ w [L, H, F] with a
ragged row count.

Replaces ``src/repro/kernels/grouped_gemm.py:53 grouped_gemm`` (Pallas,
scalar-prefetched counts, tiles past the count skipped). The bf16 kernel
(``csrc/grouped_gemm.cu``) is warp-specialised for sm_90a: one producer
thread loads 128-byte swizzled tiles by TMA into a ring under mbarriers,
two consumer warpgroups multiply them with ``wgmma`` (the weights read as
stored, through the transpose-B flag), and a persistent grid of lanes walks
tiles of 128 rows x ``bn`` columns. ``plan`` picks the schedule from the
static shape (A, H, F) alone, never from ``counts``:

* **stream** (A <= 128, every decode layout). Bound by the weights' bytes
  (2 x 6144 x 10752 bf16 per projection at DBRX's decode slice, 264 MB):
  one tile covers every row of its expert, so each weight byte is read
  once per call whatever the count; six stages keep 96 KB of weights in
  flight per SM under an evict-first L2 policy. The tiles that fill whole
  waves of the 132 SMs go whole; the k blocks of the rest are laid end to
  end and cut into 132 equal shares (stream-K), so every SM streams the
  same bytes. Which tiles are split, and where, depends on the tile
  count, so on L; a row's bits must not. Every tile's k blocks are cut
  into fixed segments of ``seg`` blocks, each summed from zero and folded
  in k order, whole tile or split. A share may end inside a segment: the
  lane first sums that segment's blocks up to its end and hands the f32
  partial on, and the next lane goes on accumulating the same segment
  from it, which gives the bits of an unbroken sum. A split tile's pieces
  other than the first write each of their segments to a scratch slot;
  the first piece folds its own, then theirs (scratch holds only the rows
  below the count). So the shares stay equal to one k block and a row's
  bits depend on (A, H, F) alone: an EPLB
  placement that gives a rank another slot count changes none of them.
  ``seg`` is the largest divisor of K up to ``SEG_MAX`` (``segment``).
* **compute** (A > 128, HT prefill). Bound by the tensor cores: 128 x 256
  tiles, four stages, every tile whole, walked in bands of eight row tiles
  so that concurrent tiles share their strips of x and w in L2.

A tile whose rows all lie past ``counts[l]`` loads nothing and writes
zeros. f32 operands take a CUDA-core tiled path with exact f32.

Everything here but the launch runs on the CPU too, so the tests hold the
plan (coverage, pieces, TMA boxes and strides) without a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches by this wrapper (chip_smoke reads it)

_DT = (torch.bfloat16, torch.float32)

SMS = 132                  # an H100 SXM's SMs: the lanes of the stream schedule
BM, BK, BOX = 128, 64, 64  # rows per tile, k per stage, TMA box edge (128 B of bf16)
STREAM_MAX_A = 128         # one tile holds every row of an expert up to here
STREAM_BN, COMPUTE_BN = 128, 256
GROUP_M = 8                # row tiles per band of the compute walk
# most k blocks a stream segment (``segment``): of 24, 32 and 64, the one
# that timed least over DBRX's and DeepSeek-V3's decode shapes on an H100
# (tools/grouped_gemm_ab.py --seg-max 32,64,24)
SEG_MAX = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one bf16 call is cut into work (see the module docstring): the
    first ``sk_tiles`` tiles are split over lanes in k, the rest go whole,
    one lane each in turn."""
    schedule: str          # "stream" or "compute"
    bn: int                # columns per tile (128 rows each)
    kb_total: int          # 64-deep k blocks
    m_tiles: int
    n_tiles: int
    group_m: int
    tiles: int             # L * m_tiles * n_tiles
    sk_tiles: int
    sk_per: int            # k blocks of split tiles per lane
    max_pieces: int        # most lanes sharing one split tile
    grid: int              # lanes: blocks of the persistent grid
    x_map: tuple           # TMA map of x: dims (H, A, L), strides (bytes), box
    w_map: tuple           # TMA map of w: dims (F, H, L), strides (bytes), box
    seg: int = 0           # stream: k blocks a segment (0: compute, no segments)

    @property
    def slots(self) -> int:
        """Scratch slots of a split tile: one per segment."""
        return self.kb_total // self.seg if self.seg else 0

    def scratch_floats(self) -> int:
        """f32 segment sums of the split tiles, then one handed-on partial
        a lane (0 without split tiles)."""
        return (self.sk_tiles * self.slots + self.grid) * BM * self.bn if self.sk_tiles else 0

    def flags(self) -> int:
        """int32 counters: one per split tile, then one per lane."""
        return self.sk_tiles + self.grid if self.sk_tiles else 0

    @functools.cached_property
    def c_args(self) -> ctypes.Array:
        """``args`` as the int64 array handed to the C entry (kept, so a
        decode step's calls build it once per shape)."""
        a = self.args()
        return (ctypes.c_int64 * len(a))(*a)

    def args(self) -> list[int]:
        """The int64 plan the C entry reads."""
        return [self.bn, self.kb_total, self.m_tiles, self.n_tiles, self.group_m,
                self.tiles, self.sk_tiles, self.sk_per, self.slots, self.grid,
                int(self.schedule == "stream"), *self.x_map, *self.w_map, self.seg]


@functools.lru_cache(maxsize=64)
def plan(L: int, A: int, H: int, F: int) -> Plan:
    """The schedule of a bf16 call, from its static shape alone.

    stream: the tiles that fill whole waves of the 132 lanes go whole; the
    k blocks of the rest are laid end to end and cut into equal shares of
    the lanes (stream-K), so every SM streams the same bytes; every tile's
    fixed segments are folded in k order. compute: every tile whole."""
    K = -(-H // BK)
    seg = 0
    if A <= STREAM_MAX_A:
        schedule, bn, group_m = "stream", STREAM_BN, 1
        seg = segment(K)
    else:
        schedule, bn, group_m = "compute", COMPUTE_BN, GROUP_M
    m_tiles, n_tiles = -(-A // BM), -(-F // bn)
    tiles = L * m_tiles * n_tiles
    sk_tiles = sk_per = max_pieces = 0
    grid = min(SMS, tiles)
    if schedule == "stream" and K:
        sk_tiles = tiles % SMS if tiles >= SMS else tiles
        if sk_tiles:
            sk_per = -(-sk_tiles * K // SMS)
            if tiles < SMS:
                grid = -(-sk_tiles * K // sk_per)
            max_pieces = max((((t + 1) * K - 1) // sk_per - t * K // sk_per + 1)
                             for t in range(sk_tiles))
    x_map = (H, A, L, H * 2, A * H * 2, BOX, BOX)
    w_map = (F, H, L, F * 2, H * F * 2, BOX, BOX)
    return Plan(schedule, bn, K, m_tiles, n_tiles, group_m, tiles, sk_tiles, sk_per,
                max_pieces, grid, x_map, w_map, seg)


def segment(K: int) -> int:
    """The stream schedule's segment, in k blocks: the largest divisor of K
    up to SEG_MAX. It depends on H alone, never on L, so that a tile's fold
    is the same at every slot count. A longer segment writes fewer sums to
    scratch; a share shorter than a segment waits for the lane before it."""
    return max((d for d in range(1, min(K, SEG_MAX) + 1) if K % d == 0), default=1)


def tile_coords(p: Plan, t: int) -> tuple[int, int, int]:
    """Tile t -> (expert, row tile, column tile), as the kernel's
    ``tile_coords`` maps it: row tiles in bands of ``group_m``, column-major
    inside a band."""
    per_l = p.m_tiles * p.n_tiles
    l, r = divmod(t, per_l)
    band = p.group_m * p.n_tiles
    m_first = (r // band) * p.group_m
    gm = min(p.group_m, p.m_tiles - m_first)
    within = r % band
    return l, m_first + within % gm, within // gm


def lane_work(p: Plan, lane: int) -> list[tuple[int, int, int, int, int]]:
    """The pieces (tile, kb0, kb1, piece, pieces) lane ``lane`` takes, in
    order, as the kernel's ``walk_next`` walks them."""
    K, out = p.kb_total, []
    if p.sk_tiles:
        it, end = lane * p.sk_per, min((lane + 1) * p.sk_per, p.sk_tiles * K)
        while it < end:
            t, kb0 = divmod(it, K)
            kb1 = min(K, kb0 + end - it)
            first, last = t * K // p.sk_per, ((t + 1) * K - 1) // p.sk_per
            out.append((t, kb0, kb1, lane - first, last - first + 1))
            it += kb1 - kb0
    out += [(t, 0, K, 0, 1) for t in range(p.sk_tiles + lane, p.tiles, p.grid)]
    return out


def handoff(p: Plan, lane: int) -> tuple[int, int, int] | None:
    """The k blocks (tile, kb0, kb1) that lane ``lane`` sums first and hands
    on to the next lane, when its share ends inside a segment: from the
    segment's start (or from the share's start, if the share lies inside
    the segment; then it goes on from the previous lane's partial) to the
    share's end. None when the share ends on a segment edge."""
    if not p.sk_tiles:
        return None
    K = p.kb_total
    it, end = lane * p.sk_per, min((lane + 1) * p.sk_per, p.sk_tiles * K)
    if it >= end or end == p.sk_tiles * K or (end % K) % p.seg == 0:
        return None
    t, e = divmod(end, K)
    return t, max(e - e % p.seg, it - t * K), e


def lane_runs(p: Plan, lane: int) -> list[tuple[str, int, int, int, int, int]]:
    """The runs (kind, tile, kb0, kb1, piece, pieces) of lane ``lane`` in the
    order the kernel's ``walk_next`` takes them: its hand-on run first, if
    any ("handoff"), then its pieces ("piece"; the last one without the
    blocks of the hand-on run)."""
    h = handoff(p, lane)
    out = [] if h is None else [("handoff", h[0], h[1], h[2], -1, 0)]
    for t, kb0, kb1, j, n in lane_work(p, lane):
        if h is not None and t == h[0]:   # the lane's last split piece
            kb1 = h[1]
        out.append(("piece", t, kb0, kb1, j, n))
    return out


_sems: dict[tuple[int, int], torch.Tensor] = {}


def _semaphores(dev: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 counters (``Plan.flags``: one per split tile, one per
    lane), kept per (card, stream) so that a call launches nothing but the
    kernel: whoever waits on a counter sets it back to 0 (a tile's first
    piece, the lane a partial is handed to), so the buffer stays zero
    between calls on one stream, and calls on two streams at once never
    share a counter. The buffer is
    made outside any CUDA graph capture (one first made during a capture
    would live in that graph's private pool): a capture must follow an
    uncaptured call on its stream."""
    cuda = dev.type == "cuda"
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream if cuda else None)
    buf = _sems.get(key)
    if buf is None or buf.numel() < n:
        if cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "grouped_gemm: no split-tile counters for this stream yet; run "
                "the captured work once on its stream before capturing it")
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _sems[key] = buf
    return buf


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
    args, scratch, sems = None, None, None
    if x.dtype == torch.bfloat16 and L * A * F > 0:
        p = plan(L, A, H, F)
        args = p.c_args
        if p.sk_tiles:
            scratch = torch.empty(p.scratch_floats(), dtype=torch.float32,
                                  device=x.device)
            sems = _semaphores(x.device, p.flags())
    _build.launch("ep_grouped_gemm", x.data_ptr(), w.data_ptr(),
                  counts.data_ptr(), out.data_ptr(), L, A, H, F, dt,
                  None if args is None else ctypes.addressof(args),
                  None if scratch is None else scratch.data_ptr(),
                  None if sems is None else sems.data_ptr())
    launches += 1
    return out
