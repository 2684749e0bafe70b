// grouped_gemm: out[l] = x[l] @ w[l] for every local expert l, with f32
// accumulation; rows at or beyond counts[l] come out exactly zero.
//
// Replaces src/repro/kernels/grouped_gemm.py:53 grouped_gemm (the Pallas
// kernel over an (expert, A/bm, F/bn, H/bk) grid with scalar-prefetched
// counts).
//
// bf16: one warp-specialised kernel for sm_90a. A tile is 128 rows x BN
// columns of one expert. One producer thread loads its 64-deep k blocks by
// TMA (3-D maps over [L, A, H] and [L, H, F], so a load never reaches into
// another expert's rows, and rows past A, the H tail and the F tail arrive
// as zeros) into a ring of stages under full/empty mbarriers; two consumer
// warpgroups each run wgmma.mma_async on one m64 row group, x K-major and
// the weights read as stored, MN-major through wgmma's transpose-B flag,
// both 128-byte swizzled. A persistent grid of lanes walks the tiles, so
// the producer loads the next tile while the consumers write the last.
// kernels/grouped_gemm.py plan picks one of two schedules from the static
// shape (A, H, F) alone, never from counts:
//   * stream, A <= 128 (every decode layout): bound by the weights' bytes.
//     One tile covers every row of its expert, so each weight byte is read
//     once per call whatever the count; BN = 128 with six stages keeps
//     96 KB of weights in flight per SM, loaded with an evict-first L2
//     policy. The tiles that fill whole waves of 132 lanes go whole; the
//     k blocks of the rest are laid end to end and cut into 132 equal
//     shares (stream-K), so every SM streams the same bytes. Which tiles
//     are split, and where, depends on the tile count, so on L; a row's
//     sum must not. Every tile's k blocks are cut into fixed segments of
//     seg blocks (a divisor of K), each summed from zero, and the segments
//     are folded in k order, whole tile or split. A share that ends inside
//     a segment first sums that segment's blocks up to its end and hands
//     the f32 partial to the next lane, which goes on accumulating the
//     segment from it after its own whole segments: wgmma adds into the
//     same f32 registers either way, so the bits are those of an unbroken
//     sum. A split tile's pieces other than the first write each of their
//     segments to its own scratch slot and count themselves in; the first
//     piece, last in its lane, folds its own segments, waits for the count
//     and folds the others' after them. A row's bits thus depend only on
//     (A, H, F): a placement that changes the slots a rank holds changes
//     no row, and the shares stay equal to one k block.
//   * compute, A > 128 (HT prefill): bound by the tensor cores. 128 x 256
//     tiles, four stages, every tile whole, walked in bands of eight row
//     tiles so that concurrent tiles share their strips of x and w in L2.
// A tile whose rows all lie past counts[l] loads nothing and writes zeros;
// a row group wholly past the count is not loaded (its wgmma multiplies
// whatever the stage holds, and its rows are written as zeros). A row's
// result does not depend on its position, on counts or on the other rows.
// The epilogue transposes each quad's accumulators with shuffles so that
// every lane stores 16 contiguous bytes of a row (the fragment layout alone
// gives 4-byte stores, half-filled sectors and four times the store
// instructions, while the tensor cores wait for the next tile).
//
// f32: a plain shared-memory tiled product on the CUDA cores (64x64 tile,
// 4x4 outputs per thread), exact f32 as the reference requires.
#include "hopper.cuh"

namespace {

constexpr int BM = 128;           // rows per tile: two m64 wgmma row groups
constexpr int BK = 64;            // k per stage: one 128-byte swizzled row of bf16
constexpr int BOX = 64;           // TMA box edge in elements (128 bytes of bf16)
constexpr int BOX_BYTES = BOX * BOX * 2;
constexpr int CONSUMERS = 256;    // two consumer warpgroups, then one producer
constexpr int THREADS = CONSUMERS + 128;

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 128 ? 6 : 4;
  static constexpr int A_BYTES = BM * BK * 2;          // two 64-row boxes
  static constexpr int B_BYTES = BK * BN * 2;          // BN / 64 boxes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
  static constexpr int REGS = BN / 2;                  // f32 accumulators a thread
};

template <int BN>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_ss_n128<1>(d, da, db, 1);
  else wgmma_ss_n256<1>(d, da, db, 1);
}

// The static shape and the plan (kernels/grouped_gemm.py Plan.args).
struct Shape {
  int A, F;
  int kb_total;            // K: 64-deep k blocks
  int m_tiles, n_tiles;    // 128-row and BN-column tiles of one expert
  int group_m;             // row tiles per band of the walk
  int tiles;               // L * m_tiles * n_tiles
  int sk_tiles, sk_per;    // the first sk_tiles are split: sk_per k blocks a lane
  int slots;               // scratch slots of a split tile: its segments
  int lanes;               // blocks of the persistent grid
  int stream;              // 1: weights read once per call, evicted first
  int seg;                 // stream: k blocks a segment (a divisor of kb_total)
};

// Tile t -> (expert, row tile, column tile): row tiles walked in bands of
// group_m, column-major inside a band. kernels/grouped_gemm.py tile_coords
// is the same map.
__device__ __forceinline__ void tile_coords(const Shape& s, int t, int& l, int& mt,
                                            int& nt) {
  const int per_l = s.m_tiles * s.n_tiles;
  l = t / per_l;
  const int r = t % per_l, band = s.group_m * s.n_tiles;
  const int m_first = (r / band) * s.group_m;
  const int gm = min(s.group_m, s.m_tiles - m_first), within = r % band;
  mt = m_first + within % gm;
  nt = within / gm;
}

// The runs of work of one lane, in order: first, when its share of the
// split tiles ends inside a segment, the hand-on run (that segment's blocks
// up to the share's end, from the segment's start or, when the share lies
// inside the segment, from the share's start); then its share of the split
// tiles (k blocks [lane * sk_per, (lane + 1) * sk_per) of the first
// sk_tiles tiles laid end to end; piece j of n of a tile, the last without
// the hand-on run's blocks), then whole tiles sk_tiles + lane, + lanes, ...
// kernels/grouped_gemm.py lane_runs is the same walk.
struct Walk {
  int lane, it, end;  // the lane's k blocks of split tiles not yet taken
  int t;              // its next whole tile
  int ht, h0, h1;     // the hand-on run: tile (-1: none), k blocks [h0, h1)
  bool pending;       // the hand-on run is still to come
};

__device__ __forceinline__ Walk walk_start(const Shape& s, int lane) {
  Walk w{lane, 0, 0, s.sk_tiles + lane, -1, 0, 0, false};
  if (s.sk_tiles > 0) {
    const int K = s.kb_total, total = s.sk_tiles * K;
    w.it = lane * s.sk_per;
    w.end = min(w.it + s.sk_per, total);
    if (w.it < w.end && w.end < total && (w.end % K) % s.seg != 0) {
      const int e = w.end % K;
      w.ht = w.end / K;
      w.h0 = max(e - e % s.seg, w.it - w.ht * K);
      w.h1 = e;
      w.pending = true;
    }
  }
  return w;
}

__device__ __forceinline__ bool walk_next(const Shape& s, Walk& w, bool& hand, int& t,
                                          int& kb0, int& kb1, int& j, int& n) {
  const int K = s.kb_total;
  hand = w.pending;
  if (hand) {
    w.pending = false;
    t = w.ht;
    kb0 = w.h0;
    kb1 = w.h1;
    j = -1;
    n = 0;
    return true;
  }
  if (w.it < w.end) {
    t = w.it / K;
    kb0 = w.it % K;
    kb1 = min(K, kb0 + w.end - w.it);
    const int first = t * K / s.sk_per, last = ((t + 1) * K - 1) / s.sk_per;
    j = w.lane - first;
    n = last - first + 1;
    w.it += kb1 - kb0;
    if (t == w.ht) kb1 = w.h0;  // its last blocks went in the hand-on run
    return true;
  }
  if (w.t >= s.tiles) return false;
  t = w.t;
  kb0 = 0;
  kb1 = K;
  j = 0;
  n = 1;
  w.t += s.lanes;
  return true;
}

// Zeros into rows [r0, r1) and columns [c0, c1) of expert l's output, by
// `n` threads from `tid`; c0 and c1 are multiples of 8.
__device__ void zero_rows(__nv_bfloat16* out, const Shape& s, int l, int r0, int r1,
                          int c0, int c1, int tid, int n) {
  const int cw = (c1 - c0) / 8;
  for (int i = tid; i < (r1 - r0) * cw; i += n) {
    const int r = r0 + i / cw, c = c0 + (i % cw) * 8;
    *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(l) * s.A + r) * s.F + c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// The m64nBN accumulator of one thread to bf16: register 4j + 2h + e holds
// row rbase + 8h, column cbase + 8j + e, where the four lanes q of a quad
// hold columns 2q, 2q + 1 of each 8-column chunk. A 4 x 4 transpose inside
// the quad (two butterfly rounds of shuffles) gives lane q the whole chunk
// 4m + q of each group of four, so every lane stores 16 bytes and a quad 64
// contiguous bytes of a row. Rows at or past the count get exact zeros.
template <int BN>
__device__ __forceinline__ void store_frag(__nv_bfloat16* out, const Shape& s,
                                           const float* acc, int l, int rbase,
                                           int cbase, int cnt) {
  const int q = threadIdx.x % 4;
  const int c0 = cbase - 2 * q;  // the tile's first column
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
    const bool keep = r < cnt;
#pragma unroll
    for (int m = 0; m < BN / 32; ++m) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * (4 * m + i) + 2 * h;
        v[i] = keep ? pack_bf16x2(acc[k], acc[k + 1]) : 0u;
      }
      // round 1 swaps bit 0 of lane and element, round 2 bit 1
      {
        const bool odd = q & 1;
        const uint32_t a = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
        const uint32_t b = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
        if (odd) { v[0] = a; v[2] = b; } else { v[1] = a; v[3] = b; }
      }
      {
        const bool hi = q & 2;
        const uint32_t a = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
        const uint32_t b = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
        if (hi) { v[0] = a; v[1] = b; } else { v[2] = a; v[3] = b; }
      }
      const int c = c0 + 8 * (4 * m + q);
      if (r < s.A && c < s.F)
        *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(l) * s.A + r) * s.F + c) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ void consumers_sync() { bar_sync(1, CONSUMERS); }

// Accumulator registers to and from a scratch slot, in accumulator order, so
// that each thread reads back what the same thread of another lane wrote.
// Register 4j + 2h + e holds row rbase + 8h; rows at or past the count are
// not written, nor read back into a fold (what their registers hold is
// never stored). A partial taken up by wgmma is read whole, so that no
// accumulator is written on a path that depends on the thread.
// The base address as an opaque value where it is used: otherwise the
// compiler keeps an address per register live across the whole walk.
__device__ __forceinline__ float* here(const float* p) {
  asm volatile("" : "+l"(p));
  return const_cast<float*>(p);
}

template <int R>
__device__ __forceinline__ void slot_store(float* p, const float* r, int t_wg, int rbase,
                                           int cnt) {
  p = here(p) + t_wg;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (rbase + 8 * ((i >> 1) & 1) < cnt) __stcg(p + i * 128, r[i]);
}

template <int R>
__device__ __forceinline__ void slot_add(float* r, const float* p, int t_wg, int rbase,
                                         int cnt) {
  p = here(p) + t_wg;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (rbase + 8 * ((i >> 1) & 1) < cnt) r[i] += __ldcg(p + i * 128);
}

template <int R>
__device__ __forceinline__ void slot_take(float* r, const float* p, int t_wg) {
  p = here(p) + t_wg;
#pragma unroll
  for (int i = 0; i < R; ++i) r[i] = __ldcg(p + i * 128);
}

// One consumer thread waits until *c reaches v (acquire) and sets it back
// to 0 for the next call; then every consumer may read what was written
// before it was counted. A wait past 2^36 cycles (about half a minute)
// traps, so that a broken walk fails the launch instead of hanging the card.
__device__ __forceinline__ void await_take(int* c, int v) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    int x;
    do {
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(x) : "l"(c) : "memory");
      if (clock64() - t0 > (1LL << 36)) __trap();
    } while (x < v);
    *c = 0;
  }
  consumers_sync();
  __threadfence();
}

// Counts one in at *c once every consumer's writes are visible.
__device__ __forceinline__ void count_in(int* c) {
  __threadfence();
  consumers_sync();
  if (threadIdx.x == 0) atomicAdd(c, 1);
}

// The consumers' multiply of k blocks [k0, k1) of the current tile from the
// ring, one segment at a time (without segments, compute: one run straight
// into acc). A segment is accumulated in seg, from zero where it starts or
// from what seg holds where the run starts inside it; every segment ends on
// a full wgmma wait, and one that is complete is folded into acc (slot
// null) or written to its scratch slot (slot + its index). The waits sit on
// no branch a thread could take alone, so that the compiler never
// serialises the wgmmas (it does, too, when a wgmma's scale-d is chosen at
// run time while seg may have been loaded from scratch).
template <int BN>
__device__ __forceinline__ void mma_blocks(const Shape& s, uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, int& stage, uint32_t& phase,
                                           int wg, int lane, int k0, int k1, float* acc,
                                           float* seg, float* slot, int t_wg, int rbase,
                                           int cnt) {
  using C = Cfg<BN>;
  constexpr bool SEGMENTED = BN == 128;
  float* mma = SEGMENTED ? seg : acc;
  for (int a = k0; a < k1;) {
    const int b = SEGMENTED ? min(k1, (a / s.seg + 1) * s.seg) : k1;
    if (SEGMENTED && a % s.seg == 0) {  // a segment starts
#pragma unroll
      for (int i = 0; i < C::REGS; ++i) seg[i] = 0.f;
    }
    int prev = -1;
    for (int kb = a; kb < b; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint32_t sa = smem_u32(smem + stage * C::STAGE_BYTES) + wg * BOX_BYTES;
      const uint32_t sb = smem_u32(smem + stage * C::STAGE_BYTES + C::A_BYTES);
      fence_regs<C::REGS>(mma);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // x: 16 k a step is 32 bytes along the swizzled row; 8-row groups
        // 1024 bytes apart. w: 16 k a step is 16 rows of 128 bytes; 64-
        // column boxes BOX_BYTES apart, 8-row groups 1024 bytes apart.
        wgmma_k16<BN>(mma, sw128_desc(sa + kk * 32, 16, 1024),
                      sw128_desc(sb + kk * 16 * 128, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_regs<C::REGS>(mma);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs<C::REGS>(mma);
    if (lane == 0) mbar_arrive(&empty[prev]);
    if constexpr (SEGMENTED) {
      if (b % s.seg == 0) {  // a whole segment
        if (slot != nullptr) {
          slot_store<C::REGS>(slot + (a / s.seg) * (BM * BN), seg, t_wg, rbase, cnt);
        } else {
#pragma unroll
          for (int i = 0; i < C::REGS; ++i) acc[i] += seg[i];
        }
      }
    }
    a = b;
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_bf16_kernel(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw,
                         const int* __restrict__ counts,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ scratch, int* __restrict__ sems,
                         const Shape s) {
  using C = Cfg<BN>;
  // stream (BN 128, the only split schedule) folds its fixed segments;
  // compute (BN 256) accumulates a tile whole
  constexpr bool SEGMENTED = BN == 128;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], 1);                // the producer's expect_tx
      mbar_init(&empty[i], CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // warp-uniform by construction, so that wgmma never sits on a path the
  // compiler must treat as divergent (it would serialise them)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  Walk walk = walk_start(s, blockIdx.x);
  int t, kb0, kb1, j, npieces;
  bool hand;

  if (wg == 2) {  // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != CONSUMERS) return;
    // weights read once per call (stream) need not stay in L2; at HT shapes
    // any policy measured slower than none
    uint64_t wpol = 0;
    if (s.stream)
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(wpol));
    int stage = 0;
    uint32_t phase = 0;
    while (walk_next(s, walk, hand, t, kb0, kb1, j, npieces)) {
      int l, mt, nt;
      tile_coords(s, t, l, mt, nt);
      const int cnt = min(counts[l], s.A), r0 = mt * BM;
      if (r0 >= cnt || s.kb_total == 0) continue;  // nothing of the tile is loaded
      const int groups = cnt - r0 > 64 ? 2 : 1;
      const uint32_t bytes = groups * BOX_BYTES + C::B_BYTES;
      // a later piece: its whole segments, then the blocks before its first
      // segment edge (the consumers' order)
      const int c = SEGMENTED && !hand && j > 0 ? (kb0 + s.seg - 1) / s.seg * s.seg : kb0;
      for (int i = 0; i < kb1 - kb0; ++i) {
        const int kb = c + i < kb1 ? c + i : kb0 + (c + i - kb1);
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], bytes);
        uint8_t* sa = smem + stage * C::STAGE_BYTES;
        uint8_t* sb = sa + C::A_BYTES;
        for (int g = 0; g < groups; ++g)
          tma_load_3d(sa + g * BOX_BYTES, &tmx, &full[stage], kb * BK, r0 + 64 * g, l);
#pragma unroll
        for (int cb = 0; cb < BN / BOX; ++cb) {
          if (s.stream)
            tma_load_3d_hint(sb + cb * BOX_BYTES, &tmw, &full[stage], nt * BN + cb * BOX,
                             kb * BK, l, wpol);
          else
            tma_load_3d(sb + cb * BOX_BYTES, &tmw, &full[stage], nt * BN + cb * BOX,
                        kb * BK, l);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // ---- consumers: warpgroup wg multiplies rows [64 wg, 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t_wg = threadIdx.x % 128, warp = t_wg / 32, lane = t_wg % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[C::REGS];
    // stream: the segment being multiplied; acc folds the segments in order
    float seg[SEGMENTED ? C::REGS : 1];
    while (walk_next(s, walk, hand, t, kb0, kb1, j, npieces)) {
      int l, mt, nt;
      tile_coords(s, t, l, mt, nt);
      const int cnt = __shfl_sync(0xffffffffu, min(counts[l], s.A), 0);
      const int r0 = mt * BM, n0 = nt * BN;
      if (r0 >= cnt || s.kb_total == 0) {  // nothing loaded: zeros, by the first piece
        if (!hand && j == 0)
          zero_rows(out, s, l, r0, min(r0 + BM, s.A), n0, min(n0 + BN, s.F),
                    threadIdx.x, CONSUMERS);
        continue;
      }
      const int rbase = r0 + wg * 64 + warp * 16 + lane / 4;
      // scratch: each split tile's segment slots, then each lane's handed-on
      // partial; sems: each split tile's count, then each lane's flag
      const int64_t tile_f = BM * BN;
      float* slots = scratch + static_cast<int64_t>(t) * s.slots * tile_f + wg * (64 * BN);
      float* hand_out = scratch + (static_cast<int64_t>(s.sk_tiles) * s.slots + blockIdx.x) *
                        tile_f + wg * (64 * BN);
      int* flag = sems + s.sk_tiles + blockIdx.x;
      // up to two runs: [kb0, kb1) (a hand-on run, a whole tile, a first
      // piece), or a later piece's whole segments [c, kb1) then [kb0, c)
      const bool later = SEGMENTED && !hand && j > 0;
      const int c = later && kb1 > kb0 ? (kb0 + s.seg - 1) / s.seg * s.seg : kb0;
      if (!later) {
#pragma unroll
        for (int i = 0; i < C::REGS; ++i) acc[i] = 0.f;
      }
      for (int run = 0; run < 2; ++run) {
        const int a = run == 0 ? c : kb0, b = run == 0 ? kb1 : c;
        if (a >= b) continue;
        if (SEGMENTED && a % s.seg != 0) {  // go on from the lane before's partial
          await_take(flag - 1, 1);
          slot_take<C::REGS>(seg, hand_out - tile_f, t_wg);
        }
        mma_blocks<BN>(s, smem, full, empty, stage, phase, wg, lane, a, b, acc, seg,
                       later ? slots : nullptr, t_wg, rbase, cnt);
      }
      if constexpr (SEGMENTED) {
        if (hand) {  // hand the partial on
          slot_store<C::REGS>(hand_out, seg, t_wg, rbase, cnt);
          count_in(flag);
          continue;
        }
        if (later) {  // its segments are written: count it in
          count_in(sems + t);
          continue;
        }
        if (npieces > 1) {  // a first piece: then the others' segments, in order
          await_take(sems + t, npieces - 1);
          for (int k = kb1 / s.seg; k < s.slots; ++k)
            slot_add<C::REGS>(acc, slots + k * tile_f, t_wg, rbase, cnt);
        }
      }
      store_frag<BN>(out, s, acc, l, rbase, n0 + (lane % 4) * 2, cnt);
    }
  }
}

constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(256)
grouped_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const int* __restrict__ counts, float* __restrict__ out,
                        int A, int H, int F) {
  const int l = blockIdx.z, m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int cnt = min(counts[l], A);
  const float* xl = x + static_cast<int64_t>(l) * A * H;
  const float* wl = w + static_cast<int64_t>(l) * H * F;
  float* ol = out + static_cast<int64_t>(l) * A * F;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (m0 >= cnt) {
    for (int i = tid; i < FBM * FBN; i += 256) {
      const int r = m0 + i / FBN, c = n0 + i % FBN;
      if (r < A && c < F) ol[static_cast<int64_t>(r) * F + c] = 0.f;
    }
    return;
  }
  __shared__ float As[FBK][FBM + 4];  // x tile, transposed
  __shared__ float Bs[FBK][FBN + 4];
  float acc[4][4] = {};
  for (int k0 = 0; k0 < H; k0 += FBK) {
    for (int i = tid; i < FBM * FBK; i += 256) {
      const int r = i / FBK, c = i % FBK;
      As[c][r] = (m0 + r < cnt && k0 + c < H)
          ? xl[static_cast<int64_t>(m0 + r) * H + k0 + c] : 0.f;
    }
    for (int i = tid; i < FBK * FBN; i += 256) {
      const int r = i / FBN, c = i % FBN;
      Bs[r][c] = (k0 + r < H && n0 + c < F)
          ? wl[static_cast<int64_t>(k0 + r) * F + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= A) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < F) ol[static_cast<int64_t>(r) * F + c] = r < cnt ? acc[i][j] : 0.f;
    }
  }
}

// A 3-D bf16 map (hopper.cuh encode_bf16) from the wrapper's {dim0, dim1,
// dim2, stride1 bytes, stride2 bytes, box0, box1}.
bool encode(CUtensorMap* map, const void* base, const int64_t* d) {
  if (d[5] != BOX || d[6] != BOX) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d[0]), static_cast<cuuint64_t>(d[1]),
                              static_cast<cuuint64_t>(d[2])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d[3]), static_cast<cuuint64_t>(d[4])};
  const cuuint32_t box[3] = {BOX, BOX, 1};
  return encode_bf16(map, 3, base, dims, strides, box);
}

constexpr int MAX_DEVICES = 64;

// The shared-memory limit is raised once per device before the first launch.
template <int BN>
cudaError_t launch_bf16(const CUtensorMap& tmx, const CUtensorMap& tmw, const int* counts,
                        __nv_bfloat16* out, float* scratch, int* sems, const Shape& s,
                        cudaStream_t st) {
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(grouped_gemm_bf16_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
    if (e != cudaSuccess) return e;
    sized[dev] = true;
  }
  grouped_gemm_bf16_kernel<BN><<<s.lanes, THREADS, Cfg<BN>::SMEM, st>>>(
      tmx, tmw, counts, out, scratch, sems, s);
  return cudaGetLastError();
}

}  // namespace

// plan (bf16 only): int64 {bn, kb_total, m_tiles, n_tiles, group_m, tiles,
// sk_tiles, sk_per, slots, grid, stream, x map[7], w map[7], seg} from
// kernels/grouped_gemm.py Plan.args; scratch (f32 segment sums and handed-on
// partials, Plan.scratch_floats) and sems (Plan.flags zeroed counters) when
// sk_tiles > 0.
extern "C" int ep_grouped_gemm(const void* x, const void* w, const void* counts,
                               void* out, int L, int A, int H, int F, int dt,
                               const void* plan, void* scratch, void* sems,
                               void* stream) {
  if (L <= 0 || A <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == BF16) {
    const int64_t* p = static_cast<const int64_t*>(plan);
    if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    Shape s{A, F};
    s.kb_total = static_cast<int>(p[1]);
    s.m_tiles = static_cast<int>(p[2]);
    s.n_tiles = static_cast<int>(p[3]);
    s.group_m = static_cast<int>(p[4]);
    s.tiles = static_cast<int>(p[5]);
    s.sk_tiles = static_cast<int>(p[6]);
    s.sk_per = static_cast<int>(p[7]);
    s.slots = static_cast<int>(p[8]);
    s.lanes = static_cast<int>(p[9]);
    s.stream = static_cast<int>(p[10]);
    s.seg = static_cast<int>(p[25]);
    if (s.lanes < 1 || s.group_m < 1 ||
        (p[0] == 128 && (s.seg < 1 || s.kb_total % s.seg != 0)) ||
        (s.sk_tiles > 0 && (s.sk_per < 1 || s.slots != s.kb_total / s.seg ||
                            scratch == nullptr || sems == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tmx{}, tmw{};
    if (H > 0 && (!encode(&tmx, x, p + 11) || !encode(&tmw, w, p + 18)))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto* c = static_cast<const int*>(counts);
    auto* o = static_cast<__nv_bfloat16*>(out);
    auto* sc = static_cast<float*>(scratch);
    auto* se = static_cast<int*>(sems);
    cudaError_t e = cudaErrorInvalidValue;
    if (p[0] == 128) e = launch_bf16<128>(tmx, tmw, c, o, sc, se, s, st);
    if (p[0] == 256) e = launch_bf16<256>(tmx, tmw, c, o, sc, se, s, st);
    return static_cast<int>(e);
  }
  if (dt == F32) {
    dim3 grid((F + FBN - 1) / FBN, (A + FBM - 1) / FBM, L);
    grouped_gemm_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(counts), static_cast<float*>(out), A, H, F);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
