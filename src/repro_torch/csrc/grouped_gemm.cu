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
//     shares (stream-K), so every SM streams the same bytes. A split
//     tile's pieces other than the first write f32 partials to scratch and
//     count themselves in; the first piece, last in its lane, waits for the
//     count and adds the partials to its own in piece order, so the sum
//     order depends only on (A, H, F).
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
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include "common.cuh"

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// The same with an L2 cache policy (createpolicy) for the loaded lines.
__device__ __forceinline__ void tma_load_3d_hint(void* dst, const CUtensorMap* map,
                                                 uint64_t* bar, int c0, int c1, int c2,
                                                 uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2), "l"(policy) : "memory");
}

// Shared-memory matrix descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One m64n128k16 product, bf16 in, f32 accumulate: A K-major, B MN-major
// (transpose-B set), both read through shared-memory descriptors.
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// One m64n256k16 product, bf16 in, f32 accumulate: A K-major, B MN-major
// (transpose-B set), both read through shared-memory descriptors.
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n256(d, da, db);
}

// The static shape and the plan (kernels/grouped_gemm.py Plan.args).
struct Shape {
  int A, F;
  int kb_total;            // K: 64-deep k blocks
  int m_tiles, n_tiles;    // 128-row and BN-column tiles of one expert
  int group_m;             // row tiles per band of the walk
  int tiles;               // L * m_tiles * n_tiles
  int sk_tiles, sk_per;    // the first sk_tiles are split: sk_per k blocks a lane
  int max_pieces;          // most pieces of a split tile (its scratch slots)
  int lanes;               // blocks of the persistent grid
  int stream;              // 1: weights read once per call, evicted first
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

// The pieces of work of one lane, in order: first its share of the split
// tiles (k blocks [lane * sk_per, (lane + 1) * sk_per) of the first
// sk_tiles tiles laid end to end; piece j of n of a tile), then whole tiles
// sk_tiles + lane, + lanes, ... kernels/grouped_gemm.py lane_work is the
// same walk.
struct Walk {
  int lane, it, end;  // the lane's k blocks of split tiles not yet taken
  int t;              // its next whole tile
};

__device__ __forceinline__ Walk walk_start(const Shape& s, int lane) {
  Walk w{lane, 0, 0, s.sk_tiles + lane};
  if (s.sk_tiles > 0) {
    w.it = lane * s.sk_per;
    w.end = min(w.it + s.sk_per, s.sk_tiles * s.kb_total);
  }
  return w;
}

__device__ __forceinline__ bool walk_next(const Shape& s, Walk& w, int& t, int& kb0,
                                          int& kb1, int& j, int& n) {
  const int K = s.kb_total;
  if (w.it < w.end) {
    t = w.it / K;
    kb0 = w.it % K;
    kb1 = min(K, kb0 + w.end - w.it);
    const int first = t * K / s.sk_per, last = ((t + 1) * K - 1) / s.sk_per;
    j = w.lane - first;
    n = last - first + 1;
    w.it += kb1 - kb0;
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // warp-uniform by construction, so that wgmma never sits on a path the
  // compiler must treat as divergent (it would serialise them)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  Walk walk = walk_start(s, blockIdx.x);
  int t, kb0, kb1, j, npieces;

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
    while (walk_next(s, walk, t, kb0, kb1, j, npieces)) {
      int l, mt, nt;
      tile_coords(s, t, l, mt, nt);
      const int cnt = min(counts[l], s.A), r0 = mt * BM;
      if (r0 >= cnt || s.kb_total == 0) continue;  // nothing of the tile is loaded
      const int groups = cnt - r0 > 64 ? 2 : 1;
      const uint32_t bytes = groups * BOX_BYTES + C::B_BYTES;
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], bytes);
        uint8_t* sa = smem + stage * C::STAGE_BYTES;
        uint8_t* sb = sa + C::A_BYTES;
        for (int g = 0; g < groups; ++g)
          tma_load_3d(sa + g * BOX_BYTES, &tmx, &full[stage], kb * BK, r0 + 64 * g, l);
#pragma unroll
        for (int c = 0; c < BN / BOX; ++c) {
          if (s.stream)
            tma_load_3d_hint(sb + c * BOX_BYTES, &tmw, &full[stage], nt * BN + c * BOX,
                             kb * BK, l, wpol);
          else
            tma_load_3d(sb + c * BOX_BYTES, &tmw, &full[stage], nt * BN + c * BOX,
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
    while (walk_next(s, walk, t, kb0, kb1, j, npieces)) {
      int l, mt, nt;
      tile_coords(s, t, l, mt, nt);
      const int cnt = __shfl_sync(0xffffffffu, min(counts[l], s.A), 0);
      const int r0 = mt * BM, n0 = nt * BN;
      if (r0 >= cnt || s.kb_total == 0) {  // nothing loaded: zeros, by the first piece
        if (j == 0)
          zero_rows(out, s, l, r0, min(r0 + BM, s.A), n0, min(n0 + BN, s.F),
                    threadIdx.x, CONSUMERS);
        continue;
      }
#pragma unroll
      for (int i = 0; i < C::REGS; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t sa = smem_u32(smem + stage * C::STAGE_BYTES) + wg * BOX_BYTES;
        const uint32_t sb = smem_u32(smem + stage * C::STAGE_BYTES + C::A_BYTES);
        fence_regs<C::REGS>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          // x: 16 k a step is 32 bytes along the swizzled row; 8-row groups
          // 1024 bytes apart. w: 16 k a step is 16 rows of 128 bytes; 64-
          // column boxes BOX_BYTES apart, 8-row groups 1024 bytes apart.
          wgmma_k16<BN>(acc, sw128_desc(sa + kk * 32, 16, 1024),
                        sw128_desc(sb + kk * 16 * 128, BOX_BYTES, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs<C::REGS>(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<C::REGS>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      const bool live = r0 + wg * 64 < cnt;
      if (npieces > 1) {
        // partials in accumulator order, so that each thread reads back
        // what the same thread of another lane wrote
        float* tp = scratch + static_cast<int64_t>(t) * s.max_pieces * (BM * BN) + wg * (64 * BN);
        if (j > 0) {  // write the partial, count it in, go on
          if (live) {
#pragma unroll
            for (int i = 0; i < C::REGS; ++i) __stcg(tp + j * (BM * BN) + i * 128 + t_wg, acc[i]);
          }
          __threadfence();
          consumers_sync();
          if (threadIdx.x == 0) atomicAdd(&sems[t], 1);
          continue;
        }
        // the first piece: wait for the others (earlier in their lanes),
        // add them in piece order, reset the counter for the next call
        if (threadIdx.x == 0) {
          int v;
          do {
            asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(sems + t) : "memory");
          } while (v < npieces - 1);
          sems[t] = 0;
        }
        consumers_sync();
        __threadfence();
        if (live) {
          for (int k = 1; k < npieces; ++k) {
#pragma unroll
            for (int i = 0; i < C::REGS; ++i) acc[i] += __ldcg(tp + k * (BM * BN) + i * 128 + t_wg);
          }
        }
      }
      store_frag<BN>(out, s, acc, l, r0 + wg * 64 + warp * 16 + lane / 4,
                     n0 + (lane % 4) * 2, cnt);
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

// cuTensorMapEncodeTiled lives in libcuda; the runtime's entry-point query
// fetches it, so the library links against nothing beyond cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 map, 128-byte swizzle, zero fill out of range, from the
// wrapper's {dim0, dim1, dim2, stride1 bytes, stride2 bytes, box0, box1}.
bool encode(CUtensorMap* map, const void* base, const int64_t* d) {
  EncodeTiled fn = encoder();
  if (fn == nullptr || d[5] != BOX || d[6] != BOX) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d[0]), static_cast<cuuint64_t>(d[1]),
                              static_cast<cuuint64_t>(d[2])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d[3]), static_cast<cuuint64_t>(d[4])};
  const cuuint32_t box[3] = {BOX, BOX, 1}, one[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
            strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
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
// sk_tiles, sk_per, max_pieces, grid, stream, x map[7], w map[7]} from
// kernels/grouped_gemm.py Plan.args; scratch (f32 partials) and sems (a
// zeroed counter per split tile) when sk_tiles > 0.
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
    s.max_pieces = static_cast<int>(p[8]);
    s.lanes = static_cast<int>(p[9]);
    s.stream = static_cast<int>(p[10]);
    if (s.lanes < 1 || s.group_m < 1 ||
        (s.sk_tiles > 0 && (s.sk_per < 1 || scratch == nullptr || sems == nullptr)))
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
