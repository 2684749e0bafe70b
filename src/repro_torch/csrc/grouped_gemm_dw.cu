// grouped_gemm_dw: the weight gradient of grouped_gemm,
// dW[l] = X[l, :n_l]ᵀ · dY[l, :n_l] with n_l = counts[l], f32 sums, written
// in the weights' dtype.
//
// The TPU kernel (src/repro/kernels/grouped_gemm.py:53) has no backward of
// its own: the reference differentiates the plain einsum by AD, whose
// weight cotangent is this product over the live rows (rows past the count
// carry no gradient: the forward zeroes them). Bound by the tensor cores at
// the training shapes (H x F = 6144 x 10752 per expert over thousands of
// rows: 2·n·H·F operations against one read of X and dY and one write of
// dW).
//
// bf16: one warp-specialised kernel for sm_90a on the structure of
// grouped_gemm.cu's compute schedule. A tile is 128 rows of H by 256
// columns of F of one expert, and its depth is the expert's live rows, 64
// a stage. One producer thread loads each stage by TMA (3-D maps over
// [L, A, H] and [L, A, F], 128-byte swizzle, so a load never reaches into
// another expert and rows past A arrive as zeros) into a ring of four
// stages under full/empty mbarriers; two consumer warpgroups each run
// wgmma.mma_async m64n256k16 on 64 rows of H. Both operands are read as
// stored, MN-major: Xᵀ's tile is the [64 rows x 64 H] box through wgmma's
// transpose-A, dY's the [64 rows x 256 F] boxes through transpose-B (B3's
// reading of W). A persistent grid of one block per SM walks the tiles in
// bands of GROUP_M row tiles, column-major inside a band, so that
// concurrent tiles share their strips of X and dY in L2. At the training
// shapes there are thousands of tiles, each tens of stages deep: enough to
// fill the card without splitting k, so every element is summed by one
// block in a fixed order and two calls give the same bits.
// The depth comes from counts on the card; the plan (kernels/grouped_gemm.py
// dw_plan) from the static shape alone. The last stage of a tile whose
// count is not a multiple of 64 holds rows past the count, which lie
// inside the tensor and may hold anything (a NaN there would poison the
// whole expert's sum): the consumers zero those rows of both operands in
// shared memory before its products. An expert with no live row loads
// nothing and writes zeros. The epilogue transposes each quad's
// accumulators with shuffles (grouped_gemm.cu's store_frag) so that every
// lane stores 16 contiguous bytes of a row.
// f32: a 16 x 16 shared-memory tile on the CUDA cores, exact f32 sums; every
// element is summed by one thread in a fixed order.
#include "hopper.cuh"

namespace {

constexpr int BM = 128;           // rows of H per tile: two m64 wgmma row groups
constexpr int BN = 256;           // columns of F per tile
constexpr int BK = 64;            // expert rows per stage: one 128-byte swizzled row of bf16
constexpr int BOX = 64;           // TMA box edge in elements (128 bytes of bf16)
constexpr int BOX_BYTES = BOX * BOX * 2;
constexpr int STAGES = 4;
constexpr int A_BYTES = BK * BM * 2;   // X: two [64 rows x 64 H] boxes
constexpr int B_BYTES = BK * BN * 2;   // dY: four [64 rows x 64 F] boxes
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr int REGS = BN / 2;      // f32 accumulators a thread
constexpr int CONSUMERS = 256;    // two consumer warpgroups, then one producer
constexpr int THREADS = CONSUMERS + 128;

// The static shape and the plan (kernels/grouped_gemm.py DwPlan.args).
struct Shape {
  int A, H, F;
  int m_tiles, n_tiles;  // 128-row (H) and 256-column (F) tiles of one expert
  int group_m;           // row tiles per band of the walk
  int tiles;             // L * m_tiles * n_tiles
  int lanes;             // blocks of the persistent grid
};

// Tile t -> (expert, row tile, column tile): row tiles walked in bands of
// group_m, column-major inside a band. kernels/grouped_gemm.py tile_coords
// is the same map.
__device__ __forceinline__ void tile_coords(const Shape& s, int t, int& l, int& mt, int& nt) {
  const int per_l = s.m_tiles * s.n_tiles;
  l = t / per_l;
  const int r = t % per_l, band = s.group_m * s.n_tiles;
  const int m_first = (r / band) * s.group_m;
  const int gm = min(s.group_m, s.m_tiles - m_first), within = r % band;
  mt = m_first + within % gm;
  nt = within / gm;
}

// Zeros into rows [r0, BOX) of one 64 x 64 box (each row 128 bytes, which
// the swizzle permutes only within), by 128 threads from `tid`.
__device__ __forceinline__ void zero_box_rows(uint8_t* box, int r0, int tid) {
  for (int i = r0 * 8 + tid; i < BOX * 8; i += 128)
    reinterpret_cast<uint4*>(box)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The m64n256 accumulator of one thread to bf16 (grouped_gemm.cu
// store_frag): register 4j + 2h + e holds row rbase + 8h, column cbase +
// 8j + e, where the four lanes q of a quad hold columns 2q, 2q + 1 of each
// 8-column chunk. A 4 x 4 transpose inside the quad (two butterfly rounds
// of shuffles) gives lane q the whole chunk 4m + q of each group of four,
// so every lane stores 16 bytes and a quad 64 contiguous bytes of a row.
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, const Shape& s, const float* acc,
                                           int l, int rbase, int cbase) {
  const int q = threadIdx.x % 4;
  const int c0 = cbase - 2 * q;  // the tile's first column
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
#pragma unroll
    for (int m = 0; m < BN / 32; ++m) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * (4 * m + i) + 2 * h;
        v[i] = pack_bf16x2(acc[k], acc[k + 1]);
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
      if (r < s.H && c < s.F)
        *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(l) * s.H + r) * s.F + c) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
dw_bf16_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmy,
               const int* __restrict__ counts, __nv_bfloat16* __restrict__ dw, const Shape s) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);                // the producer's expect_tx
      mbar_init(&empty[i], CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // warp-uniform by construction, so that wgmma never sits on a path the
  // compiler must treat as divergent (it would serialise them)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 2) {  // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != CONSUMERS) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      int l, mt, nt;
      tile_coords(s, t, l, mt, nt);
      const int kb = (min(max(counts[l], 0), s.A) + BK - 1) / BK;
      for (int k = 0; k < kb; ++k) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], STAGE_BYTES);
        uint8_t* sa = smem + stage * STAGE_BYTES;
        uint8_t* sb = sa + A_BYTES;
#pragma unroll
        for (int g = 0; g < BM / BOX; ++g)
          tma_load_3d(sa + g * BOX_BYTES, &tmx, &full[stage], mt * BM + g * BOX, k * BK, l);
#pragma unroll
        for (int cb = 0; cb < BN / BOX; ++cb)
          tma_load_3d(sb + cb * BOX_BYTES, &tmy, &full[stage], nt * BN + cb * BOX, k * BK, l);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // ---- consumers: warpgroup wg multiplies rows [64 wg, 64 wg + 64) of H
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t_wg = threadIdx.x % 128, warp = t_wg / 32, lane = t_wg % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[REGS];
    for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      int l, mt, nt;
      tile_coords(s, t, l, mt, nt);
      const int n = __shfl_sync(0xffffffffu, min(max(counts[l], 0), s.A), 0);
      const int kb = (n + BK - 1) / BK;
#pragma unroll
      for (int i = 0; i < REGS; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int k = 0; k < kb; ++k) {
        mbar_wait(&full[stage], phase);
        uint8_t* sa = smem + stage * STAGE_BYTES;
        uint8_t* sb = sa + A_BYTES;
        if (k == kb - 1 && n % BK != 0) {
          // rows past the count: each warpgroup zeroes its X box and half
          // of dY's, then both wait, so no product reads a dead row
          const int live_rows = n - k * BK;
          zero_box_rows(sa + wg * BOX_BYTES, live_rows, t_wg);
#pragma unroll
          for (int cb = 0; cb < BN / BOX / 2; ++cb)
            zero_box_rows(sb + (2 * wg + cb) * BOX_BYTES, live_rows, t_wg);
          fence_proxy_async();
          bar_sync(1, CONSUMERS);
        }
        const uint32_t ua = smem_u32(sa) + wg * BOX_BYTES, ub = smem_u32(sb);
        fence_regs<REGS>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          // both MN-major: 16 rows a step are 16 lines of 128 bytes; dY's
          // 64-column boxes BOX_BYTES apart; 8-row groups 1024 bytes apart
          wgmma_ss_n256<1, 1>(acc, sw128_desc(ua + kk * 16 * 128, BOX_BYTES, 1024),
                              sw128_desc(ub + kk * 16 * 128, BOX_BYTES, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs<REGS>(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<REGS>(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      store_tile(dw, s, acc, l, mt * BM + wg * 64 + warp * 16 + lane / 4,
                 nt * BN + (lane % 4) * 2);
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
cudaError_t launch_bf16(const CUtensorMap& tmx, const CUtensorMap& tmy, const int* counts,
                        __nv_bfloat16* dw, const Shape& s, cudaStream_t st) {
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(dw_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    sized[dev] = true;
  }
  dw_bf16_kernel<<<s.lanes, THREADS, SMEM, st>>>(tmx, tmy, counts, dw, s);
  return cudaGetLastError();
}

constexpr int FT = 16;

__global__ void __launch_bounds__(FT * FT)
dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              const int* __restrict__ counts, float* __restrict__ dw, int A, int H, int F) {
  __shared__ float sx[FT][FT + 1], sy[FT][FT + 1];
  const int l = blockIdx.z, ty = threadIdx.x / FT, tx = threadIdx.x % FT;
  const int m0 = blockIdx.y * FT, c = blockIdx.x * FT + tx;
  const int n = min(max(counts[l], 0), A);
  const float* xl = x + static_cast<int64_t>(l) * A * H;
  const float* yl = dy + static_cast<int64_t>(l) * A * F;
  float acc = 0.f;
  for (int a0 = 0; a0 < n; a0 += FT) {
    const int a = a0 + ty;
    sx[ty][tx] = a < n && m0 + tx < H ? xl[static_cast<int64_t>(a) * H + m0 + tx] : 0.f;
    sy[ty][tx] = a < n && c < F ? yl[static_cast<int64_t>(a) * F + c] : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FT; ++k) acc = fmaf(sx[k][ty], sy[k][tx], acc);
    __syncthreads();
  }
  if (m0 + ty < H && c < F) dw[(static_cast<int64_t>(l) * H + m0 + ty) * F + c] = acc;
}

}  // namespace

// x: [L, A, H], dy: [L, A, F], counts: [L] int32, dw: [L, H, F], all of dtype
// dt (BF16 or F32); the wrapper guarantees H % 8 == F % 8 == 0 and 16-byte
// aligned operands. plan (bf16 only): int64 {m_tiles, n_tiles, group_m,
// tiles, grid, x map[7], dy map[7]} from kernels/grouped_gemm.py
// DwPlan.args.
extern "C" int ep_grouped_gemm_dw(const void* x, const void* dy, const void* counts, void* dw,
                                  int L, int A, int H, int F, int dt, const void* plan,
                                  void* stream) {
  if (L <= 0 || H <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  if (dt == BF16) {
    const int64_t* p = static_cast<const int64_t*>(plan);
    if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const Shape s{A, H, F, static_cast<int>(p[0]), static_cast<int>(p[1]),
                  static_cast<int>(p[2]), static_cast<int>(p[3]), static_cast<int>(p[4])};
    if (s.lanes < 1 || s.group_m < 1 || s.tiles != L * s.m_tiles * s.n_tiles)
      return static_cast<int>(cudaErrorInvalidValue);
    // with A = 0 every count is 0: nothing is loaded, and the maps stay empty
    CUtensorMap tmx{}, tmy{};
    if (A > 0 && (!encode(&tmx, x, p + 5) || !encode(&tmy, dy, p + 12)))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_bf16(tmx, tmy, cn, static_cast<__nv_bfloat16*>(dw), s, st));
  }
  if (dt == F32) {
    dw_f32_kernel<<<dim3((F + FT - 1) / FT, (H + FT - 1) / FT, L), FT * FT, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), cn,
        static_cast<float*>(dw), A, H, F);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
