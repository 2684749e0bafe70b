// The block fp8 e4m3 quantizer that dispatch_pack's quant mode (B1) and
// quantize_fp8 (B5) share: row r of the output is row src(r) of x, cut into
// blocks of qb elements, each block's scale = amax / 448 by true division (1
// for an all-zero block), each value divided by its scale and rounded to
// e4m3 with satfinite. The two differ only in where a row's source comes
// from and how a row is walked (MapRows, SameRows below), a template
// parameter, so each compiles its own copy of the same code with nothing of
// the other's in it. The kernels sit in an anonymous namespace, as in
// gather.cuh.
//
// - qb = 8 * 2^k (k <= 7) with a 16-byte aligned x: a persistent grid walks
//   the rows, reading the next row's source ahead. A block belongs to a
//   group of min(qb / 8, 32) lanes that hold all of it in registers (8
//   values a lane per 16-byte load, so at qb = 128 a warp quantizes two
//   blocks and no lane idles): one read for both the amax and the rounding,
//   8 bytes stored a lane.
// - Any other block width, or a source off 16-byte alignment: one block per
//   row, one warp per quant block (common.cuh quant_block_warp).
//
// Both compute the same function, exactly: a max, one division and one
// rounding per element.
#pragma once

#include "common.cuh"

namespace {

constexpr int QUANT_THREADS = 256;
constexpr int QUANT_WARPS = QUANT_THREADS / 32;
constexpr int SCALE_SMEM = 4096;      // floats of a row's scales staged in shared memory
constexpr int MAX_DEVICES = 64;

// Each row source also says how the kernel walks a row. B1 gathers rows
// through a map: four rounds of a warp's blocks are loaded before the first
// is reduced, and a row's scales are staged in shared memory and stored 16
// bytes at a time. B5's rows are contiguous and, at decode, few, so a row's
// latency is the call's: one round at a time, each scale stored from its
// group's first lane without the two barriers of staging, and an all-zero
// block stored without dividing (its quotients are its values, 0 / 1 sign
// and all, and a zero dividend takes the division's slow path, a call whose
// latency a call of few rows pays in full). On an H100 that walk was faster
// at [16, 6144] and no slower at [4096, 6144]; the zero test slows B1's
// walk at its HT shapes.

// B1: a row's source is its slot's index in the map; an index outside
// [0, T) is a sentinel slot, whose row is zeros with scales of 1.0, as
// quantizing a zero row would give.
struct MapRows {
  using Index = int;
  static constexpr int kRounds = 4;
  static constexpr bool kStaged = true;
  static constexpr bool kZeroSkip = false;
  const int* gmap;
  int T;
  __device__ Index at(int64_t r) const { return __ldg(gmap + r); }
  __device__ Index none() const { return T; }
  __device__ bool live(Index s) const { return s >= 0 && s < T; }
};

// B5: row r is row r of x; no index load, no sentinel.
struct SameRows {
  using Index = int64_t;
  static constexpr int kRounds = 1;
  static constexpr bool kStaged = false;
  static constexpr bool kZeroSkip = true;
  __device__ Index at(int64_t r) const { return r; }
  __device__ Index none() const { return 0; }
  __device__ bool live(Index) const { return true; }
};

// qb = LANES * 8 * CHUNKS: a group of LANES lanes holds one block in
// registers. The grid strides over the rows; a block's warps stride over the
// row's blocks, 32 / LANES blocks a warp at a time, so every lane joins every
// shuffle.
template <int LANES, int CHUNKS, class Src>
__global__ void __launch_bounds__(QUANT_THREADS) quant_lanes_kernel(
    const void* __restrict__ x, Src from, __nv_fp8_storage_t* __restrict__ q,
    float* __restrict__ scales, int64_t rows, int64_t H, int xdt) {
  constexpr int QB = LANES * 8 * CHUNKS;
  constexpr int GPW = 32 / LANES;               // blocks per warp at a time
  constexpr int STRIDE = QUANT_WARPS * GPW;      // blocks per round of the whole block
  constexpr int BATCH = CHUNKS >= Src::kRounds ? 1 : Src::kRounds / CHUNKS;
  __shared__ __align__(16) float ssc[Src::kStaged ? SCALE_SMEM : 4];
  const int64_t nblk = H / QB;
  const bool staged = Src::kStaged && nblk <= SCALE_SMEM;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int glane = lane % LANES, grp = lane / LANES;
  const int64_t esize = dtype_size(xdt);
  int64_t r = blockIdx.x;
  typename Src::Index src = r < rows ? from.at(r) : from.none();
  for (; r < rows; r += gridDim.x) {
    const int64_t rn = r + gridDim.x;
    const typename Src::Index nsrc = rn < rows ? from.at(rn) : from.none();   // ahead
    __nv_fp8_storage_t* qrow = q + r * H;
    float* srow = scales + r * nblk;
    if (!from.live(src)) {
      if (H % 16 == 0) {
        for (int64_t i = threadIdx.x; i < H / 16; i += QUANT_THREADS)
          reinterpret_cast<uint4*>(qrow)[i] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int64_t i = threadIdx.x; i < H / 8; i += QUANT_THREADS)
          reinterpret_cast<uint2*>(qrow)[i] = make_uint2(0u, 0u);
      }
      if (staged)
        for (int64_t i = threadIdx.x; i < nblk; i += QUANT_THREADS) ssc[i] = 1.f;
      else
        for (int64_t i = threadIdx.x; i < nblk; i += QUANT_THREADS) srow[i] = 1.f;
    } else {
      const char* xrow = static_cast<const char*>(x) + static_cast<int64_t>(src) * H * esize;
      // BATCH rounds of a warp's blocks at a time: every load of the batch
      // is issued before the first reduction
      for (int64_t b0 = static_cast<int64_t>(warp) * GPW; b0 < nblk; b0 += STRIDE * BATCH) {
        float v[BATCH][CHUNKS][8];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
          const int64_t blk = b0 + k * STRIDE + grp;
#pragma unroll
          for (int c = 0; c < CHUNKS; ++c) {
            if (blk < nblk) {
              load8(xrow, blk * QB + (c * LANES + glane) * 8, xdt, v[k][c]);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) v[k][c][e] = 0.f;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
          const int64_t blk = b0 + k * STRIDE + grp;
          float amax = 0.f;
#pragma unroll
          for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
            for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[k][c][e]));
#pragma unroll
          for (int off = LANES / 2; off > 0; off /= 2)
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
          const float scale = amax > 0.f ? amax / 448.f : 1.f;
          if (blk < nblk) {
            if (!Src::kZeroSkip || amax > 0.f) {
#pragma unroll
              for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
                for (int e = 0; e < 8; ++e) v[k][c][e] = v[k][c][e] / scale;
            }
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
              uint2 u;
              __nv_fp8_storage_t* bytes = reinterpret_cast<__nv_fp8_storage_t*>(&u);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                bytes[e] = __nv_cvt_float_to_fp8(v[k][c][e], __NV_SATFINITE, __NV_E4M3);
              *reinterpret_cast<uint2*>(qrow + blk * QB + (c * LANES + glane) * 8) = u;
            }
            if (glane == 0) {
              if (staged) ssc[blk] = scale;
              else srow[blk] = scale;
            }
          }
        }
      }
    }
    if (staged) {
      __syncthreads();                          // the row's scales are in ssc
      if (nblk % 4 == 0) {
        for (int64_t i = threadIdx.x; i < nblk / 4; i += QUANT_THREADS)
          reinterpret_cast<float4*>(srow)[i] = reinterpret_cast<const float4*>(ssc)[i];
      } else {
        for (int64_t i = threadIdx.x; i < nblk; i += QUANT_THREADS) srow[i] = ssc[i];
      }
      __syncthreads();                          // ssc is free for the next row
    }
    src = nsrc;
  }
}

// Any other quant block, or a source off 16-byte alignment (vec false): one
// block per row, one warp per quant block.
template <class Src>
__global__ void quant_warp_kernel(const void* __restrict__ x, Src from,
                                  __nv_fp8_storage_t* __restrict__ q,
                                  float* __restrict__ scales, int64_t H, int qb, int xdt,
                                  bool vec) {
  const int64_t r = blockIdx.x;
  const typename Src::Index src = from.at(r);
  const int64_t nblk = H / qb;
  __nv_fp8_storage_t* qrow = q + r * H;
  float* srow = scales + r * nblk;
  if (!from.live(src)) {
    for (int64_t i = threadIdx.x; i < H / 8; i += blockDim.x)
      reinterpret_cast<uint2*>(qrow)[i] = make_uint2(0u, 0u);
    for (int64_t i = threadIdx.x; i < nblk; i += blockDim.x) srow[i] = 1.f;
    return;
  }
  const void* xrow =
      static_cast<const char*>(x) + static_cast<int64_t>(src) * H * dtype_size(xdt);
  const int nwarps = blockDim.x / 32;
  for (int64_t b = threadIdx.x / 32; b < nblk; b += nwarps) {
    const float scale = quant_block_warp(xrow, b * qb, qb, xdt, qrow, vec);
    if (threadIdx.x % 32 == 0) srow[b] = scale;
  }
}

int sm_count(int* n) {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *n = sms[dev];
  return 0;
}

template <int LANES, int CHUNKS, class Src>
int launch_lanes(const void* x, Src from, void* q, void* scales, int64_t rows, int64_t H,
                 int xdt, cudaStream_t st) {
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const int64_t most = static_cast<int64_t>(sms) * (2048 / QUANT_THREADS);
  const int grid = static_cast<int>(rows < most ? rows : most);
  quant_lanes_kernel<LANES, CHUNKS, Src><<<grid, QUANT_THREADS, 0, st>>>(
      x, from, static_cast<__nv_fp8_storage_t*>(q), static_cast<float*>(scales), rows, H, xdt);
  return static_cast<int>(cudaGetLastError());
}

// Quantize `rows` rows of H elements (H % 8 == 0, qb dividing H) into q and
// scales [rows, H / qb]. `vec`: qb % 8 == 0 and 16-byte aligned rows of x.
template <class Src>
int quantize_rows(const void* x, Src from, void* q, void* scales, int64_t rows, int64_t H,
                  int qb, int xdt, bool vec, cudaStream_t st) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (vec) {
    switch (qb) {
      case 8: return launch_lanes<1, 1>(x, from, q, scales, rows, H, xdt, st);
      case 16: return launch_lanes<2, 1>(x, from, q, scales, rows, H, xdt, st);
      case 32: return launch_lanes<4, 1>(x, from, q, scales, rows, H, xdt, st);
      case 64: return launch_lanes<8, 1>(x, from, q, scales, rows, H, xdt, st);
      case 128: return launch_lanes<16, 1>(x, from, q, scales, rows, H, xdt, st);
      case 256: return launch_lanes<32, 1>(x, from, q, scales, rows, H, xdt, st);
      case 512: return launch_lanes<32, 2>(x, from, q, scales, rows, H, xdt, st);
      case 1024: return launch_lanes<32, 4>(x, from, q, scales, rows, H, xdt, st);
      default: break;
    }
  }
  quant_warp_kernel<Src><<<static_cast<unsigned>(rows), 128, 0, st>>>(
      x, from, static_cast<__nv_fp8_storage_t*>(q), static_cast<float*>(scales), H, qb, xdt,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
