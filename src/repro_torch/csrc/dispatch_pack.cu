// dispatch_pack: gather token rows through the [N, C] slot map into the send
// buffer, optionally quantizing each row to block-wise fp8 e4m3.
//
// Replaces src/repro/kernels/dispatch_pack.py:42 dispatch_pack (the Pallas
// copy and quant kernels). The work is a row gather, so it is bound by bytes:
// each live slot reads one token row and writes one packed row. What the
// design does about each cost of a first, simpler kernel (one block per slot
// row, 2.4x to 3.5x its bound on an H100):
//
// - Copy mode (the decode dispatch and combine sends, the HT combine send).
//   A grid over (slot row, chunk of 768 16-byte pieces, a whole row of
//   DBRX's 6144 bf16): each thread reads its row's slot index, issues all six
//   of its 16-byte loads, then the six stores, so a decode call ([8, 16]
//   slots of 12 KB) has every load in flight in the first wave instead of
//   six dependent load/store pairs per thread. A sentinel slot (index outside [0, T))
//   stores zeros without a load. A dtype change goes through f32 with
//   round-to-nearest-even, eight elements a thread-step (common.cuh load8 /
//   store8), as before.
// - Quant mode (the HT and deepep dispatch sends). A persistent grid walks the
//   slot rows, reading the next row's slot index ahead. A quant block of qb =
//   8 * 2^k elements (k <= 7; 128 on the path) belongs to a group of
//   min(qb / 8, 32) lanes that hold all of it in registers (8 values a lane
//   per 16-byte load, so at qb = 128 a warp quantizes two blocks and no lane
//   idles; up to four of a warp's blocks loaded before the first is
//   reduced): one read for both the amax and the rounding, scale = amax / 448
//   by true division (1 for an all-zero block), each value divided by the
//   scale and rounded to e4m3 with satfinite, 8 bytes stored a lane. A row's
//   scales are gathered in shared memory and stored 16 bytes at a time. A
//   sentinel slot writes its zero row with 16-byte stores (8-byte where H is
//   not a multiple of 16) and scales of 1.0, as quantizing a zero row would.
//   Any other block width keeps the one-warp-per-block helper that fp8.cu's
//   quantize_fp8 calls (common.cuh quant_block_warp). Both compute the same
//   function, exactly: a max, one division and one rounding per element.
#include "common.cuh"

namespace {

constexpr int COPY_THREADS = 128;
constexpr int COPY_UNROLL = 6;        // pieces per thread, all loaded before any store
constexpr int COPY_CHUNK = COPY_THREADS * COPY_UNROLL;
constexpr int QUANT_THREADS = 256;
constexpr int QUANT_WARPS = QUANT_THREADS / 32;
constexpr int SCALE_SMEM = 4096;      // floats of a row's scales staged in shared memory
constexpr int MAX_DEVICES = 64;

// Same dtype: a row is `pieces` 16-byte pieces, moved raw (exact).
__global__ void __launch_bounds__(COPY_THREADS) pack_copy_kernel(
    const uint4* __restrict__ x, const int* __restrict__ gmap, uint4* __restrict__ out,
    int T, int64_t pieces) {
  const int64_t r = blockIdx.x;
  const int src = __ldg(gmap + r);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * COPY_CHUNK + threadIdx.x;
  uint4* orow = out + r * pieces;
  uint4 v[COPY_UNROLL];
  if (src >= 0 && src < T) {
    const uint4* xrow = x + static_cast<int64_t>(src) * pieces;
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const int64_t i = base + u * COPY_THREADS;
      if (i < pieces) v[u] = __ldg(xrow + i);
    }
  } else {
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) v[u] = make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < COPY_UNROLL; ++u) {
    const int64_t i = base + u * COPY_THREADS;
    if (i < pieces) orow[i] = v[u];
  }
}

// A dtype change: `units` groups of 8 elements a row, each through f32.
__global__ void __launch_bounds__(COPY_THREADS) pack_convert_kernel(
    const void* __restrict__ x, const int* __restrict__ gmap, void* __restrict__ out, int T,
    int64_t H, int xdt, int odt) {
  const int64_t r = blockIdx.x;
  const int src = __ldg(gmap + r);
  const int64_t units = H / 8;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * COPY_CHUNK + threadIdx.x;
  const bool live = src >= 0 && src < T;
  const char* xrow = static_cast<const char*>(x) + static_cast<int64_t>(live ? src : 0) * H *
                                                       dtype_size(xdt);
  char* orow = static_cast<char*>(out) + r * H * dtype_size(odt);
  float v[COPY_UNROLL][8];
#pragma unroll
  for (int u = 0; u < COPY_UNROLL; ++u) {
    const int64_t i = base + u * COPY_THREADS;
    if (live && i < units) {
      load8(xrow, i * 8, xdt, v[u]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[u][k] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < COPY_UNROLL; ++u) {
    const int64_t i = base + u * COPY_THREADS;
    if (i < units) store8(orow, i * 8, odt, v[u]);
  }
}

// Quant mode, qb = LANES * 8 * CHUNKS: a group of LANES lanes holds one
// block in registers. The grid strides over the slot rows; a block's warps
// stride over the row's blocks, 32 / LANES blocks a warp at a time, so every
// lane joins every shuffle.
template <int LANES, int CHUNKS>
__global__ void __launch_bounds__(QUANT_THREADS) pack_quant_kernel(
    const void* __restrict__ x, const int* __restrict__ gmap,
    __nv_fp8_storage_t* __restrict__ q, float* __restrict__ scales, int64_t rows, int T,
    int64_t H, int xdt) {
  constexpr int QB = LANES * 8 * CHUNKS;
  constexpr int GPW = 32 / LANES;               // blocks per warp at a time
  constexpr int STRIDE = QUANT_WARPS * GPW;      // blocks per round of the whole block
  constexpr int BATCH = CHUNKS >= 4 ? 1 : 4 / CHUNKS;
  __shared__ __align__(16) float ssc[SCALE_SMEM];
  const int64_t nblk = H / QB;
  const bool staged = nblk <= SCALE_SMEM;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int glane = lane % LANES, grp = lane / LANES;
  const int64_t esize = dtype_size(xdt);
  int64_t r = blockIdx.x;
  int src = r < rows ? __ldg(gmap + r) : T;
  for (; r < rows; r += gridDim.x) {
    const int64_t rn = r + gridDim.x;
    const int nsrc = rn < rows ? __ldg(gmap + rn) : T;   // the next row's index, ahead
    __nv_fp8_storage_t* qrow = q + r * H;
    float* srow = scales + r * nblk;
    if (src < 0 || src >= T) {
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
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
              uint2 u;
              __nv_fp8_storage_t* bytes = reinterpret_cast<__nv_fp8_storage_t*>(&u);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                bytes[e] = __nv_cvt_float_to_fp8(v[k][c][e] / scale, __NV_SATFINITE, __NV_E4M3);
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

// Any other quant block: one block per slot row, one warp per quant block
// through the helper quantize_fp8 shares.
__global__ void pack_quant_warp_kernel(const void* __restrict__ x, const int* __restrict__ gmap,
                                       __nv_fp8_storage_t* __restrict__ q,
                                       float* __restrict__ scales, int T, int64_t H, int qb,
                                       int xdt) {
  const int64_t r = blockIdx.x;
  const int src = gmap[r];
  const int64_t nblk = H / qb;
  __nv_fp8_storage_t* qrow = q + r * H;
  float* srow = scales + r * nblk;
  if (src < 0 || src >= T) {
    for (int64_t i = threadIdx.x; i < H / 8; i += blockDim.x)
      reinterpret_cast<uint2*>(qrow)[i] = make_uint2(0u, 0u);
    for (int64_t i = threadIdx.x; i < nblk; i += blockDim.x) srow[i] = 1.f;
    return;
  }
  const void* xrow =
      static_cast<const char*>(x) + static_cast<int64_t>(src) * H * dtype_size(xdt);
  // the wrapper guarantees 16-byte aligned token rows and H % 8 == 0
  const bool vec = qb % 8 == 0;
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

template <int LANES, int CHUNKS>
int launch_quant(const void* x, const int* gmap, void* q, void* scales, int64_t rows, int T,
                 int64_t H, int xdt, cudaStream_t st) {
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const int64_t most = static_cast<int64_t>(sms) * (2048 / QUANT_THREADS);
  const int grid = static_cast<int>(rows < most ? rows : most);
  pack_quant_kernel<LANES, CHUNKS><<<grid, QUANT_THREADS, 0, st>>>(
      x, gmap, static_cast<__nv_fp8_storage_t*>(q), static_cast<float*>(scales), rows, T, H,
      xdt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ep_dispatch_pack_copy(const void* x, const void* gmap, void* out,
                                     int64_t rows, int T, int64_t H, int xdt, int odt,
                                     void* stream) {
  if (rows <= 0 || H <= 0 || H % 8) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gmap);
  if (xdt == odt) {
    const int64_t pieces = H * dtype_size(xdt) / 16;
    dim3 grid(static_cast<unsigned>(rows),
              static_cast<unsigned>((pieces + COPY_CHUNK - 1) / COPY_CHUNK));
    pack_copy_kernel<<<grid, COPY_THREADS, 0, st>>>(static_cast<const uint4*>(x), g,
                                                   static_cast<uint4*>(out), T, pieces);
  } else {
    dim3 grid(static_cast<unsigned>(rows),
              static_cast<unsigned>((H / 8 + COPY_CHUNK - 1) / COPY_CHUNK));
    pack_convert_kernel<<<grid, COPY_THREADS, 0, st>>>(x, g, out, T, H, xdt, odt);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ep_dispatch_pack_quant(const void* x, const void* gmap, void* q,
                                      void* scales, int64_t rows, int T,
                                      int64_t H, int qb, int xdt, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gmap);
  switch (qb) {
    case 8: return launch_quant<1, 1>(x, g, q, scales, rows, T, H, xdt, st);
    case 16: return launch_quant<2, 1>(x, g, q, scales, rows, T, H, xdt, st);
    case 32: return launch_quant<4, 1>(x, g, q, scales, rows, T, H, xdt, st);
    case 64: return launch_quant<8, 1>(x, g, q, scales, rows, T, H, xdt, st);
    case 128: return launch_quant<16, 1>(x, g, q, scales, rows, T, H, xdt, st);
    case 256: return launch_quant<32, 1>(x, g, q, scales, rows, T, H, xdt, st);
    case 512: return launch_quant<32, 2>(x, g, q, scales, rows, T, H, xdt, st);
    case 1024: return launch_quant<32, 4>(x, g, q, scales, rows, T, H, xdt, st);
    default:
      pack_quant_warp_kernel<<<rows, 128, 0, st>>>(
          x, g, static_cast<__nv_fp8_storage_t*>(q), static_cast<float*>(scales), T, H, qb,
          xdt);
      return static_cast<int>(cudaGetLastError());
  }
}

extern "C" const char* ep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
