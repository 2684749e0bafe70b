// fp8: standalone block-wise fp8 e4m3 quantize and dequantize over [M, H].
//
// Replaces src/repro/kernels/fp8.py:50 quantize_fp8 and :76 dequantize_fp8
// (the Pallas kernels over (row-block, hidden-block) tiles). Both are bound
// by bytes: quantize reads each element once and writes one byte per element
// plus one f32 scale per block; dequantize reads the byte and its block's
// scale and writes one element. quantize runs one warp per (row, quant
// block) through common.cuh quant_block_warp: the same max, one division and
// one rounding per element as dispatch_pack's quant mode, so the two agree bit
// for bit (chip_smoke.py and the card tests hold them to it). dequantize
// gives each thread eight consecutive elements of one block (one 8-byte
// load), reads that block's scale once, multiplies in f32 and rounds once to
// the output type, as the plain version does. Without 8-aligned blocks both
// fall back to one element at a time.
#include "common.cuh"

__global__ void quantize_fp8_kernel(const void* __restrict__ x,
                                    __nv_fp8_storage_t* __restrict__ q,
                                    float* __restrict__ scales, int64_t M,
                                    int64_t H, int qb, int xdt, bool vec) {
  const int64_t nblk = H / qb;
  // warp-uniform: a warp leaves whole, so the shuffles see all 32 lanes
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (w >= M * nblk) return;
  const int64_t row = w / nblk, b = w % nblk;
  const float scale = quant_block_warp(
      static_cast<const char*>(x) + row * H * dtype_size(xdt), b * qb, qb, xdt,
      q + row * H, vec);
  if (threadIdx.x % 32 == 0) scales[w] = scale;
}

__global__ void dequantize_fp8_kernel(const __nv_fp8_storage_t* __restrict__ q,
                                      const float* __restrict__ scales,
                                      void* __restrict__ out, int64_t n,
                                      int64_t H, int blk, int odt, bool vec) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) *
                    (vec ? 8 : 1);
  if (i >= n) return;
  const int64_t row = i / H, h = i % H;
  const float s = scales[row * (H / blk) + h / blk];
  if (vec) {
    // blk % 8 == 0 and H % 8 == 0: the eight elements share one scale
    const uint2 u = *reinterpret_cast<const uint2*>(q + i);
    const __nv_fp8_storage_t* b = reinterpret_cast<const __nv_fp8_storage_t*>(&u);
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = load_elem(b, k, FP8E4M3) * s;
    store8(out, i, odt, v);
  } else {
    store_elem(out, i, odt, load_elem(q, i, FP8E4M3) * s);
  }
}

extern "C" int ep_quantize_fp8(const void* x, void* q, void* scales, int64_t M,
                               int64_t H, int qb, int xdt, int vec, void* stream) {
  const int threads = 128;
  const int64_t warps = M * (H / qb);
  if (warps > 0)
    quantize_fp8_kernel<<<(warps + threads / 32 - 1) / (threads / 32), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<__nv_fp8_storage_t*>(q), static_cast<float*>(scales), M, H,
        qb, xdt, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ep_dequantize_fp8(const void* q, const void* scales, void* out,
                                 int64_t M, int64_t H, int blk, int odt, int vec,
                                 void* stream) {
  const int threads = 256;
  const int64_t n = M * H;
  const int64_t work = vec ? n / 8 : n;
  if (work > 0)
    dequantize_fp8_kernel<<<(work + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_fp8_storage_t*>(q), static_cast<const float*>(scales),
        out, n, H, blk, odt, vec != 0);
  return static_cast<int>(cudaGetLastError());
}
