// fp8: standalone block-wise fp8 e4m3 quantize and dequantize over [M, H].
//
// Replaces src/repro/kernels/fp8.py:50 quantize_fp8 and :76 dequantize_fp8
// (the Pallas kernels over (row-block, hidden-block) tiles). Both are bound
// by bytes: quantize reads each element once and writes one byte per element
// plus one f32 scale per block; dequantize reads the byte and its block's
// scale and writes one element.
//
// quantize runs the quantizer dispatch_pack's quant mode runs (quant.cuh
// quantize_rows) with row r its own source (SameRows: no index load, no
// sentinel), so the two agree bit for bit (chip_smoke.py and the card tests
// hold them to it). What that does about each cost of the first kernel (one
// warp per (row, quant block), 2.3x to 7.7x its bound on an H100 at DBRX's
// HT widths): a block of qb = 8 * 2^k (k <= 7) elements belongs to a group
// of min(qb / 8, 32) lanes, so no lane idles where a warp's 32 lanes shared
// one block of 128 (half of them idle) or 64 (three quarters idle); the
// group holds the block in registers, so it is read once for both the amax
// and the rounding, not twice; up to four of a warp's blocks are loaded
// before the first is reduced, on a persistent grid of up to 8 blocks an
// SM. Other block widths and a source off 16-byte alignment keep one warp
// per block (common.cuh quant_block_warp). Either way one true division
// (never a multiply by 1/scale) and one rounding per element, bit-equal to
// the plain version.
//
// dequantize gives each thread eight consecutive elements of one block (one
// 8-byte load), reads that block's scale once, multiplies in f32 and rounds
// once to the output type, as the plain version does. Without 8-aligned
// blocks it falls back to one element at a time.
#include "quant.cuh"

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
  return quantize_rows(x, SameRows{}, q, scales, M, H, qb, xdt, vec != 0,
                       static_cast<cudaStream_t>(stream));
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
