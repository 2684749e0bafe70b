// dispatch_pack: gather token rows through the [N, C] slot map into the send
// buffer, optionally quantizing each row to block-wise fp8 e4m3.
//
// Replaces src/repro/kernels/dispatch_pack.py:42 dispatch_pack (the Pallas
// copy and quant kernels). The work is a row gather, so it is bound by
// bytes: each live slot reads one token row and writes one packed row. One
// block per slot row loads its slot index once, then moves the row with
// 16-byte loads (copy mode) or quantizes each quant block with one warp
// (quant mode: common.cuh quant_block_warp, which fp8.cu's quantize_fp8
// calls too). A sentinel slot (index outside [0, T)) writes a zero row, and
// in quant mode a scale of 1.0, as quantizing a zero row would.
#include "common.cuh"

__global__ void dispatch_pack_copy_kernel(const void* __restrict__ x,
                                          const int* __restrict__ gmap,
                                          void* __restrict__ out, int T,
                                          int64_t H, int xdt, int odt,
                                          bool vec) {
  const int64_t r = blockIdx.x;
  const int src = gmap[r];
  const void* row = (src >= 0 && src < T)
      ? static_cast<const char*>(x) + static_cast<int64_t>(src) * H * dtype_size(xdt)
      : nullptr;
  copy_row(row, xdt, static_cast<char*>(out) + r * H * dtype_size(odt), odt,
           H, vec);
}

__global__ void dispatch_pack_quant_kernel(const void* __restrict__ x,
                                           const int* __restrict__ gmap,
                                           __nv_fp8_storage_t* __restrict__ q,
                                           float* __restrict__ scales, int T,
                                           int64_t H, int qb, int xdt) {
  const int64_t r = blockIdx.x;
  const int src = gmap[r];
  const int64_t nblk = H / qb;
  __nv_fp8_storage_t* qrow = q + r * H;
  float* srow = scales + r * nblk;
  if (src < 0 || src >= T) {
    for (int64_t i = threadIdx.x; i < H; i += blockDim.x) qrow[i] = 0;
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

extern "C" int ep_dispatch_pack_copy(const void* x, const void* gmap, void* out,
                                     int64_t rows, int T, int64_t H, int xdt,
                                     int odt, int vec, void* stream) {
  if (rows > 0)
    dispatch_pack_copy_kernel<<<rows, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const int*>(gmap), out, T, H, xdt, odt, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ep_dispatch_pack_quant(const void* x, const void* gmap, void* q,
                                      void* scales, int64_t rows, int T,
                                      int64_t H, int qb, int xdt, void* stream) {
  if (rows > 0)
    dispatch_pack_quant_kernel<<<rows, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const int*>(gmap), static_cast<__nv_fp8_storage_t*>(q),
        static_cast<float*>(scales), T, H, qb, xdt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
