// recv_unpack: gather received rows through a slot map of any shape, with an
// optional fused fp8 dequantization (payload times its block scale in f32).
//
// Replaces src/repro/kernels/recv_unpack.py:43 recv_unpack (the Pallas copy
// and dequant kernels). Bound by bytes: each output row reads one received
// row (plus its scale row) and writes one row. One block per output row loads
// its slot index once; rows whose width is a multiple of 8 move with 16-byte
// loads, any other width (the f32 scale rows H/block wide) element by
// element. A sentinel slot (index outside [0, R)) writes an exact zero row.
#include "common.cuh"

__global__ void recv_unpack_copy_kernel(const void* __restrict__ recv,
                                        const int* __restrict__ gmap,
                                        void* __restrict__ out, int R,
                                        int64_t H, int rdt, int odt, bool vec) {
  const int64_t i = blockIdx.x;
  const int src = gmap[i];
  const void* row = (src >= 0 && src < R)
      ? static_cast<const char*>(recv) + static_cast<int64_t>(src) * H * dtype_size(rdt)
      : nullptr;
  copy_row(row, rdt, static_cast<char*>(out) + i * H * dtype_size(odt), odt,
           H, vec);
}

__global__ void recv_unpack_dequant_kernel(
    const __nv_fp8_storage_t* __restrict__ recv, const float* __restrict__ scales,
    const int* __restrict__ gmap, void* __restrict__ out, int R, int64_t H,
    int blk, int odt, bool vec) {
  const int64_t i = blockIdx.x;
  const int src = gmap[i];
  const int64_t nblk = H / blk;
  void* orow = static_cast<char*>(out) + i * H * dtype_size(odt);
  if (src < 0 || src >= R) {
    copy_row(nullptr, odt, orow, odt, H, vec);
    return;
  }
  const __nv_fp8_storage_t* qrow = recv + static_cast<int64_t>(src) * H;
  const float* srow = scales + static_cast<int64_t>(src) * nblk;
  if (vec) {
    // blk % 8 == 0, so the eight elements share one scale
    for (int64_t h = threadIdx.x * 8; h < H; h += blockDim.x * 8) {
      const float s = srow[h / blk];
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = load_elem(qrow, h + j, FP8E4M3) * s;
      store8(orow, h, odt, v);
    }
  } else {
    for (int64_t h = threadIdx.x; h < H; h += blockDim.x)
      store_elem(orow, h, odt, load_elem(qrow, h, FP8E4M3) * srow[h / blk]);
  }
}

extern "C" int ep_recv_unpack_copy(const void* recv, const void* gmap, void* out,
                                   int64_t rows, int R, int64_t H, int rdt,
                                   int odt, int vec, void* stream) {
  if (rows > 0)
    recv_unpack_copy_kernel<<<rows, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        recv, static_cast<const int*>(gmap), out, R, H, rdt, odt, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ep_recv_unpack_dequant(const void* recv, const void* scales,
                                      const void* gmap, void* out, int64_t rows,
                                      int R, int64_t H, int blk, int odt, int vec,
                                      void* stream) {
  if (rows > 0)
    recv_unpack_dequant_kernel<<<rows, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_fp8_storage_t*>(recv),
        static_cast<const float*>(scales), static_cast<const int*>(gmap), out, R,
        H, blk, odt, vec != 0);
  return static_cast<int>(cudaGetLastError());
}
