// combine_gather_reduce: out[t] = sum_k w[t, k] * recv[rows[t, k]], summed in
// f32 and cast once, without building the [T, K, H] gathered tensor.
//
// Replaces src/repro/kernels/combine_gather_reduce.py:44 combine_gather_reduce
// (the Pallas kernel that revisits one VMEM tile over a sequential k grid
// axis). Bound by bytes: K row reads and one row write per token. Here one
// block owns one (token, H-tile); each thread keeps eight f32 sums in
// registers and walks k = 0..K-1 in that fixed order, so the sum has one
// order on every run. A sentinel row (outside [0, R)) adds nothing.
#include "common.cuh"

__global__ void combine_gather_reduce_kernel(const void* __restrict__ recv,
                                             const int* __restrict__ rows,
                                             const float* __restrict__ w,
                                             void* __restrict__ out, int R,
                                             int64_t H, int K, int rdt, int odt) {
  const int64_t t = blockIdx.x;
  const int64_t h = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * 8;
  if (h >= H) return;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  const int64_t rsz = H * dtype_size(rdt);
  for (int k = 0; k < K; ++k) {
    const int row = rows[t * K + k];
    if (row < 0 || row >= R) continue;
    const float wk = w[t * K + k];
    float v[8];
    load8(static_cast<const char*>(recv) + static_cast<int64_t>(row) * rsz, h, rdt, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += wk * v[j];
  }
  store8(static_cast<char*>(out) + t * H * dtype_size(odt), h, odt, acc);
}

extern "C" int ep_combine_gather_reduce(const void* recv, const void* rows,
                                        const void* w, void* out, int T, int R,
                                        int64_t H, int K, int rdt, int odt,
                                        void* stream) {
  const int threads = 128;
  const int64_t tiles = (H / 8 + threads - 1) / threads;
  if (T > 0 && tiles > 0) {
    dim3 grid(T, static_cast<unsigned>(tiles));
    combine_gather_reduce_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        recv, static_cast<const int*>(rows), static_cast<const float*>(w), out, R,
        H, K, rdt, odt);
  }
  return static_cast<int>(cudaGetLastError());
}
