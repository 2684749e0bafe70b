// combine_reduce: out[t] = sum_k w[t, k] * y[t, k], summed in f32 and cast
// once, over the gathered [T, K, H] responses.
//
// Replaces src/repro/kernels/combine_reduce.py:32 combine_reduce (the Pallas
// kernel over (token-block, hidden-block) tiles holding all K responses).
// Bound by bytes: each response element is read once and each output
// element written once. One block owns one (token, 1024-wide H tile); each
// thread keeps eight f32 sums in registers over k = 0..K-1 in that fixed
// order, the order of combine_gather_reduce.cu, so the sum has one order on
// every run.
#include "common.cuh"

__global__ void combine_reduce_kernel(const void* __restrict__ y,
                                      const void* __restrict__ w,
                                      void* __restrict__ out, int64_t H, int K,
                                      int ydt, int wdt, int odt) {
  const int64_t t = blockIdx.x;
  const int64_t h = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * 8;
  if (h >= H) return;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  const int64_t rsz = H * dtype_size(ydt);
  for (int k = 0; k < K; ++k) {
    const float wk = load_elem(w, t * K + k, wdt);
    float v[8];
    load8(static_cast<const char*>(y) + (t * K + k) * rsz, h, ydt, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += wk * v[j];
  }
  store8(static_cast<char*>(out) + t * H * dtype_size(odt), h, odt, acc);
}

extern "C" int ep_combine_reduce(const void* y, const void* w, void* out, int T,
                                 int64_t H, int K, int ydt, int wdt, int odt,
                                 void* stream) {
  const int threads = 128;
  const int64_t tiles = (H / 8 + threads - 1) / threads;
  if (T > 0 && tiles > 0) {
    dim3 grid(T, static_cast<unsigned>(tiles));
    combine_reduce_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        y, w, out, H, K, ydt, wdt, odt);
  }
  return static_cast<int>(cudaGetLastError());
}
