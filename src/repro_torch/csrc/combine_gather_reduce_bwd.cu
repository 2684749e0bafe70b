// combine_gather_reduce_bwd: the backward of combine_gather_reduce,
// out[t] = sum_k w[t, k] * recv[rows[t, k]]. For the cotangent dout [T, H]:
//   d_recv[rows[t, k]] = w[t, k] * dout[t]           (rounded to recv's type)
//   d_w[t, k] = sum_h recv[rows[t, k], h] * dout[t, h]   (f32)
// and d_w = 0 where rows[t, k] is the sentinel. The TPU kernel
// (src/repro/kernels/combine_gather_reduce.py:44) has no backward of its
// own: the reference's AD scatter-adds through the gather. The rows of the
// EP combine (HT flat, LL nccl_ep) name each received row at most once, so
// the scatter is a plain store and needs no atomics; rows no (t, k) names
// are left as the caller initialised them (zeros).
//
// One block of 128 threads per token. A thread owns 16-byte pieces of the
// token's row (8 bf16 or f16 values, 4 f32... read as 8 through load8):
// for each piece it loads dout once, then the piece of each of the K rows,
// adds its products to K running f32 sums and stores w * dout into each
// row. The K sums are reduced over the block in a fixed order (warp
// shuffles, then the four warps in order), so two calls give the same bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 128, MAX_K = 8;

__global__ void __launch_bounds__(THREADS)
cgr_bwd_kernel(const void* __restrict__ recv, const int* __restrict__ rows,
               const float* __restrict__ w, const void* __restrict__ dout,
               void* __restrict__ d_recv, float* __restrict__ d_w, int R, int64_t H, int K,
               int dt) {
  __shared__ float red[THREADS / 32][MAX_K];
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int row[MAX_K];
  float wt[MAX_K], part[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    row[k] = k < K ? rows[static_cast<int64_t>(t) * K + k] : -1;
    wt[k] = k < K ? w[static_cast<int64_t>(t) * K + k] : 0.f;
    part[k] = 0.f;
  }
  for (int64_t h = static_cast<int64_t>(tid) * 8; h < H; h += THREADS * 8) {
    float d[8];
    load8(dout, static_cast<int64_t>(t) * H + h, dt, d);
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (row[k] < 0 || row[k] >= R) continue;
      float r[8], o[8];
      load8(recv, static_cast<int64_t>(row[k]) * H + h, dt, r);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        part[k] = fmaf(r[e], d[e], part[k]);
        o[e] = wt[k] * d[e];
      }
      store8(d_recv, static_cast<int64_t>(row[k]) * H + h, dt, o);
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    float v = part[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (tid < K) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) v += red[i][tid];
    const bool ok = row[tid] >= 0 && row[tid] < R;
    d_w[static_cast<int64_t>(t) * K + tid] = ok ? v : 0.f;
  }
}

}  // namespace

// recv, d_recv: [R, H]; dout: [T, H], all of dtype dt (F32, BF16 or F16);
// rows: [T, K] int32 with sentinel R; w, d_w: [T, K] f32; K <= 8. The
// wrapper guarantees H % 8 == 0 and 16-byte aligned rows.
extern "C" int ep_combine_gather_reduce_bwd(const void* recv, const void* rows, const void* w,
                                            const void* dout, void* d_recv, void* d_w, int T,
                                            int R, int64_t H, int K, int dt, void* stream) {
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  if (K < 0 || K > MAX_K || (dt != F32 && dt != BF16 && dt != F16))
    return static_cast<int>(cudaErrorInvalidValue);
  cgr_bwd_kernel<<<T, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      recv, static_cast<const int*>(rows), static_cast<const float*>(w), dout, d_recv,
      static_cast<float*>(d_w), R, H, K, dt);
  return static_cast<int>(cudaGetLastError());
}
